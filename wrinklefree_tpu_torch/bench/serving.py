"""Continuous-batching serving benchmark — engine-level, no HTTP (PyTorch port).

The port of ``scripts/serving_bench.py``: the same flags, defaults, prompts
(``np.random.default_rng(0)``), warmup passes, radix reset and JSON report,
on the port's ``Engine`` (random ternary weights drawn from seed 0). Adds
``--device`` (CUDA unless the caller asks for the CPU) and a ``device``
field with the card's name and power limit. ``in_window_compiles`` counts
what the port builds inside the measured window: kernel builds
(``ops/cuda_lib.py``) and new program variants (the engine's decode bursts
and prefill buckets); ``in_window_compile_s`` is the builds' seconds.

Usage:
  python -m wrinklefree_tpu_torch.bench.serving --streams 64 --prompt-len 128 --new-tokens 64
  python -m wrinklefree_tpu_torch.bench.serving --streams 8 --prompt-len 3968 --new-tokens 16
  python -m wrinklefree_tpu_torch.bench.serving --spec 4 --repetitive 16
  python -m wrinklefree_tpu_torch.bench.serving --tiny --device cpu --streams 8 --slots 4

``--spec K`` serves with n-gram speculative decoding (``speculative_k``);
``--repetitive P`` loops a P-token pattern in every prompt, the traffic the
drafts predict. ``--use-pallas 0`` and ``--prefill-linear xla`` raise
``NotImplementedError``: the kernels' plain versions are not a serving path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import BitNetConfig, EngineConfig
from ..engine import Engine, SamplingParams
from ..models.bitnet import init_params, resolve_device
from ..ops import cuda_lib
from .metrics import BenchmarkMetrics


def parse_args(argv=None):
    ap = argparse.ArgumentParser("wrinklefree_tpu_torch.bench.serving")
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=4096)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of common prefix across streams (radix test)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--model", default="bitnet2b", choices=["bitnet2b", "llama8b", "moe"],
                    help="moe = 2B geometry with 8 ternary experts/top-2, 8 layers")
    ap.add_argument("--kv-layout", default="auto", choices=["auto", "token", "layer"])
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=["bf16", "fp16", "f32", "int8", "fp8_e4m3", "fp8_e5m2"])
    ap.add_argument("--burst", type=int, default=None)
    ap.add_argument("--use-pallas", default=None, choices=[None, "0", "1"],
                    help="1 (or unset): the hand-written kernels; 0 raises")
    ap.add_argument("--spec", type=int, default=0)
    ap.add_argument("--flash-decode", default=None, choices=[None, "0", "1"],
                    help="in-kernel page-gather decode attention (K6)")
    ap.add_argument("--prefill-mode", default="stagger", choices=["stagger", "bucket", "all"])
    ap.add_argument("--max-prefill-slots", type=int, default=None)
    ap.add_argument("--prefill-linear", default="auto", choices=["auto", "pallas", "xla"])
    ap.add_argument("--exact-head", type=int, default=0, metavar="K")
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--global-tokens", type=int, default=0)
    ap.add_argument("--repetitive", type=int, default=0, metavar="P",
                    help="build prompts by looping a P-token pattern")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def check_supported(args) -> None:
    """Raise for the flags the port does not serve."""
    missing = []
    if args.use_pallas == "0" or args.prefill_linear == "xla":
        missing.append("--use-pallas 0 / --prefill-linear xla (the kernels' plain twins "
                       "are their CPU path and oracle, not a serving path on the card)")
    if missing:
        raise NotImplementedError("not ported to the PyTorch engine: " + "; ".join(missing))


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them (or the
    torch device name off the card)."""
    if dev.type != "cuda":
        return str(dev)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"], capture_output=True, text=True, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(dev)


def compile_state(eng: Engine):
    """(kernel builds + program variants, build seconds) so far."""
    return cuda_lib.BUILDS["count"] + len(eng._programs), cuda_lib.BUILDS["seconds"]


def model_config(args) -> BitNetConfig:
    if args.tiny:
        return BitNetConfig.tiny()
    if args.model == "llama8b":
        return BitNetConfig.llama3_8b_ternary()
    if args.model == "moe":
        # 2B layer geometry, 8 ternary experts, top-2 routing; fewer layers
        # (weights 8x FFN per layer)
        return dataclasses.replace(BitNetConfig.bitnet_2b(), num_layers=8, num_experts=8,
                                   num_experts_per_tok=2)
    return BitNetConfig.bitnet_2b()


def main(argv=None) -> dict:
    args = parse_args(argv)
    check_supported(args)
    dev = resolve_device(args.device)
    cfg = model_config(args)
    max_ctx = min(cfg.max_position, args.prompt_len + args.new_tokens + 64)
    if args.window and args.kv_layout == "auto":
        args.kv_layout = "layer"  # the page-skipping gather needs the dual layout
    ecfg = EngineConfig(
        max_batch_slots=args.slots,
        page_size=args.page_size,
        num_pages=args.num_pages,
        max_context=max_ctx,
        prefill_buckets=tuple(b for b in (128, 512, 1024, 2048, 4096) if b <= max_ctx) or (128,),
        kv_layout=args.kv_layout,
        kv_dtype=args.kv_dtype,
        **({"decode_burst": args.burst} if args.burst else {}),
        **({"flash_decode": args.flash_decode == "1"} if args.flash_decode is not None else {}),
        speculative_k=args.spec,
        exact_head_k=args.exact_head,
        prefill_round_mode=args.prefill_mode,
        max_prefill_slots=args.max_prefill_slots,
        attn_window=args.window,
        attn_global_tokens=args.global_tokens,
    )
    print(f"init {('tiny' if args.tiny else args.model)} model + engine "
          f"(slots={args.slots}, pages={args.num_pages}, device={dev})...", file=sys.stderr)
    eng = Engine(init_params(cfg, seed=0, device=dev), cfg, ecfg, device=dev)

    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(1, cfg.vocab_size, args.shared_prefix)]
    if args.repetitive:
        prompts = []
        for _ in range(args.streams):
            pat = [int(t) for t in rng.integers(1, cfg.vocab_size, args.repetitive)]
            body = (pat * (args.prompt_len // len(pat) + 1))[: args.prompt_len - args.shared_prefix]
            prompts.append(shared + body)
    else:
        prompts = [
            shared + [int(t) for t in rng.integers(
                1, cfg.vocab_size, args.prompt_len - args.shared_prefix)]
            for _ in range(args.streams)
        ]

    # warmup, as the reference script's: one short request, a wave of
    # `slots` disjoint prompts, then the measured scenario's shape (stream
    # count, prompt length, prefix sharing) on disjoint prompts, so every
    # program variant and kernel build lands before the measured window
    print("warmup...", file=sys.stderr)
    eng.generate(prompts[0][: args.prompt_len], SamplingParams(max_new_tokens=2))
    wrng = np.random.default_rng(12345)
    warm = [eng.submit([int(t) for t in wrng.integers(1, cfg.vocab_size, args.prompt_len)],
                       SamplingParams(max_new_tokens=args.new_tokens))
            for _ in range(args.slots)]
    while not all(r.finished for r in warm):
        eng.step()
    wshared = [int(t) for t in wrng.integers(1, cfg.vocab_size, args.shared_prefix)]
    warm2 = [eng.submit(wshared + [int(t) for t in wrng.integers(
        1, cfg.vocab_size, args.prompt_len - args.shared_prefix)],
        SamplingParams(max_new_tokens=args.new_tokens)) for _ in range(args.streams)]
    while not all(r.finished for r in warm2):
        eng.step()
    # warmup's radix residue would force eviction churn inside the window
    dropped = eng.reset_prefix_cache()
    print(f"warmup radix residue dropped: {dropped} pages", file=sys.stderr)

    results = [None] * args.streams
    lat, ttft = [None] * args.streams, [None] * args.streams

    def submit_all():
        # inline before stepping (a racing submitter thread admits partial
        # waves); TTFT is measured from each request's own submit time
        for i, p in enumerate(prompts):
            t_sub = time.perf_counter()

            def on_token(tok, fin, i=i, t_sub=t_sub):
                if ttft[i] is None:
                    ttft[i] = time.perf_counter() - t_sub
                if fin:
                    lat[i] = time.perf_counter() - t_sub

            results[i] = eng.submit(p, SamplingParams(max_new_tokens=args.new_tokens),
                                    on_token=on_token)

    # counters as deltas over the measured window (stats include warmup)
    pre = {k: eng.stats[k] for k in ("prefill_tokens", "radix_hit_tokens", "decode_steps")}
    compiles0, compile_s0 = compile_state(eng)

    t0 = time.perf_counter()
    submit_all()
    while any(r is None or not r.finished for r in results):
        if not eng.step():
            time.sleep(0.0005)
    wall = time.perf_counter() - t0
    compiles1, compile_s1 = compile_state(eng)

    out_tokens = sum(len(r.output_ids) for r in results)
    prefill_tokens = eng.stats["prefill_tokens"] - pre["prefill_tokens"]
    m = BenchmarkMetrics.from_latencies(
        [x for x in lat if x], ttfts_s=[x for x in ttft if x],
        total_tokens=out_tokens, total_time_s=wall,
    )
    report = {
        "metric": "continuous-batching serving",
        "model": "tiny" if args.tiny else args.model,
        "streams": args.streams,
        "prompt_len": args.prompt_len,
        "new_tokens": args.new_tokens,
        "slots": args.slots,
        "decode_tok_s": round(out_tokens / wall, 1),
        "total_tok_s": round((out_tokens + prefill_tokens) / wall, 1),
        "ttft_p50_s": round(m.ttft_p50_s, 3),
        "ttft_p95_s": round(m.ttft_p95_s, 3),
        "latency_p50_s": round(m.latency_p50_s, 3),
        "latency_p95_s": round(m.latency_p95_s, 3),
        "wall_s": round(wall, 2),
        "radix_hit_tokens": eng.stats["radix_hit_tokens"] - pre["radix_hit_tokens"],
        "kv_layout": eng.kv_layout,
        "kv_dtype": args.kv_dtype,
        "spec_k": args.spec,
        # accepted drafts per drafted step over the engine's life, warmup
        # included, as the reference's report
        "spec_accept_rate": round(eng.stats.get("spec_accepted", 0)
                                  / max(eng.stats.get("spec_drafted", 1), 1), 3),
        "decode_steps": eng.stats["decode_steps"] - pre["decode_steps"],
        "native_runtime": eng.native_runtime,
        "in_window_compiles": compiles1 - compiles0,
        "in_window_compile_s": round(compile_s1 - compile_s0, 3),
        "device": device_label(dev),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
