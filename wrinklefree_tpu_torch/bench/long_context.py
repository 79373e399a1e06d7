"""The long-context path (``engine/long_context.py``) timed on one GPU.

Random ternary weights drawn from seed 0 (BitNet b1.58-2B at full width,
``--layers`` of its 30 layers), a random ``--tokens``-token prompt from seed
1, on a group of one (``group_of_one``: NCCL on the card): after a warm-up
``generate`` of 2 tokens from the prompt's first 64 (the kernels' build,
the group's first collective), one greedy ``generate`` of ``--new-tokens``
tokens (its prefill seconds and decode ms a token, wall clock, with the
host read of the tokens at the end), the peak of allocated device memory,
then ``--profile-steps`` decode steps after a fresh prefill under
``torch.profiler``: device ms a step (the summed durations of the device's
kernels, copies and sets), those operations a step, and the five that take
the most time.

    python -m wrinklefree_tpu_torch.bench.long_context [--tokens 16384]
        [--new-tokens 16] [--layers 30] [--profile-steps 2]
    python -m wrinklefree_tpu_torch.bench.long_context --model tiny --device cpu --tokens 64

Prints one JSON line with the card's name and power limit. On the CPU
(``--device cpu``, the tiny model) the device fields are null: not measured.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json

import torch

from ..config import BitNetConfig
from ..engine.long_context import LongContextEngine, group_of_one
from ..models.bitnet import init_params, resolve_device
from .serving import device_label


def parse_args(argv=None):
    p = argparse.ArgumentParser("wrinklefree_tpu_torch.bench.long_context")
    p.add_argument("--model", choices=["bitnet2b", "tiny"], default="bitnet2b")
    p.add_argument("--layers", type=int, default=None, help="layers (default: all)")
    p.add_argument("--tokens", type=int, default=16384, help="prompt tokens")
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--profile-steps", type=int, default=2)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = BitNetConfig.tiny() if args.model == "tiny" else BitNetConfig.bitnet_2b()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    lce = LongContextEngine(init_params(cfg, seed=0, device=dev), cfg, group_of_one(dev),
                            device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (args.tokens,), generator=g, device=dev)
    cuda = dev.type == "cuda"
    lce.generate(prompt[:64].tolist(), 2)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tokens = lce.generate(prompt.tolist(), args.new_tokens)
    t = lce.last_timings
    report = {
        "metric": "long-context greedy generate", "model": args.model,
        "layers": cfg.num_layers, "prompt_tokens": args.tokens,
        "new_tokens": len(tokens), "prefill_s": t["prefill_s"],
        "decode_ms_per_token": (t["decode_s"] / t["decode_tokens"] * 1e3
                                if t.get("decode_tokens") else None),
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
        "decode_device_ms_per_step": None, "decode_device_ops_per_step": None,
        "decode_top_kernels_ms_per_step": None,
    }
    if cuda and args.profile_steps > 0:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        logits, pk, pv = lce._prefill(prompt[None], args.tokens)
        first = logits[0].argmax()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lce._decode(pk, pv, first, args.tokens, args.profile_steps)
            torch.cuda.synchronize(dev)
        by_name = collections.Counter()
        ops = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name[:60]] += e.time_range.end - e.time_range.start
                ops += 1
        n = args.profile_steps
        report["decode_device_ms_per_step"] = sum(by_name.values()) / 1e3 / n
        report["decode_device_ops_per_step"] = ops / n
        report["decode_top_kernels_ms_per_step"] = {
            k: v / 1e3 / n for k, v in by_name.most_common(5)}
    report["device"] = device_label(dev)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
