"""Batch-1 greedy decode throughput of the PyTorch port on one GPU.

Counterpart of the repository's root ``bench.py`` at batch 1: random
ternary weights drawn on the card from a seed, ``quantize_lm_head`` and
``fuse_projections``, the fused kernels (``make_linear_fused()``: the
attention and MLP blocks as one launch each per layer at decode), a
prompt prefill, then greedy decode through the ``greedy_exact_topk(k=64)``
head: one warm-up step and a warm window, then the best of three timed
windows of ``--steps`` steps, each ended by a host read of its tokens. The
cache holds prompt + 4 * steps + 8 positions, as ``bench.py``'s.

The window runs eagerly, one step at a time (the exact head reads its
certificate on the host every step); capturing it in a CUDA graph is later
work. Prints one JSON line with ``bench.py``'s field names, the two mode flags,
the card's name and its power limit:

    python -m wrinklefree_tpu_torch.bench.decode [--model bitnet2b|tiny]
        [--prompt 64] [--steps 64] [--device cuda] [--split] [--layer-mega]

``--split`` runs the unrolled decode over ``split_layers_for_decode``'s
per-layer views (``bench.py``'s ``WF_BENCH_SPLIT=1`` at batch 1);
``--layer-mega`` runs one whole-layer kernel per layer
(``make_linear_fused(layer_mega=True)``, the reference's
``WF_LAYER_MEGA=1``). Both are off by default, as in the reference.

Throughput does not depend on the weights' values. ``--device cpu`` runs
the plain versions of the kernels (a smoke of the path, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..config import BitNetConfig
from ..models.bitnet import (
    KVCache,
    forward,
    fuse_projections,
    greedy_exact_topk,
    init_params,
    quantize_lm_head,
    resolve_device,
    split_layers_for_decode,
)
from ..ops.ternary_cuda import make_linear_fused

MODELS = {"bitnet2b": BitNetConfig.bitnet_2b, "tiny": BitNetConfig.tiny}
EXACT_HEAD_K = 64


def bench_params(cfg: BitNetConfig, device, split: bool = False):
    """Random weights from seed 0 with the int8 head and fused projections
    (and the per-layer views of ``split_layers_for_decode`` with ``split``)."""
    params = fuse_projections(quantize_lm_head(init_params(cfg, seed=0, device=device), cfg), cfg)
    return split_layers_for_decode(params, cfg) if split else params


def exact_head(cfg: BitNetConfig, k: int = EXACT_HEAD_K):
    """``forward``'s head_fn: greedy tokens [B, 1] int32 of the exact head."""

    def head_fn(hidden, params):
        return greedy_exact_topk(hidden, params, cfg, k=k)[0][:, None]

    return head_fn


def prefill(params, cfg, lf, prompt, max_len):
    """Prompt [1, P] -> (first token [1, 1], cache). The prompt's logits go
    through ``compute_logits`` (the int8 head), as in ``bench.py``."""
    dev = prompt.device
    cache = KVCache.zeros(cfg, 1, max_len, device=dev)
    logits, cache = forward(params, cfg, prompt, cache, torch.zeros(1, dtype=torch.int32,
                                                                    device=dev),
                            linear_fn=lf, logits_all=False)
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache


def decode_window(params, cfg, lf, tok, cache, pos, steps, head_fn):
    """``steps`` greedy decode steps from token ``tok`` at device position
    ``pos`` ([1] int32); returns (tokens [steps] on the host, last token,
    cache, next position). The host read of the tokens ends the window."""
    outs = []
    for _ in range(steps):
        tok, cache = forward(params, cfg, tok, cache, pos, linear_fn=lf, logits_all=False,
                             head_fn=head_fn)
        outs.append(tok[0, 0])
        pos = pos + 1
    return torch.stack(outs).cpu(), tok, cache, pos


def card_info(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    name, limit = (s.strip() for s in smi.stdout.strip().split(","))
    return {"device_name": name, "power_limit": limit}


def run(model: str = "bitnet2b", prompt_len: int = 64, steps: int = 64, device=None,
        split: bool = False, layer_mega: bool = False) -> dict:
    """The benchmark; returns the result line as a dict."""
    dev = resolve_device(device)
    cfg = MODELS[model]()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    params = bench_params(cfg, dev, split)
    sync()
    init_s = time.perf_counter() - t0
    lf = make_linear_fused(layer_mega=layer_mega)
    head_fn = exact_head(cfg)
    max_len = prompt_len + 4 * steps + 8
    prompt = torch.ones((1, prompt_len), dtype=torch.long, device=dev)

    t0 = time.perf_counter()
    tok, cache = prefill(params, cfg, lf, prompt, max_len)
    tok.cpu()
    prefill_s = time.perf_counter() - t0  # includes the kernels' build on first use

    pos = torch.full((1,), prompt_len, dtype=torch.int32, device=dev)
    _, tok, cache, pos = decode_window(params, cfg, lf, tok, cache, pos, 1, head_fn)
    _, tok, cache, pos = decode_window(params, cfg, lf, tok, cache, pos, steps, head_fn)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        _, tok, cache, pos = decode_window(params, cfg, lf, tok, cache, pos, steps, head_fn)
        best = min(best, time.perf_counter() - t0)
    name = {"tiny": "tiny-smoke"}.get(model, "bitnet-2b")
    result = {
        "metric": f"{name} ternary decode throughput (batch 1, greedy)",
        "value": steps / best,
        "unit": "tok/s",
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "ms_per_token": best / steps * 1e3,
        "fused_window_steps": steps,
        "prefill_first_call_s": prefill_s,
        "param_init_s": init_s,
        "exact_head_k": EXACT_HEAD_K,
        "split": split,
        "layer_mega": layer_mega,
    }
    if dev.type == "cuda":
        result.update(card_info(dev))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="bitnet2b")
    ap.add_argument("--prompt", type=int, default=64, help="prompt tokens")
    ap.add_argument("--steps", type=int, default=64, help="decode steps per window")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--split", action="store_true",
                    help="unrolled decode over split_layers_for_decode's per-layer views")
    ap.add_argument("--layer-mega", action="store_true",
                    help="one whole-layer kernel per layer at decode")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.model, a.prompt, a.steps, a.device, a.split, a.layer_mega)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
