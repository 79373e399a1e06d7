"""Device time of BitNet-2B's paged forward on a KV pool of one type, timed
on one GPU: one 512-token prefill chunk after 1024 cached tokens (K4 over
the pool on every layer) and one ``flash_decode`` decode step of 8 slots
with histories of 17..2000 tokens (K6 on every layer), at full width and
depth with random weights and a random pool from a seed (page size 16, 128
pages per slot, the layer-major layout). The chunk and step are those of
``bench/flash_prefill.py``'s ``pool-1x1024`` and ``bench/flash_decode.py``'s
``mixed`` shapes, inside the whole forward.

    python wrinklefree_tpu_torch/bench/pool_steps.py [--root DIR] [--iters 5]
        [--pool {bf16,fp16,f32}]

``--root`` names the checkout whose ``wrinklefree_tpu_torch`` is built and
timed (default: the one this file is in), so that two trees can be timed in
turns on one card: run as a file, not with ``-m``. Prints one JSON line per
call kind: its device ms (the union of the device intervals that
``torch.profiler`` records, per call), the attention kernel's share of it
and its launches per call, with the card's name and power limit. It needs
a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PS, MP, SLOTS = 16, 128, 8
CHUNK, CHUNK_AFTER = 512, 1024
DECODE_LENS = [17, 100, 255, 512, 777, 1024, 1500, 2000]
POOLS = ("bf16", "fp16", "f32")
# the attention kernels (K4, K6) of every tree, as their names hold them
ATTENTION = ("k4_prefill", "k4_wide", "k6_decode", "k6_wide")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose wrinklefree_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--pool", choices=POOLS, default="bf16", help="the KV pool's type")
    return ap.parse_args(argv)


def device_times():
    """``bench/flash_decode.py::device_times`` of this file's tree, loaded
    from its file: ``--root``'s tree may predate it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_flash_decode_bench", Path(__file__).with_name("flash_decode.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_times


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("pool_steps bench: needs a CUDA device", file=sys.stderr)
        return 2
    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.kv.paged import PagedKV, paged_forward
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.ops import cuda_lib
    from wrinklefree_tpu_torch.ops import flash_attention as fa

    cuda_lib.library()
    timed = device_times()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    cfg = BitNetConfig.bitnet_2b()
    params = init_params(cfg, seed=0, device=dev)
    pools = PagedKV.zeros_dual(cfg, SLOTS * MP + 1, PS, SLOTS, kv_dtype=args.pool, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for t in (pools.kv, pools.staging):
        for i in range(0, t.shape[0], 64):
            t[i:i + 64] = torch.randn(t[i:i + 64].shape, generator=g, device=dev).to(t.dtype)
    i32 = dict(dtype=torch.int32, device=dev)
    pt = (torch.randperm(SLOTS * MP, generator=g, device=dev) + 1).reshape(SLOTS, MP).int()
    vocab = cfg.vocab_size
    chunk_toks = torch.randint(1, vocab, (1, CHUNK), generator=g, device=dev)
    step_toks = torch.randint(1, vocab, (SLOTS, 1), generator=g, device=dev)
    runs = {
        f"chunk {CHUNK} after {CHUNK_AFTER}": (fa.flash_paged_prefill, lambda: paged_forward(
            params, cfg, chunk_toks, pools, pt[:1], torch.tensor([CHUNK_AFTER], **i32),
            torch.tensor([CHUNK], **i32), slot_ids=torch.zeros(1, **i32))),
        f"flash_decode step, {SLOTS} slots": (fa.flash_paged_decode, lambda: paged_forward(
            params, cfg, step_toks, pools, pt, torch.tensor(DECODE_LENS, **i32),
            torch.ones(SLOTS, **i32), slot_ids=torch.arange(SLOTS, **i32), flash_decode=True)),
    }
    for what, (counter, fn) in runs.items():
        n0 = counter.launches
        fn()
        launches = counter.launches - n0
        if launches != cfg.num_layers:
            raise RuntimeError(f"{what}: {launches} attention launches, not one a layer")
        ms, attn_ms = timed(fn, args.iters, ATTENTION)
        print(json.dumps(dict(root=args.root, pool=args.pool, call=what, device_ms=ms,
                              attention_ms=attn_ms, attention_launches=launches, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
