"""The paged flash decode (K6) timed alone on one GPU, at the shapes of
``chip_smoke.py``'s K6 phase: BitNet-2B's attention (30 layers, 20 query / 5
KV heads of 128), page size 16, page tables of 128 pages (the engine's
widest at ``max_context=2048``), random bf16 pools from a seed
(``make_inputs`` and ``bound`` also take fp16 and f32 pools, K6's FMA
instantiations, as ``chip_smoke.py`` times them); histories of
17..2000 tokens over 8 slots (``mixed``), 2000 tokens in each of 8 slots
(``8x2000``) and in 1 slot (``1x2000``). Each call reads another layer, so
repeats do not find the history in the 50 MB L2.

    python wrinklefree_tpu_torch/bench/flash_decode.py [--root DIR] [--iters 50]

``--root`` names the checkout whose ``wrinklefree_tpu_torch`` is built and
timed (default: the one this file is in), so that two trees can be timed in
turns on one card: run as a file, not with ``-m``. Prints one JSON line per
shape (device ms per call from ``torch.profiler``, the bytes bound, the
split the wrapper picks where it has ``flash_decode_split``) with the card's
name and power limit. It needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

L, NH, KV, D, PS, MP, SLOTS = 30, 20, 5, 128, 16, 128, 8
SHAPES = {
    "mixed": [17, 100, 255, 512, 777, 1024, 1500, 2000],
    "8x2000": [2000] * 8,
    "1x2000": [2000],
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
POOL_BYTES = {"bf16": 2, "fp16": 2, "f32": 4}  # bytes of a pool element


def make_inputs(dev, seed: int = 0, pool: str = "bf16") -> dict:
    """The pool [SLOTS * MP + 1, 2L, PS, KV*D] (filled in slabs: one randn of
    1.2 GB would double it) and staging pages in the pool's type, bf16 q,
    k_cur, v_cur, and a page table of distinct pages for SLOTS slots."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    dt = {"bf16": torch.bfloat16, "fp16": torch.float16, "f32": torch.float32}[pool]

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    pages = SLOTS * MP + 1
    main = torch.empty((pages, 2 * L, PS, KV * D), dtype=dt, device=dev)
    for i in range(0, pages, 128):
        main[i:i + 128] = rnd(min(128, pages - i), 2 * L, PS, KV * D, dtype=dt)
    pt = (torch.randperm(SLOTS * MP, generator=g, device=dev) + 1).reshape(SLOTS, MP)
    return dict(q=rnd(SLOTS, NH, D), k_cur=rnd(SLOTS, KV, D), v_cur=rnd(SLOTS, KV, D),
                main=main, staging=rnd(SLOTS, PS, 2 * L, KV * D, dtype=dt),
                page_table=pt.to(torch.int32))


def case(inp: dict, lens) -> tuple:
    """The first len(lens) slots' inputs with these seq_lens, in
    ``flash_paged_decode``'s order without the layer: (q, k_cur, v_cur, main,
    staging_b), (page_table, seq_lens)."""
    import torch

    b = len(lens)
    sl = torch.tensor(lens, dtype=torch.int32, device=inp["main"].device)
    return ((inp["q"][:b], inp["k_cur"][:b], inp["v_cur"][:b], inp["main"], inp["staging"][:b]),
            (inp["page_table"][:b], sl))


def nbytes(lens, pool: str = "bf16") -> int:
    """The bytes a call must move: the k and v rows of every slot's history
    (in the pool's type) and current token, q, the output, the page table
    and seq_lens, each once."""
    tokens = sum(n + 1 for n in lens)
    return (2 * tokens * KV * D * POOL_BYTES[pool] + 2 * len(lens) * NH * D * 2
            + len(lens) * (MP + 1) * 4)


def bound(lens, pool: str = "bf16") -> float:
    """The least ms the card could take: ``nbytes`` over the memory rate
    (the 4 * NH * D operations per token are far under the bf16
    tensor-core rate and, on fp16 and f32 pools, the TF32 and f32 rates)."""
    return nbytes(lens, pool) / HBM_BYTES_PER_S * 1e3


def device_ms(fn, iters: int) -> float:
    """Device ms per call: the union of the device intervals that
    torch.profiler records over `iters` calls (after a warm-up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the first sessions of a process can record nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        total, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                total, end = total + b - a, b
            elif b > end:
                total, end = total + b - end, b
        if total > 0:
            return total / 1e3 / iters
    raise RuntimeError("torch.profiler recorded no device time")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose wrinklefree_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("flash_decode bench: needs a CUDA device", file=sys.stderr)
        return 2
    from wrinklefree_tpu_torch.ops import cuda_lib
    from wrinklefree_tpu_torch.ops import flash_attention as fa

    cuda_lib.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    inp = make_inputs(dev)
    split_of = getattr(fa, "flash_decode_split", None)
    for name, lens in SHAPES.items():
        xs, (pt, sl) = case(inp, lens)
        layer = iter(range(10**9))
        ms = device_ms(lambda: fa.flash_paged_decode(*xs, next(layer) % L, pt, sl), args.iters)
        split = (split_of(len(lens), KV, MP * PS, cuda_lib.sm_count(dev))
                 if split_of is not None else None)
        print(json.dumps(dict(root=args.root, shape=name, seq_lens=lens, ms=ms,
                              bound_ms=bound(lens), split=split, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
