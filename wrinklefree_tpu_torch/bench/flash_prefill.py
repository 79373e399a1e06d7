"""The paged flash prefill (K4) timed alone on one GPU, at the shapes of
``chip_smoke.py``'s K4 rows: BitNet-2B's attention (30 layers, 20 query / 5
KV heads of 128), random bf16 inputs from a seed (``make_inputs`` and
``bound`` also take fp16 and f32 pools, K4's FMA instantiations, as
``chip_smoke.py`` times them).

- ``contiguous``: ``flash_paged_prefill`` over gathered keys, a 512-token
  chunk over a 512-slot history with kv_valid 400 and new_len 500 (the
  kernels phase's shape since the port's first slice);
- ``pool-1x1024`` and ``pool-4-mixed``: the paged forward's prefill
  attention (``kv.paged._paged_attention_dual_flash``) over the pool at the
  engine's widest table (page size 16, 128 pages per row): one row of a
  512-token chunk after 1024 history tokens, and four rows of 128-token
  chunks (new_lens 128/100/128/37) after 0/320/1024/1904 tokens. Each call
  reads another layer, so repeats do not find the history in the 50 MB L2.

    python wrinklefree_tpu_torch/bench/flash_prefill.py [--root DIR] [--iters 50]

``--root`` names the checkout whose ``wrinklefree_tpu_torch`` is built and
timed (default: the one this file is in), so that two trees can be timed in
turns on one card: run as a file, not with ``-m``. Prints one JSON line per
shape (device ms per call from ``torch.profiler``, the bound, the query
tokens per block where the tree has ``flash_prefill_bq``) with the card's
name and power limit. It needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

L, NH, KV, D, PS, MP = 30, 20, 5, 128, 16, 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
F16_OPS_PER_S = 989e12  # H100 SXM published dense bf16 and fp16 tensor-core rate
F32_OPS_PER_S = 67e12  # H100 SXM published dense f32 rate outside the tensor cores
# pool type: (torch dtype name, bytes an element, the card's peak for products
# of that type exact in f32: bf16 and fp16 on the tensor cores, f32 on the
# CUDA cores, since TF32 truncates it)
POOLS = {"bf16": ("bfloat16", 2, F16_OPS_PER_S), "fp16": ("float16", 2, F16_OPS_PER_S),
         "f32": ("float32", 4, F32_OPS_PER_S)}
CONTIGUOUS = dict(S=512, T=512, kv_valid=400, new_len=500)
POOL = {  # name: (chunk tokens, seq_lens, new_lens)
    "pool-1x1024": (512, [1024], [512]),
    "pool-4-mixed": (128, [0, 320, 1024, 1904], [128, 100, 128, 37]),
}


def pairs(seq_lens, new_lens) -> int:
    """Visible (query, key) pairs over the real query rows: each row's
    history and the chunk up to its diagonal."""
    return sum(n_h + min(r + 1, n) for n_h, n in zip(seq_lens, new_lens) for r in range(n))


def bound(s: int, seq_lens, new_lens, pool: str = "bf16") -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes a call must
    move (q and the output, the valid history and chunk k and v rows, each
    once, in the pool's type) over the memory rate and its 4 * D operations
    per visible pair and query head over the card's peak for the pool's
    type (``POOLS``)."""
    _, eb, peak = POOLS[pool]
    b = len(seq_lens)
    nbytes = 2 * b * s * NH * D * eb + 2 * (sum(seq_lens) + sum(new_lens)) * KV * D * eb
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * D * NH * pairs(seq_lens, new_lens) / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_inputs(dev, seed: int = 0, pool: str = "bf16") -> dict:
    """The pool [4 * MP + 1, 2L, PS, KV*D] (filled in slabs), a page table
    of distinct pages for 4 rows, the widest chunk's q, k and v, and the
    contiguous shape's q, k_full, v_full, all in the pool's type."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, POOLS[pool][0])

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    pages = 4 * MP + 1
    main = torch.empty((pages, 2 * L, PS, KV * D), dtype=dt, device=dev)
    for i in range(0, pages, 128):
        main[i:i + 128] = rnd(min(128, pages - i), 2 * L, PS, KV * D)
    pt = (torch.randperm(4 * MP, generator=g, device=dev) + 1).reshape(4, MP)
    c = CONTIGUOUS
    return dict(main=main, page_table=pt.to(torch.int32), q=rnd(4, 512, NH, D),
                k_cur=rnd(4, 512, KV, D), v_cur=rnd(4, 512, KV, D),
                cq=rnd(1, c["S"], NH, D), ck=rnd(1, c["T"] + c["S"], KV, D),
                cv=rnd(1, c["T"] + c["S"], KV, D))


def pool_case(inp: dict, name: str) -> tuple:
    """The pool shape's arguments of ``flash_paged_prefill_pool`` without
    the layer: (q, k_cur, v_cur, main), (page_table, seq_lens, new_lens)."""
    import torch

    s, sl, nl = POOL[name]
    b = len(sl)
    dev = inp["main"].device
    lens = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (sl, nl))
    return ((*(inp[k][:b, :s].contiguous() for k in ("q", "k_cur", "v_cur")), inp["main"]),
            (inp["page_table"][:b], *lens))


def contiguous_case(inp: dict) -> tuple:
    """(q, k_full, v_full, kv_valid, new_len) of the contiguous shape."""
    import torch

    dev = inp["cq"].device
    c = CONTIGUOUS
    return (inp["cq"], inp["ck"], inp["cv"],
            torch.tensor([c["kv_valid"]], dtype=torch.int32, device=dev),
            torch.tensor([c["new_len"]], dtype=torch.int32, device=dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose wrinklefree_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("flash_prefill bench: needs a CUDA device", file=sys.stderr)
        return 2
    from wrinklefree_tpu_torch.bench.flash_decode import device_ms
    from wrinklefree_tpu_torch.kv import paged
    from wrinklefree_tpu_torch.ops import cuda_lib
    from wrinklefree_tpu_torch.ops import flash_attention as fa

    cuda_lib.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    bq_of = getattr(fa, "flash_prefill_bq", None)
    inp = make_inputs(dev)
    c = CONTIGUOUS
    q, kf, vf, kvv, nl = contiguous_case(inp)
    ms = device_ms(lambda: fa.flash_paged_prefill(q, kf, vf, kvv, nl, hist_len=c["T"]),
                   args.iters)
    b_ms, b_by = bound(c["S"], [c["kv_valid"]], [c["new_len"]])
    print(json.dumps(dict(root=args.root, shape="contiguous", **c, ms=ms, bound_ms=b_ms,
                          bound_by=b_by, bq=bq_of(NH // KV) if bq_of else None,
                          card=card)))
    for name, (s, sl, nls) in POOL.items():
        (q, kc, vc, main), (pt, slt, nlt) = pool_case(inp, name)
        layer = iter(range(10**9))
        staging = torch.zeros((len(sl), PS, 2 * L, KV * D), dtype=torch.bfloat16, device=dev)
        ms = device_ms(lambda: paged._paged_attention_dual_flash(
            q, kc, vc, main, staging, next(layer) % L, pt, slt, nlt, None), args.iters)
        b_ms, b_by = bound(s, sl, nls)
        print(json.dumps(dict(root=args.root, shape=name, S=s, seq_lens=sl, new_lens=nls, ms=ms,
                              bound_ms=b_ms, bound_by=b_by,
                              bq=bq_of(NH // KV) if bq_of else None,
                              card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
