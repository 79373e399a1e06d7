"""The causal flash prefill (K9) timed alone on one GPU, at the shapes of
``chip_smoke.py``'s K9 rows: BitNet-2B's attention heads (20 query / 5 KV
heads of 128), random inputs from a seed, bf16 and f32, a 512-token chunk
over 512 keys at q_offset 0 and over 1024 keys at q_offset 128. Beside each
time: the library call on the same inputs (SDPA with the causal mask and
``enable_gqa``) and the bound (the larger of the bytes of q, the keys the
chunk sees, and the output over the memory rate, and 4 * D operations per
visible query-key pair and query head over the dense peak of the type).

    python wrinklefree_tpu_torch/bench/causal_prefill.py [--root DIR] [--iters 50] [--stamps]

``--root`` names the checkout whose ``wrinklefree_tpu_torch`` is built and
timed (default: the one this file is in), so that two trees can be timed in
turns on one card: run as a file, not with ``-m``. Prints one JSON line per
shape (device ms per call from ``torch.profiler``, the median of three
windows, since a window can record only part of its kernels; SDPA's; the
bound; the block shape where the tree has ``causal_prefill_block``) with
the card's name and power limit. ``--stamps`` builds the kernels with
``-DWF_K9_STAMPS`` (see ``csrc/flash_prefill.cu``) and prints instead, per
bf16 shape, the cycles a tile of the longest q tile's first warp spends in
each step of the loop. It needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

if __package__:
    from .roofline import GPU_SPECS
else:  # run or loaded as a file: the table in the file beside this one
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from roofline import GPU_SPECS

NH, KV, D = 20, 5, 128
HBM_BYTES_PER_S = GPU_SPECS["h100"]["hbm_bw"]  # H100 SXM published memory rate
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}  # dense: bf16 tensor cores, f32 CUDA cores
SHAPES = [(kind, s, t, off) for kind in ("bf16", "f32") for s, t, off in ((512, 512, 0),
                                                                          (512, 1024, 128))]


def pairs(s: int, t: int, off: int) -> int:
    """Visible (query, key) pairs: query row r sees keys 0..min(t, off + r + 1) - 1."""
    return sum(min(t, off + r + 1) for r in range(s))


def bound(kind: str, s: int, t: int, off: int) -> tuple:
    """(ms, "bytes" or "operations"), as chip_smoke.py's kernels_k9 counts
    them: q and the output, k and v rows up to the last visible key, and the
    offset, each once; 4 * D operations per visible pair and query head."""
    size = 2 if kind == "bf16" else 4
    keys = min(t, off + s)
    nbytes = (2 * s * NH * D + 2 * keys * KV * D) * size + 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * D * pairs(s, t, off) * NH / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


STEPS = ("wait and barrier", "copy requests", "scores and row maxima", "exchange of maxima",
         "probabilities and their exchange", "PV", "rest of the loop")


def stamps(lib, fn, iters: int = 100) -> dict:
    """The WF_K9_STAMPS counters over `iters` calls of fn (after 10 whose
    counts are cleared): cycles per tile of each step, and tiles per launch."""
    import torch

    lib.wf_k9_stamps.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_ulonglong * 9)()
    for n in (10, iters):
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        rc = lib.wf_k9_stamps(ctypes.addressof(out))
        if rc:
            raise RuntimeError(f"wf_k9_stamps: CUDA error {rc}")
    return dict(launches=out[0], tiles_per_launch=out[1] / out[0],
                cycles_per_tile={step: out[2 + i] / out[1] for i, step in enumerate(STEPS)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose wrinklefree_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--stamps", action="store_true",
                    help="print the bf16 kernel's cycles per tile and step from a build with "
                         "-DWF_K9_STAMPS")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("causal_prefill bench: needs a CUDA device", file=sys.stderr)
        return 2
    from wrinklefree_tpu_torch.bench.flash_decode import device_ms
    from wrinklefree_tpu_torch.ops import cuda_lib
    from wrinklefree_tpu_torch.ops import flash_attention as fa

    if args.stamps:
        cuda_lib.FLAGS = cuda_lib.FLAGS + ("-DWF_K9_STAMPS",)
    lib = cuda_lib.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    block_of = getattr(fa, "causal_prefill_block", None)
    g = torch.Generator(device=dev).manual_seed(0)
    for kind, s, t, off in SHAPES:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        q = torch.randn((1, s, NH, D), generator=g, device=dev).to(dt)
        k = torch.randn((1, t, KV, D), generator=g, device=dev).to(dt)
        v = torch.randn((1, t, KV, D), generator=g, device=dev).to(dt)
        if args.stamps:
            if kind == "bf16":
                print(json.dumps(dict(root=args.root, shape=f"{kind} S={s} T={t} q_offset={off}",
                                      **stamps(lib, lambda: fa.flash_prefill(q, k, v, off)),
                                      card=card)))
            continue
        ms = statistics.median(device_ms(lambda: fa.flash_prefill(q, k, v, off), args.iters)
                               for _ in range(3))
        mask = torch.arange(t, device=dev)[None, :] <= off + torch.arange(s, device=dev)[:, None]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = statistics.median(
            device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True), args.iters)
            for _ in range(3))
        b_ms, b_by = bound(kind, s, t, off)
        block = block_of(NH // KV, D, kind == "f32") if block_of else None
        print(json.dumps(dict(root=args.root, shape=f"{kind} S={s} T={t} q_offset={off}",
                              ms=ms, sdpa_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                              block=block, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
