"""The MLP block megakernel (K2) and the whole decode layer (K8, whose MLP
half is K2's stages) timed alone on one GPU at BitNet-2B shapes (30 layers,
H 2560, I 6912, 20 query / 5 KV heads of 128), random weights from a seed.

- ``k2-1`` and ``k2-8``: ``mlp_block_megakernel`` at 1 and 8 rows (batch-1
  decode and the serving decode step);
- ``k8``: ``layer_block_megakernel`` with a 328-row cache at position 327
  (the batch-1 bench's shape);
- ``library-1`` and ``library-8``: the library call of ``chip_smoke.py``'s
  K2 rows on the same inputs, bf16 ``torch.matmul`` on unpacked weights,
  relu^2 and the residual (timed here only as a yardstick).

Each call reads the next layer, so the weights (13.3 MB of packed MLP
weights a layer, 398 MB in all) come from device memory, not the 50 MB L2.

    python wrinklefree_tpu_torch/bench/mlp_block.py [--root DIR] [--iters 60] [--no-library]

``--root`` names the checkout whose ``wrinklefree_tpu_torch`` is built and
timed (default: the one this file is in), so that two trees can be timed in
turns on one card: run as a file, not with ``-m``. Prints one JSON line per
shape (device ms per call from ``torch.profiler``, and the bound: the bytes
a call must move over 3.35 TB/s, or its int8 operations over 1979 TOP/s,
whichever is longer) with the card's name and power limit. It needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

if __package__:
    from .roofline import GPU_SPECS
else:  # run or loaded as a file: the table in the file beside this one
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from roofline import GPU_SPECS

L, H, I, NH, KV, D, T, POS = 30, 2560, 6912, 20, 5, 128, 328, 327
Q = NH * D
ROPE_THETA = 500_000.0  # BitNet-2B's
HBM_BYTES_PER_S = GPU_SPECS["h100"]["hbm_bw"]  # H100 SXM published memory rate
INT8_OPS_PER_S = GPU_SPECS["h100"]["int8_ops"]  # dense int8 tensor-core rate
BF16_OPS_PER_S = GPU_SPECS["h100"]["bf16_flops"]


def bound(rows: int, attn: bool = False) -> tuple:
    """(ms, "bytes" or "operations") of the MLP block at `rows` rows, or of
    the whole layer at one row: each packed weight, scale and norm row, the
    input and output rows and the cache rows 0..POS read or written once,
    against the int8 dots (and the bf16 attention) at the published peaks."""
    nbytes = rows * H * 2 * 2 + H // 4 * 2 * I + I // 4 * H + (2 * I + H) * 4 + (H + I) * 2
    ops = 2 * rows * (H * 2 * I + I * H) / INT8_OPS_PER_S
    if attn:
        n_q = Q + 2 * KV * D
        nbytes += (H // 4 * n_q + Q // 4 * H + (n_q + H) * 4 + (H + Q) * 2 + 2 * D * 2
                   + 2 * (POS + 1) * KV * D * 2)
        ops += 2 * (H * n_q + Q * H) / INT8_OPS_PER_S + 4 * NH * D * (POS + 1) / BF16_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= ops * 1e3 else (ops * 1e3, "operations")


def make_weights(dev, seed: int = 0) -> dict:
    """Packed ternary weights (random bytes), per-column scales and bf16
    norm rows of L layers, stacked as the fused model stores them."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def packed(k, n):
        return torch.randint(0, 256, (L, k // 4, n), generator=g, device=dev, dtype=torch.uint8)

    def scale(n):
        return torch.rand((L, n), generator=g, device=dev) * 80 + 10

    def norm(n):
        return (1 + 0.1 * torch.randn((L, n), generator=g, device=dev)).to(torch.bfloat16)

    n_q = Q + 2 * KV * D
    return dict(qkv_qw=packed(H, n_q), o_qw=packed(Q, H), gateup_qw=packed(H, 2 * I),
                down_qw=packed(I, H), qkv_scale=scale(n_q), o_scale=scale(H),
                gateup_scale=scale(2 * I), down_scale=scale(H), input_ln=norm(H),
                attn_sub=norm(Q), post_ln=norm(H), ffn_sub=norm(I))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose wrinklefree_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--no-library", action="store_true", help="skip the library calls")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("mlp_block bench: needs a CUDA device", file=sys.stderr)
        return 2
    from wrinklefree_tpu_torch.bench.flash_decode import device_ms
    from wrinklefree_tpu_torch.ops import cuda_lib
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.rope import rope_cos_sin
    from wrinklefree_tpu_torch.ops.ternary import unpack_ternary

    cuda_lib.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    w = make_weights(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    layer = iter(range(10**9))

    def nxt():
        return next(layer) % L

    def emit(shape, ms, rows, attn=False):
        b_ms, b_by = bound(rows, attn)
        print(json.dumps(dict(root=args.root, shape=shape, ms=ms, bound_ms=b_ms, bound_by=b_by,
                              card=card)), flush=True)

    mlp = (w["gateup_qw"], w["down_qw"])
    mlp_s = (w["gateup_scale"], w["down_scale"], w["post_ln"], w["ffn_sub"])
    hs = {rows: torch.randn((rows, H), generator=g, device=dev).to(torch.bfloat16)
          for rows in (1, 8)}
    for rows, h in hs.items():
        ms = device_ms(lambda: tc.mlp_block_megakernel(h, *mlp, nxt(), *mlp_s), args.iters)
        emit(f"k2-{rows}", ms, rows)

    ck = torch.randn((L, 1, T, KV, D), generator=g, device=dev).to(torch.bfloat16)
    cv = torch.randn((L, 1, T, KV, D), generator=g, device=dev).to(torch.bfloat16)
    cos, sin = rope_cos_sin(torch.tensor([POS], device=dev), D, ROPE_THETA, torch.bfloat16)
    pos = torch.tensor([POS], dtype=torch.int32, device=dev)
    names = ("qkv_qw", "o_qw", "gateup_qw", "down_qw")
    scales = ("qkv_scale", "o_scale", "gateup_scale", "down_scale", "input_ln", "attn_sub",
              "post_ln", "ffn_sub")
    ms = device_ms(lambda: tc.layer_block_megakernel(
        hs[1], ck, cv, *(w[n] for n in names), nxt(), pos, *(w[n] for n in scales), cos[0],
        sin[0], q_dim=Q, n_kv=KV, n_heads=NH, head_dim=D), args.iters)
    emit(f"k8 T={T} pos={POS}", ms, 1, attn=True)

    if not args.no_library:
        wg = [unpack_ternary(w["gateup_qw"][i]).to(torch.bfloat16) for i in range(L)]
        wd = [unpack_ternary(w["down_qw"][i]).to(torch.bfloat16) for i in range(L)]
        for rows, h in hs.items():
            def lib():
                i = nxt()
                gu = torch.matmul(h, wg[i])
                return h + torch.matmul(torch.square(torch.relu(gu[:, :I])) * gu[:, I:], wd[i])

            emit(f"library-{rows}", device_ms(lib, args.iters), rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
