"""The batch-1 attention block megakernel (K5) and the whole decode layer (K8,
whose attention half is K5's stages) timed alone on one GPU at BitNet-2B
shapes (30 layers, H 2560, I 6912, 20 query / 5 KV heads of 128), random
weights from a seed.

- ``k5 T=328 pos=327``, ``k5 T=328 pos=47`` and ``k5 T=2048 pos=2047``:
  ``attn_block_megakernel`` over a cache of T rows at position pos (the
  batch-1 bench's shape, a short history and the longest cache);
- ``k8 T=328 pos=327``: ``layer_block_megakernel`` at the bench's shape;
- ``library ...``: the library call of ``chip_smoke.py``'s K5 rows on the
  same inputs, bf16 ``torch.matmul`` qkv on unpacked weights, SDPA over
  rows 0..pos and bf16 ``torch.matmul`` o with the residual (timed here only
  as a yardstick).

Each call reads the next layer, so the weights (4.1 MB of packed attention
weights a layer, 17.4 MB with the MLP's) and the cache rows come from device
memory, not the 50 MB L2.

    python wrinklefree_tpu_torch/bench/attn_block.py [--root DIR] [--iters 60]
        [--no-library] [--stamps] [--tokens]

``--root`` names the checkout whose ``wrinklefree_tpu_torch`` is built and
timed (default: the one this file is in), so that two trees can be timed in
turns on one card: run as a file, not with ``-m``. ``--stamps`` builds the
kernels with ``-DWF_K5_STAMPS`` (see ``csrc/ternary.cu``) and prints, per K5
shape and for K8, block 0's mean time from the launch's start to the end of
each of K5's stages (after each grid barrier, then its own end), without the
profiler. ``--tokens`` prints instead the 64 greedy batch-1 tokens of each of
the three decode modes (``default``, ``split``, ``layer_mega``) after a
64-token prompt, through the exact head, as ``chip_smoke.py``'s batch1 phase
draws them (2B, 30 layers, seed 0, prompt from seed 3), so that two trees can
be compared token for token. Otherwise it prints one JSON line per shape
(device ms per call from ``torch.profiler``, and the bound: the bytes a call
must move over 3.35 TB/s, or its operations at the published peaks, whichever
is longer) with the card's name and power limit. It needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

if __package__:
    from .roofline import GPU_SPECS
else:  # run or loaded as a file: the table in the file beside this one
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from roofline import GPU_SPECS

L, H, I, NH, KV, D = 30, 2560, 6912, 20, 5, 128
Q = NH * D
NQKV = Q + 2 * KV * D
ROPE_THETA = 500_000.0  # BitNet-2B's
HBM_BYTES_PER_S = GPU_SPECS["h100"]["hbm_bw"]  # H100 SXM published memory rate
INT8_OPS_PER_S = GPU_SPECS["h100"]["int8_ops"]  # dense int8 tensor-core rate
BF16_OPS_PER_S = GPU_SPECS["h100"]["bf16_flops"]
SHAPES = [(328, 327), (328, 47), (2048, 2047)]  # (T, pos) of the K5 rows


def bound(pos: int, mlp: bool = False) -> tuple:
    """(ms, "bytes" or "operations") of the attention block (with ``mlp``,
    the whole layer) at one row: each packed weight, scale and norm row, the
    input and output rows, cos/sin and the cache rows 0..pos read or written
    once, against the int8 dots and the bf16 scores and PV at the published
    peaks."""
    nbytes = (H * 2 * 2 + H // 4 * NQKV + Q // 4 * H + (NQKV + H) * 4 + (H + Q) * 2 + 2 * D * 2
              + 2 * (pos + 1) * KV * D * 2)
    ops = 2 * (H * NQKV + Q * H) / INT8_OPS_PER_S + 4 * NH * D * (pos + 1) / BF16_OPS_PER_S
    if mlp:
        nbytes += H // 4 * 2 * I + I // 4 * H + (2 * I + H) * 4 + (H + I) * 2
        ops += 2 * (H * 2 * I + I * H) / INT8_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= ops * 1e3 else (ops * 1e3, "operations")


def batch1_tokens(dev, prompt_len: int = 64, steps: int = 64) -> dict:
    """The greedy tokens of each batch-1 mode after a random prompt."""
    import torch

    from wrinklefree_tpu_torch.bench import decode as bd
    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.models.bitnet import split_layers_for_decode
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc

    cfg = BitNetConfig.bitnet_2b()
    g = torch.Generator(device="cpu").manual_seed(3)
    prompt = torch.randint(1, cfg.vocab_size, (1, prompt_len), generator=g).to(dev)
    params = bd.bench_params(cfg, dev)
    out = {}
    for mode in ("default", "split", "layer_mega"):
        p = split_layers_for_decode(params, cfg) if mode == "split" else params
        lf = tc.make_linear_fused(layer_mega=mode == "layer_mega")
        tok, cache = bd.prefill(p, cfg, lf, prompt, prompt_len + 4 * steps + 8)
        pos = torch.full((1,), prompt_len, dtype=torch.int32, device=dev)
        toks, _, _, _ = bd.decode_window(p, cfg, lf, tok, cache, pos, steps, bd.exact_head(cfg))
        out[mode] = toks.tolist()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose wrinklefree_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--no-library", action="store_true", help="skip the library calls")
    ap.add_argument("--stamps", action="store_true",
                    help="print K5's stage times from a build with -DWF_K5_STAMPS")
    ap.add_argument("--tokens", action="store_true",
                    help="print the batch-1 greedy tokens of the three modes instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("attn_block bench: needs a CUDA device", file=sys.stderr)
        return 2
    from wrinklefree_tpu_torch.bench.flash_decode import device_ms
    from wrinklefree_tpu_torch.bench.mlp_block import make_weights
    from wrinklefree_tpu_torch.ops import cuda_lib
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.rope import rope_cos_sin
    from wrinklefree_tpu_torch.ops.ternary import unpack_ternary

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    if args.tokens:
        print(json.dumps(dict(root=args.root, tokens=batch1_tokens(dev), card=card)))
        return 0
    w = make_weights(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    layer = iter(range(10**9))

    def nxt():
        return next(layer) % L

    h = torch.randn((1, H), generator=g, device=dev).to(torch.bfloat16)
    caches = {T: tuple(torch.randn((L, 1, T, KV, D), generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(2)) for T in sorted({t for t, _ in SHAPES})}
    ropes = {}
    for _, pos in SHAPES:
        cos, sin = rope_cos_sin(torch.tensor([pos], device=dev), D, ROPE_THETA, torch.bfloat16)
        ropes[pos] = (cos[0], sin[0], torch.tensor([pos], dtype=torch.int32, device=dev))
    attn_s = ("qkv_scale", "o_scale", "input_ln", "attn_sub")
    names = ("qkv_qw", "o_qw", "gateup_qw", "down_qw")
    scales = ("qkv_scale", "o_scale", "gateup_scale", "down_scale", "input_ln", "attn_sub",
              "post_ln", "ffn_sub")

    def emit(shape, ms, pos, mlp=False):
        b_ms, b_by = bound(pos, mlp)
        print(json.dumps(dict(root=args.root, shape=shape, ms=ms, bound_ms=b_ms, bound_by=b_by,
                              card=card)), flush=True)

    def k5(T, pos, iters):
        ck, cv = caches[T]
        cos, sin, p = ropes[pos]
        for _ in range(iters):
            tc.attn_block_megakernel(h, ck, cv, w["qkv_qw"], w["o_qw"], nxt(), p,
                                     *(w[n] for n in attn_s), cos, sin, q_dim=Q, n_kv=KV,
                                     n_heads=NH, head_dim=D)

    def k8(T, pos, iters):
        ck, cv = caches[T]
        cos, sin, p = ropes[pos]
        for _ in range(iters):
            tc.layer_block_megakernel(h, ck, cv, *(w[n] for n in names), nxt(), p,
                                      *(w[n] for n in scales), cos, sin, q_dim=Q, n_kv=KV,
                                      n_heads=NH, head_dim=D)

    if args.stamps:
        cuda_lib.FLAGS = cuda_lib.FLAGS + ("-DWF_K5_STAMPS",)
        lib = cuda_lib.library()
        lib.wf_k5_stamps.argtypes = [ctypes.c_void_p]
        stamps = (ctypes.c_ulonglong * 9)()
        # K8's stamps end with its attention half (K5's body)
        for kernel, (T, pos) in [(k5, s) for s in SHAPES] + [(k8, SHAPES[0])]:
            kernel(T, pos, 10)
            torch.cuda.synchronize()
            cuda_lib.call("wf_k5_stamps", ctypes.addressof(stamps))  # the warm-up, cleared
            kernel(T, pos, 100)
            torch.cuda.synchronize()
            cuda_lib.call("wf_k5_stamps", ctypes.addressof(stamps))
            ends = [stamps[i] / stamps[0] / 1e3 for i in range(1, 9) if stamps[i]]
            print(json.dumps(dict(root=args.root, shape=f"{kernel.__name__} T={T} pos={pos}",
                                  launches=stamps[0],
                                  stage_end_us=ends, stage_us=[b - a for a, b in
                                                               zip([0.0] + ends, ends)],
                                  card=card)), flush=True)
        return 0

    cuda_lib.library()
    for T, pos in SHAPES:
        emit(f"k5 T={T} pos={pos}", device_ms(lambda: k5(T, pos, 1), args.iters), pos)
    T, pos = SHAPES[0]
    emit(f"k8 T={T} pos={pos}", device_ms(lambda: k8(T, pos, 1), args.iters), pos, mlp=True)

    if not args.no_library:
        wq = [unpack_ternary(w["qkv_qw"][i]).to(torch.bfloat16) for i in range(L)]
        wo = [unpack_ternary(w["o_qw"][i]).to(torch.bfloat16) for i in range(L)]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for T, pos in SHAPES:
            ck, cv = caches[T]

            def lib():
                i = nxt()
                q = torch.matmul(h, wq[i])[:, :Q].reshape(1, NH, 1, D)
                k = ck[i, 0, :pos + 1].permute(1, 0, 2)[None]
                v = cv[i, 0, :pos + 1].permute(1, 0, 2)[None]
                return h + torch.matmul(sdpa(q, k, v, enable_gqa=True).reshape(1, Q), wo[i])

            emit(f"library T={T} pos={pos}", device_ms(lib, args.iters), pos)
    return 0


if __name__ == "__main__":
    sys.exit(main())
