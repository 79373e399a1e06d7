"""Fused packed-ternary linear (K1), MLP block (K2), batch-1 attention
block (K5), batch-1 decode layer (K8) and the packed-ternary matmul of
quantized codes (K7): CUDA kernels and their plain PyTorch versions.

Counterpart of ``wrinklefree_tpu/ops/ternary_pallas.py``:

- :func:`ternary_matmul_stacked_fused` <- ``ternary_matmul_stacked_fused``
  (optional relu^2/silu of ``[gate|up]``, optional RMS norm, int8 absmax
  quant, packed-ternary dot, ``acc * (1/(sx*sw))`` rounded to bf16);
- :func:`mlp_block_megakernel` <- ``mlp_block_megakernel``
  (``h + down(quant(subnorm(act(bf16(gateup(quant(norm(h))))))))`` in one
  cooperative launch, at most 8 rows);
- :func:`attn_block_megakernel` (K5) <- ``attn_block_megakernel`` and
  ``attn_block_megakernel_manual_stacked`` (the batch-1 residual attention
  block with the in-place cache-row write, in one cooperative launch; the
  two TPU kernels compute the same function over the 5-D and the flat
  cache, which on the card are the same bytes);
- :func:`layer_block_megakernel` (K8) <- ``layer_block_megakernel`` (K5's
  stages then K2's at one row: a whole batch-1 decode layer in one
  cooperative launch);
- :func:`attn_block_megakernel_static` <- ``attn_block_megakernel_static``
  and :func:`mlp_block_megakernel_static` <- ``mlp_block_megakernel_static``
  (the same functions on one layer's tensors: the TPU needed them to avoid
  its scalar-prefetch grid; on the card the layer is a pointer, so they
  launch K5 and K2 on the layer's views, K2 once per group of 8 rows);
- :func:`ternary_matmul_stacked` (K7) <- ``ternary_matmul_pallas_stacked``
  and :func:`ternary_matmul` (K7) <- ``ternary_matmul_pallas`` (int8 codes
  and their scale from the caller, packed-ternary dot, ``acc * (1/(sx*sw))``
  as bf16 or f32, or the exact int32 dot; the two TPU kernels differ only in
  how the layer is chosen, which on the card is a pointer, so one kernel
  serves both);
- :func:`make_linear_fused` <- ``make_pallas_linear_fused``,
  :func:`make_linear_stacked` <- ``make_pallas_linear_stacked``,
  :func:`make_linear` <- ``make_pallas_linear``.

Layouts differ from the TPU kernels only by dropping Mosaic's padding: the
weight scale is ``[L]`` (one per layer) or ``[L, N]`` (per column, from
``fuse_projections``), and norm weights are the bf16 ``[L, K]`` rows as the
model stores them.

Each wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel (sources in ``csrc/ternary.cu``) or raises. Each
keeps a plain integer ``launches`` counter, incremented once per launch.
At 8 rows or fewer K1 and K7 end in the packed-ternary GEMV of
``csrc/ternary_gemv.cu`` (each 128-column tile split over
:func:`gemv_split` blocks along K/4), above 8 rows in the tensor-core GEMM
of ``csrc/ternary_gemm.cu``, on the interleaved codes
(:func:`interleave_codes`) and the signed weight codes in the layout of
:func:`unpack_signed_interleaved`; their ``tiled_launches`` counts those
calls (also counted in ``launches``). Both need K and N multiples of 16.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import cuda_lib
from .norms import rms_norm
from .rope import apply_rope
from .ternary import quantize_activations, ternary_matmul_reference

_ACTS = {"none": 0, "relu2": 1, "silu": 2}
DECODE_ROWS = 8  # at most this many rows take the GEMV; more, the GEMM
GEMV_TILE_N = 128  # the GEMV's columns per block
GEMV_STEP = 8  # its packed rows per k-step
GEMV_MAX_SPLIT = 8  # its blocks per cluster


def _check_args(qweight, weight_scale, norm_w, layer):
    L = qweight.shape[0]
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} stacked layers")
    if weight_scale.dim() not in (1, 2) or weight_scale.shape[0] != L:
        raise ValueError(f"weight scale must be [L] or [L, N], got {tuple(weight_scale.shape)}")
    if norm_w is not None and (norm_w.dim() != 2 or norm_w.shape[0] != L):
        raise ValueError(f"norm weight must be [L, K], got {tuple(norm_w.shape)}")


# ---------------------------------------------------------------------------
# plain versions (same order of operations as the kernels)
# ---------------------------------------------------------------------------


def _activation(h2: torch.Tensor, act: str) -> torch.Tensor:
    if act == "none":
        return h2
    k = h2.shape[-1] // 2
    g, u = h2[..., :k], h2[..., k:]
    if act == "relu2":
        # bf16 square, then bf16 multiply (each op rounds to bf16)
        return torch.square(torch.clamp_min(g, 0)) * u
    if act == "silu":
        gf = g.float()
        return (gf * (1.0 / (1.0 + torch.exp(-gf)))).to(h2.dtype) * u
    raise ValueError(f"unknown activation {act!r}")


def ternary_matmul_stacked_fused_plain(
    h: torch.Tensor,
    qweight: torch.Tensor,
    layer: int,
    weight_scale: torch.Tensor,
    norm_w: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
    act: str = "none",
    norm: bool = True,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of K1: the same arithmetic in the same order."""
    _check_args(qweight, weight_scale, norm_w, layer)
    x = _activation(h, act)
    if norm:
        if norm_w is not None:
            x = rms_norm(x, norm_w[layer], eps)
        else:
            x = rms_norm(x, torch.ones(x.shape[-1], dtype=x.dtype, device=x.device), eps)
    xq, sx = quantize_activations(x)
    return ternary_matmul_stacked_plain(xq, qweight, layer, sx, weight_scale, out_dtype=out_dtype)


def mlp_block_megakernel_plain(
    h: torch.Tensor,
    gateup_qw: torch.Tensor,
    down_qw: torch.Tensor,
    layer: int,
    gateup_scale: torch.Tensor,
    down_scale: torch.Tensor,
    post_ln: torch.Tensor,
    ffn_sub: Optional[torch.Tensor],
    *,
    eps: float = 1e-5,
    act: str = "relu2",
    norm2: bool = True,
) -> torch.Tensor:
    """Plain version of K2: two plain fused linears and a bf16 residual."""
    gu = ternary_matmul_stacked_fused_plain(
        h, gateup_qw, layer, gateup_scale, post_ln, eps=eps, act="none", norm=True)
    d = ternary_matmul_stacked_fused_plain(
        gu, down_qw, layer, down_scale, ffn_sub if norm2 else None,
        eps=eps, act=act, norm=norm2)
    return h + d


def _cache5(c: torch.Tensor, n_layers: int, n_kv: int, head_dim: int):
    """A [L, 1, T, KV, D] view of a 5-D or flat [L*T*KV, D] cache, and T."""
    if c.dim() == 2:
        if c.shape[1] != head_dim or c.shape[0] % (n_layers * n_kv):
            raise ValueError(f"flat cache {tuple(c.shape)} is not [L*T*{n_kv}, {head_dim}]")
        t = c.shape[0] // (n_layers * n_kv)
        return c.view(n_layers, 1, t, n_kv, head_dim), t
    if c.dim() != 5 or tuple(c.shape[:2]) != (n_layers, 1) or tuple(c.shape[3:]) != (
            n_kv, head_dim):
        raise ValueError(f"cache {tuple(c.shape)} is not [{n_layers}, 1, T, {n_kv}, {head_dim}]")
    return c, c.shape[2]


def _attn_block_plain(h, ck, cv, qkv_qw, o_qw, layer, pos, qkv_scale, o_scale, input_ln, attn_sub,
                      cos, sin, *, q_dim, n_kv, n_heads, head_dim, eps, norm2, per_kv_head):
    L = qkv_qw.shape[0]
    D, G = head_dim, n_heads // n_kv
    ck5, T = _cache5(ck, L, n_kv, D)
    cv5, _ = _cache5(cv, L, n_kv, D)
    dt = h.dtype
    qkv = ternary_matmul_stacked_fused_plain(h, qkv_qw, layer, qkv_scale, input_ln, eps=eps)[0]
    kvd = n_kv * D
    q, k = apply_rope(qkv[:q_dim].reshape(n_heads, D), qkv[q_dim:q_dim + kvd].reshape(n_kv, D),
                      cos.to(dt).reshape(D), sin.to(dt).reshape(D))  # bf16 ops
    v = qkv[q_dim + kvd:].reshape(n_kv, D)
    p_idx = torch.as_tensor(pos, device=h.device).reshape(1).long()
    ck5[layer, 0].index_copy_(0, p_idx, k[None].to(ck5.dtype))
    cv5[layer, 0].index_copy_(0, p_idx, v[None].to(cv5.dtype))
    kl, vl = ck5[layer, 0].float(), cv5[layer, 0].float()  # [T, KV, D]
    ok = torch.arange(T, device=h.device) <= p_idx
    neg = torch.tensor(-1e30, device=h.device)
    qg = q.reshape(n_kv, G, D).float()
    if per_kv_head:
        heads = []
        for kvh in range(n_kv):
            sc = torch.where(ok, (qg[kvh] @ kl[:, kvh].t()) * (1.0 / math.sqrt(D)), neg)
            e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
            p = (e / e.sum(dim=-1, keepdim=True)).to(cv5.dtype)
            heads.append((p.float() @ vl[:, kvh]).to(dt))
        attn = torch.stack(heads).reshape(1, q_dim)
    else:
        sc = torch.where(ok, torch.einsum("kgd,tkd->kgt", qg, kl) * (1.0 / math.sqrt(D)), neg)
        e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        p = (e / e.sum(dim=-1, keepdim=True)).to(cv5.dtype)
        attn = torch.einsum("kgt,tkd->kgd", p.float(), vl).to(dt).reshape(1, q_dim)
    d = ternary_matmul_stacked_fused_plain(
        attn, o_qw, layer, o_scale, attn_sub if norm2 else None, eps=eps, norm=norm2)
    return h + d, ck, cv


def attn_block_megakernel_plain(
    h, ck, cv, qkv_qw, o_qw, layer, pos, qkv_scale, o_scale, input_ln, attn_sub, cos, sin,
    *, q_dim, n_kv, n_heads, head_dim, eps=1e-5, norm2=True,
):
    """Plain version of K5, op for op the TPU kernel's joint-dot form: fused
    qkv linear; RoPE of k and q in bf16; the roped k row and the raw v row
    written at ``pos``; scores in f32 times 1/sqrt(D), masked to col <= pos
    with -1e30; ``p = bf16(e / sum(e))``; PV in f32 rounded to bf16;
    sub-norm (if ``norm2``), quant, o dot; ``h + bf16(d)``."""
    return _attn_block_plain(
        h, ck, cv, qkv_qw, o_qw, layer, pos, qkv_scale, o_scale, input_ln, attn_sub, cos, sin,
        q_dim=q_dim, n_kv=n_kv, n_heads=n_heads, head_dim=head_dim, eps=eps, norm2=norm2,
        per_kv_head=False)


def layer_block_megakernel_plain(
    h, ck, cv, qkv_qw, o_qw, gateup_qw, down_qw, layer, pos, qkv_scale, o_scale, gateup_scale,
    down_scale, input_ln, attn_sub, post_ln, ffn_sub, cos, sin,
    *, q_dim, n_kv, n_heads, head_dim, eps=1e-5, act="relu2", norm2=True,
):
    """Plain version of K8: the plain K5 followed by the plain K2, with the
    attention in ``_layer_megakernel``'s per-KV-head form
    (``ternary_pallas.py:492-511``): for each KV head, the scores of its G
    query heads over all T rows, -1e30 above ``pos``, softmax per row,
    ``p = bf16(e / sum(e))``, PV. K5's joint-dot form takes one row of KV*T
    columns per query head, the other heads' columns masked too; their
    ``exp(-1e30 - m)`` is exactly 0 in f32, so the two forms differ only in
    the order of their f32 sums. Returns ``(h', ck, cv)``."""
    h1, ck, cv = _attn_block_plain(
        h, ck, cv, qkv_qw, o_qw, layer, pos, qkv_scale, o_scale, input_ln, attn_sub, cos, sin,
        q_dim=q_dim, n_kv=n_kv, n_heads=n_heads, head_dim=head_dim, eps=eps, norm2=norm2,
        per_kv_head=True)
    out = mlp_block_megakernel_plain(h1, gateup_qw, down_qw, layer, gateup_scale, down_scale,
                                     post_ln, ffn_sub, eps=eps, act=act, norm2=norm2)
    return out, ck, cv


def interleave_codes(x_q: torch.Tensor) -> torch.Tensor:
    """The codes in the order the GEMM reads them (what K1's prologue and
    K7's pre-pass write): ``x4[..., 4r + p] = x_q[..., p*K/4 + r]``."""
    k = x_q.shape[-1]
    return x_q.reshape(*x_q.shape[:-1], 4, k // 4).transpose(-1, -2).reshape(x_q.shape)


def unpack_signed_interleaved(qweight: torch.Tensor) -> torch.Tensor:
    """The GEMM's weight operand in PyTorch: packed ``[K/4, N]`` -> int8
    ``[N, K]`` with ``Bt[n, 4r + p]`` = code ``p`` of byte ``qweight[r, n]``
    minus 1, so that ``interleave_codes(x_q) @ Bt.T`` is the exact dot."""
    k4, n = qweight.shape
    codes = torch.stack([((qweight >> (2 * p)) & 3).to(torch.int8) - 1 for p in range(4)], -1)
    return codes.permute(1, 0, 2).reshape(n, 4 * k4)


def gemv_split(k: int, n: int, sms: int) -> int:
    """Blocks per 128-column tile of the decode GEMV, each taking a slice of
    the K/4 packed rows: the largest power of two that keeps the grid within
    one block per SM of the card's ``sms`` (a second block on an SM, or a
    second wave, costs more than the smaller split's longer slices), at most
    8 (the cluster's portable size) and at most the k-steps of 8 packed
    rows; at least 1."""
    tiles = -(-n // GEMV_TILE_N)
    steps = -(-(k // 4) // GEMV_STEP)
    split = 1
    while split < GEMV_MAX_SPLIT and 2 * tiles * split <= sms and 2 * split <= steps:
        split *= 2
    return split


def _check_rows16(k: int, n: int, w_ptr: int, what: str):
    """The 16-byte loads of weight rows and codes (the GEMV, K2's streamed
    dots) and the GEMM's TMA loads need 16-byte aligned rows and bases."""
    if k % 16 or n % 16 or w_ptr % 16:
        raise ValueError(f"{what}: the kernels load 16-byte rows: K and N must be "
                         f"multiples of 16 and the weights 16-byte aligned, got K={k}, N={n}")


def _scale1(s: torch.Tensor) -> torch.Tensor:
    """One layer's weight scale as a one-layer stack: one value -> [1], N
    column scales -> [1, N] (a view)."""
    return s.reshape(1) if s.numel() == 1 else s.reshape(1, -1)


def _row1(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t[None]


def attn_block_megakernel_static_plain(
    h, ck_l, cv_l, qkv_qw_l, o_qw_l, pos, qkv_scale_l, o_scale_l, input_ln_l, attn_sub_l, cos,
    sin, *, q_dim, n_kv, n_heads, head_dim, eps=1e-5, norm2=True,
):
    """Plain version of the static attention block: K5's plain version on
    one layer's tensors (``ck_l``/``cv_l`` [1, T, KV, D], weights [K/4, N],
    scales of one value or [N], norm rows [K]). Returns ``(h', ck_l, cv_l)``."""
    out, _, _ = attn_block_megakernel_plain(
        h, ck_l[None], cv_l[None], qkv_qw_l[None], o_qw_l[None], 0, pos, _scale1(qkv_scale_l),
        _scale1(o_scale_l), input_ln_l[None], _row1(attn_sub_l), cos, sin, q_dim=q_dim,
        n_kv=n_kv, n_heads=n_heads, head_dim=head_dim, eps=eps, norm2=norm2)
    return out, ck_l, cv_l


def mlp_block_megakernel_static_plain(h, gateup_qw_l, down_qw_l, gateup_scale_l, down_scale_l,
                                      post_ln_l, ffn_sub_l, *, eps=1e-5, act="relu2",
                                      norm2=True):
    """Plain version of the static MLP block: K2's plain version on one
    layer's tensors, at any number of rows."""
    return mlp_block_megakernel_plain(
        h, gateup_qw_l[None], down_qw_l[None], 0, _scale1(gateup_scale_l),
        _scale1(down_scale_l), post_ln_l[None], _row1(ffn_sub_l), eps=eps, act=act, norm2=norm2)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _layer_ptr(t: torch.Tensor, layer: int) -> int:
    return t.data_ptr() + layer * t[0].numel() * t.element_size()


def _scale_args(weight_scale: torch.Tensor, layer: int, n: int):
    if weight_scale.dtype != torch.float32 or not weight_scale.is_contiguous():
        raise ValueError("weight scale must be contiguous float32")
    if weight_scale.dim() == 2:
        if weight_scale.shape[1] != n:
            raise ValueError(f"scale rows have {weight_scale.shape[1]} columns, need {n}")
        return _layer_ptr(weight_scale, layer), 1
    return _layer_ptr(weight_scale, layer), 0


def _check_weights(qweight: torch.Tensor):
    if qweight.dtype != torch.uint8 or not qweight.is_contiguous() or qweight.dim() != 3:
        raise ValueError("packed weights must be a contiguous uint8 [L, K/4, N] tensor")
    if qweight.shape[2] % 4 or qweight.data_ptr() % 4:
        raise ValueError("packed weights need N % 4 == 0 and 4-byte alignment")


def _check_norm(norm_w: Optional[torch.Tensor], k: int):
    if norm_w is None:
        return
    if norm_w.dtype != torch.bfloat16 or not norm_w.is_contiguous() or norm_w.shape[1] != k:
        raise ValueError(f"norm weight must be contiguous bf16 [L, {k}]")


def ternary_matmul_stacked_fused(
    h: torch.Tensor,  # [..., KIN] bf16 raw input (KIN = 2K for act modes)
    qweight: torch.Tensor,  # [L, K//4, N] uint8
    layer: int,
    weight_scale: torch.Tensor,  # [L] or [L, N] f32
    norm_w: Optional[torch.Tensor] = None,  # [L, K] bf16
    *,
    eps: float = 1e-5,
    act: str = "none",  # none | relu2 | silu (input is [gate | up])
    norm: bool = True,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Fused prologue + packed-ternary linear against stacked weights; the
    layer is a Python int selecting ``qweight[layer]`` without a copy."""
    if h.device.type == "cpu":
        return ternary_matmul_stacked_fused_plain(
            h, qweight, layer, weight_scale, norm_w,
            eps=eps, act=act, norm=norm, out_dtype=out_dtype)
    cuda_lib.require_cuda(h, "ternary_matmul_stacked_fused")
    _check_args(qweight, weight_scale, norm_w, layer)
    _check_weights(qweight)
    if h.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel takes and returns bfloat16")
    L, k4, n = qweight.shape
    k = 4 * k4
    kin = 2 * k if act in ("relu2", "silu") else k
    if h.shape[-1] != kin:
        raise ValueError(f"input width {h.shape[-1]} != {kin}")
    _check_norm(norm_w, k)
    lead = h.shape[:-1]
    h2 = h.reshape(-1, kin).contiguous()
    b = h2.shape[0]
    w_ptr = _layer_ptr(qweight, layer)
    _check_rows16(k, n, w_ptr, "ternary_matmul_stacked_fused")
    dev = h.device
    split = gemv_split(k, n, cuda_lib.sm_count(dev)) if b <= DECODE_ROWS else 0
    x4 = torch.empty((b, k), dtype=torch.int8, device=dev)
    sx = torch.empty((b,), dtype=torch.float32, device=dev)
    out = torch.empty((b, n), dtype=torch.bfloat16, device=dev)
    sw_ptr, sw_stride = _scale_args(weight_scale, layer, n)
    nw_ptr = _layer_ptr(norm_w, layer) if (norm and norm_w is not None) else None
    cuda_lib.call(
        "wf_ternary_fused", h2.data_ptr(), b, kin, k, _ACTS[act], int(norm), nw_ptr,
        float(eps), w_ptr, sw_ptr, sw_stride, n, x4.data_ptr(), sx.data_ptr(), split,
        out.data_ptr(), cuda_lib.stream(h),
    )
    ternary_matmul_stacked_fused.launches += 1
    ternary_matmul_stacked_fused.tiled_launches += b > DECODE_ROWS
    return out.reshape(*lead, n)


ternary_matmul_stacked_fused.launches = 0
ternary_matmul_stacked_fused.tiled_launches = 0


def _k2_prep(h, gateup_qw, down_qw, layer, gateup_scale, down_scale, post_ln, ffn_sub, *, eps,
             act, norm2):
    """Checks and scratch of K2 at <= 8 rows: (``wf_mlp_mega``'s arguments
    before the stream, the output, the tensors that must outlive the launch)."""
    _check_args(gateup_qw, gateup_scale, post_ln, layer)
    _check_args(down_qw, down_scale, ffn_sub if norm2 else None, layer)
    _check_weights(gateup_qw)
    _check_weights(down_qw)
    if h.dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel takes bfloat16")
    L, h4, n_gu = gateup_qw.shape
    _, i4, n_h = down_qw.shape
    hd, inter = 4 * h4, 4 * i4
    if n_gu != 2 * inter or n_h != hd or h.shape[-1] != hd:
        raise ValueError(f"shapes disagree: h {tuple(h.shape)}, gateup "
                         f"{tuple(gateup_qw.shape)}, down {tuple(down_qw.shape)}")
    if act not in ("relu2", "silu"):
        raise ValueError(f"unknown activation {act!r}")
    _check_norm(post_ln, hd)
    sub = ffn_sub if norm2 else None
    _check_norm(sub, inter)
    lead = h.shape[:-1]
    h2 = h.reshape(-1, hd).contiguous()
    b = h2.shape[0]
    if b > 8:
        raise ValueError(f"mlp_block_megakernel takes at most 8 rows, got {b}")
    dev = h.device
    gw_ptr, dw_ptr = _layer_ptr(gateup_qw, layer), _layer_ptr(down_qw, layer)
    _check_rows16(hd, n_gu, gw_ptr, "mlp_block_megakernel")
    _check_rows16(inter, hd, dw_ptr, "mlp_block_megakernel")
    x4a = torch.empty((b, hd), dtype=torch.int8, device=dev)
    x4b = torch.empty((b, inter), dtype=torch.int8, device=dev)
    scales = torch.empty((2, b), dtype=torch.float32, device=dev)
    gu = torch.empty((b, n_gu), dtype=torch.bfloat16, device=dev)
    # the int32 sums of both dots (csrc/ternary.cu::mlp_block), zeroed by the kernel
    acc = torch.empty((b * (2 * inter + hd),), dtype=torch.int32, device=dev)
    out = torch.empty((b, hd), dtype=torch.bfloat16, device=dev)
    gsw, gsw_stride = _scale_args(gateup_scale, layer, n_gu)
    dsw, dsw_stride = _scale_args(down_scale, layer, hd)
    args = [
        h2.data_ptr(), b, hd, inter, _ACTS[act], _layer_ptr(post_ln, layer),
        _layer_ptr(sub, layer) if sub is not None else None, float(eps), gw_ptr, gsw,
        gsw_stride, dw_ptr, dsw, dsw_stride, x4a.data_ptr(), scales[0].data_ptr(),
        gu.data_ptr(), x4b.data_ptr(), scales[1].data_ptr(), acc.data_ptr(), out.data_ptr(),
    ]
    return args, out.reshape(*lead, hd), (h2, x4a, x4b, scales, gu, acc)


def mlp_block_megakernel(
    h: torch.Tensor,  # [..., H] bf16 pre-norm residual input, <= 8 rows
    gateup_qw: torch.Tensor,  # [L, H//4, 2I] uint8
    down_qw: torch.Tensor,  # [L, I//4, H] uint8
    layer: int,
    gateup_scale: torch.Tensor,  # [L] or [L, 2I] f32
    down_scale: torch.Tensor,  # [L] or [L, H] f32
    post_ln: torch.Tensor,  # [L, H] bf16
    ffn_sub: Optional[torch.Tensor],  # [L, I] bf16 or None (no sub-norm)
    *,
    eps: float = 1e-5,
    act: str = "relu2",  # relu2 | silu
    norm2: bool = True,
) -> torch.Tensor:
    """Residual MLP block ``h + down(act(gateup(norm(h))))`` as one launch."""
    if h.device.type == "cpu":
        return mlp_block_megakernel_plain(
            h, gateup_qw, down_qw, layer, gateup_scale, down_scale, post_ln, ffn_sub,
            eps=eps, act=act, norm2=norm2)
    cuda_lib.require_cuda(h, "mlp_block_megakernel")
    args, out, _scratch = _k2_prep(h, gateup_qw, down_qw, layer, gateup_scale, down_scale,
                                   post_ln, ffn_sub, eps=eps, act=act, norm2=norm2)
    cuda_lib.call("wf_mlp_mega", *args, cuda_lib.stream(h))
    mlp_block_megakernel.launches += 1
    return out


mlp_block_megakernel.launches = 0

ATTN_CHUNK = 64  # cache rows per attention work unit of K5 (csrc/ternary.cu)


def _k5_prep(h, ck, cv, qkv_qw, o_qw, layer, pos, qkv_scale, o_scale, input_ln, attn_sub, cos,
             sin, *, q_dim, n_kv, n_heads, head_dim, eps, norm2):
    """Checks and scratch of K5: (``wf_attn_mega``'s arguments before the
    stream, the output h', its scratch: the bf16 ``qkv`` [1, Q + 2*KV*D] and
    ``attn`` [1, Q] rows and, under ``keep``, the rest)."""
    sub = attn_sub if norm2 else None
    _check_args(qkv_qw, qkv_scale, input_ln, layer)
    _check_args(o_qw, o_scale, sub, layer)
    _check_weights(qkv_qw)
    _check_weights(o_qw)
    L, h4, n_q = qkv_qw.shape
    hd = 4 * h4
    D, G = head_dim, n_heads // n_kv
    if D != 128 or n_heads % n_kv or G > 8:
        raise ValueError(f"the CUDA kernel takes head_dim 128 and <= 8 query heads per "
                         f"KV head, got D={D}, {n_heads}/{n_kv} heads")
    if (n_q != q_dim + 2 * n_kv * D or q_dim != n_heads * D
            or tuple(o_qw.shape[1:]) != (q_dim // 4, hd) or tuple(h.shape) != (1, hd)):
        raise ValueError(f"shapes disagree: h {tuple(h.shape)}, qkv {tuple(qkv_qw.shape)}, "
                         f"o {tuple(o_qw.shape)}")
    if h.dtype != torch.bfloat16 or ck.dtype != torch.bfloat16 or cv.dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel takes bfloat16 activations and cache")
    if not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError("the cache must be contiguous")
    _, T = _cache5(ck, L, n_kv, D)
    if _cache5(cv, L, n_kv, D)[1] != T:
        raise ValueError("k and v caches differ in length")
    _check_norm(input_ln, hd)
    _check_norm(sub, q_dim)
    qw_ptr, ow_ptr = _layer_ptr(qkv_qw, layer), _layer_ptr(o_qw, layer)
    _check_rows16(hd, n_q, qw_ptr, "attn_block_megakernel")
    _check_rows16(q_dim, hd, ow_ptr, "attn_block_megakernel")
    dev = h.device
    if isinstance(pos, torch.Tensor):
        if pos.device != dev or pos.dtype != torch.int32 or pos.numel() != 1:
            raise ValueError("pos must be an int or a one-element int32 tensor on h's device")
        pos_t = pos
    else:
        if not 0 <= pos < T:
            raise IndexError(f"pos {pos} out of range for a cache of {T} rows")
        pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
    cb = cos.to(device=dev, dtype=torch.bfloat16).contiguous()
    sb = sin.to(device=dev, dtype=torch.bfloat16).contiguous()
    if cb.numel() != D or sb.numel() != D:
        raise ValueError(f"cos/sin must hold {D} values")
    h2 = h.contiguous()
    nch = -(-T // ATTN_CHUNK)
    qkv = torch.empty((n_q,), dtype=torch.bfloat16, device=dev)
    scores = torch.empty((n_heads * T,), dtype=torch.float32, device=dev)
    partial = torch.empty((nch * n_heads * D,), dtype=torch.float32, device=dev)
    attn = torch.empty((q_dim,), dtype=torch.bfloat16, device=dev)
    # the codes of h and of the attention row, their scales, and the int32
    # sums of the qkv and o dots (csrc/ternary.cu::attn_block, zeroed by the kernel)
    x4 = torch.empty((hd + q_dim,), dtype=torch.int8, device=dev)
    sx = torch.empty((2,), dtype=torch.float32, device=dev)
    acc = torch.empty((n_q + hd,), dtype=torch.int32, device=dev)
    out = torch.empty((1, hd), dtype=torch.bfloat16, device=dev)
    qsw, qsw_stride = _scale_args(qkv_scale, layer, n_q)
    osw, osw_stride = _scale_args(o_scale, layer, hd)
    args = [
        h2.data_ptr(), hd, q_dim, n_heads, n_kv, T, layer, pos_t.data_ptr(),
        _layer_ptr(input_ln, layer), _layer_ptr(sub, layer) if sub is not None else None,
        int(norm2), float(eps), qw_ptr, qsw, qsw_stride, ow_ptr, osw, osw_stride,
        cb.data_ptr(), sb.data_ptr(), 1.0 / math.sqrt(D), ck.data_ptr(), cv.data_ptr(),
        qkv.data_ptr(), scores.data_ptr(), partial.data_ptr(), attn.data_ptr(), x4.data_ptr(),
        sx.data_ptr(), acc.data_ptr(), out.data_ptr(),
    ]
    scratch = dict(qkv=qkv[None], attn=attn[None], keep=(h2, pos_t, cb, sb, scores, partial, x4,
                                                         sx, acc))
    return args, out, scratch


def attn_block_megakernel(
    h: torch.Tensor,  # [1, H] bf16 pre-norm residual input
    ck: torch.Tensor,  # [L, 1, T, KV, D] or flat [L*T*KV, D] bf16, row pos written in place
    cv: torch.Tensor,
    qkv_qw: torch.Tensor,  # [L, H//4, Q + 2*KV*D] uint8
    o_qw: torch.Tensor,  # [L, Q//4, H] uint8
    layer: int,
    pos,  # int, or an int32 device tensor of one element: write/mask position
    qkv_scale: torch.Tensor,  # [L] or [L, Q + 2*KV*D] f32
    o_scale: torch.Tensor,  # [L] or [L, H] f32
    input_ln: torch.Tensor,  # [L, H] bf16
    attn_sub: Optional[torch.Tensor],  # [L, Q] bf16, or None (no sub-norm)
    cos: torch.Tensor,  # [D] rope row of the current position (used as bf16)
    sin: torch.Tensor,
    *,
    q_dim: int,
    n_kv: int,
    n_heads: int,
    head_dim: int,
    eps: float = 1e-5,
    norm2: bool = True,
    scratch: Optional[dict] = None,
):
    """Residual attention block of one decode token as one launch: returns
    ``(h', ck, cv)`` with row ``pos`` of layer ``layer`` written in place.

    A tensor ``pos`` stays on the device (no host read, so a decode loop
    queues without waiting); the kernel clamps it to [0, T-1]. On the card,
    a dict passed as ``scratch`` receives the launch's bf16 ``qkv`` row
    [1, Q + 2*KV*D] and attention row ``attn`` [1, Q] (the card checks hold
    them against K1)."""
    if h.device.type == "cpu":
        return attn_block_megakernel_plain(
            h, ck, cv, qkv_qw, o_qw, layer, pos, qkv_scale, o_scale, input_ln, attn_sub,
            cos, sin, q_dim=q_dim, n_kv=n_kv, n_heads=n_heads, head_dim=head_dim,
            eps=eps, norm2=norm2)
    cuda_lib.require_cuda(h, "attn_block_megakernel")
    args, out, scr = _k5_prep(
        h, ck, cv, qkv_qw, o_qw, layer, pos, qkv_scale, o_scale, input_ln, attn_sub, cos, sin,
        q_dim=q_dim, n_kv=n_kv, n_heads=n_heads, head_dim=head_dim, eps=eps, norm2=norm2)
    cuda_lib.call("wf_attn_mega", *args, cuda_lib.stream(h))
    attn_block_megakernel.launches += 1
    if scratch is not None:
        scratch.update(qkv=scr["qkv"], attn=scr["attn"])
    return out, ck, cv


attn_block_megakernel.launches = 0


def layer_block_megakernel(
    h: torch.Tensor,  # [1, H] bf16 pre-norm residual input
    ck: torch.Tensor,  # [L, 1, T, KV, D] or flat [L*T*KV, D] bf16, row pos written in place
    cv: torch.Tensor,
    qkv_qw: torch.Tensor,  # [L, H//4, Q + 2*KV*D] uint8
    o_qw: torch.Tensor,  # [L, Q//4, H] uint8
    gateup_qw: torch.Tensor,  # [L, H//4, 2I] uint8
    down_qw: torch.Tensor,  # [L, I//4, H] uint8
    layer: int,
    pos,  # int, or an int32 device tensor of one element
    qkv_scale: torch.Tensor,  # [L] or [L, Q + 2*KV*D] f32
    o_scale: torch.Tensor,  # [L] or [L, H] f32
    gateup_scale: torch.Tensor,  # [L] or [L, 2I] f32
    down_scale: torch.Tensor,  # [L] or [L, H] f32
    input_ln: torch.Tensor,  # [L, H] bf16
    attn_sub: Optional[torch.Tensor],  # [L, Q] bf16 or None
    post_ln: torch.Tensor,  # [L, H] bf16
    ffn_sub: Optional[torch.Tensor],  # [L, I] bf16 or None
    cos: torch.Tensor,  # [D] rope row of the current position (used as bf16)
    sin: torch.Tensor,
    *,
    q_dim: int,
    n_kv: int,
    n_heads: int,
    head_dim: int,
    eps: float = 1e-5,
    act: str = "relu2",  # relu2 | silu
    norm2: bool = True,
    scratch: Optional[dict] = None,
):
    """A whole batch-1 decode layer as one launch (K8): the attention block
    and the MLP block of one token. Returns ``(h', ck, cv)`` with row ``pos``
    of layer ``layer`` written in place. Batch 1 only, as the reference. On
    the card, a dict passed as ``scratch`` receives K5's (see
    :func:`attn_block_megakernel`) and the attention block's output ``h1``."""
    if h.device.type == "cpu":
        return layer_block_megakernel_plain(
            h, ck, cv, qkv_qw, o_qw, gateup_qw, down_qw, layer, pos, qkv_scale, o_scale,
            gateup_scale, down_scale, input_ln, attn_sub, post_ln, ffn_sub, cos, sin,
            q_dim=q_dim, n_kv=n_kv, n_heads=n_heads, head_dim=head_dim, eps=eps, act=act,
            norm2=norm2)
    cuda_lib.require_cuda(h, "layer_block_megakernel")
    a5, h1, scr = _k5_prep(
        h, ck, cv, qkv_qw, o_qw, layer, pos, qkv_scale, o_scale, input_ln, attn_sub, cos, sin,
        q_dim=q_dim, n_kv=n_kv, n_heads=n_heads, head_dim=head_dim, eps=eps, norm2=norm2)
    a2, out, _scratch2 = _k2_prep(h1, gateup_qw, down_qw, layer, gateup_scale, down_scale,
                                  post_ln, ffn_sub, eps=eps, act=act, norm2=norm2)
    # K2's arguments after h', B = 1 and H, which K8 takes from K5's; its
    # scratch is separate from K5's
    cuda_lib.call("wf_layer_mega", *a5, *a2[3:], cuda_lib.stream(h))
    layer_block_megakernel.launches += 1
    if scratch is not None:
        scratch.update(qkv=scr["qkv"], attn=scr["attn"], h1=h1)
    return out, ck, cv


layer_block_megakernel.launches = 0


def attn_block_megakernel_static(
    h: torch.Tensor,  # [1, H] bf16
    ck_l: torch.Tensor,  # [1, T, KV, D] bf16: this layer's cache, row pos written in place
    cv_l: torch.Tensor,
    qkv_qw_l: torch.Tensor,  # [H//4, Q + 2*KV*D] uint8
    o_qw_l: torch.Tensor,  # [Q//4, H] uint8
    pos,  # int, or an int32 device tensor of one element
    qkv_scale_l: torch.Tensor,  # one f32 value or [Q + 2*KV*D]
    o_scale_l: torch.Tensor,  # one f32 value or [H]
    input_ln_l: torch.Tensor,  # [H] bf16
    attn_sub_l: Optional[torch.Tensor],  # [Q] bf16 or None
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    q_dim: int,
    n_kv: int,
    n_heads: int,
    head_dim: int,
    eps: float = 1e-5,
    norm2: bool = True,
):
    """The attention block on one layer's tensors (the unrolled decode
    path's): K5 launched on the layer's pointers, counted here and not in
    ``attn_block_megakernel.launches``. Returns ``(h', ck_l, cv_l)``."""
    if h.device.type == "cpu":
        return attn_block_megakernel_static_plain(
            h, ck_l, cv_l, qkv_qw_l, o_qw_l, pos, qkv_scale_l, o_scale_l, input_ln_l, attn_sub_l,
            cos, sin, q_dim=q_dim, n_kv=n_kv, n_heads=n_heads, head_dim=head_dim, eps=eps,
            norm2=norm2)
    cuda_lib.require_cuda(h, "attn_block_megakernel_static")
    args, out, _scratch = _k5_prep(
        h, ck_l[None], cv_l[None], qkv_qw_l[None], o_qw_l[None], 0, pos, _scale1(qkv_scale_l),
        _scale1(o_scale_l), input_ln_l[None], _row1(attn_sub_l), cos, sin, q_dim=q_dim,
        n_kv=n_kv, n_heads=n_heads, head_dim=head_dim, eps=eps, norm2=norm2)
    cuda_lib.call("wf_attn_mega", *args, cuda_lib.stream(h))
    attn_block_megakernel_static.launches += 1
    return out, ck_l, cv_l


attn_block_megakernel_static.launches = 0


def mlp_block_megakernel_static(
    h: torch.Tensor,  # [..., H] bf16, any number of rows
    gateup_qw_l: torch.Tensor,  # [H//4, 2I] uint8
    down_qw_l: torch.Tensor,  # [I//4, H] uint8
    gateup_scale_l: torch.Tensor,  # one f32 value or [2I]
    down_scale_l: torch.Tensor,  # one f32 value or [H]
    post_ln_l: torch.Tensor,  # [H] bf16
    ffn_sub_l: Optional[torch.Tensor],  # [I] bf16 or None
    *,
    eps: float = 1e-5,
    act: str = "relu2",
    norm2: bool = True,
) -> torch.Tensor:
    """The MLP block on one layer's tensors at any number of rows: K2
    launched on the layer's pointers once per group of 8 rows, counted here
    and not in ``mlp_block_megakernel.launches``."""
    if h.device.type == "cpu":
        return mlp_block_megakernel_static_plain(
            h, gateup_qw_l, down_qw_l, gateup_scale_l, down_scale_l, post_ln_l, ffn_sub_l,
            eps=eps, act=act, norm2=norm2)
    cuda_lib.require_cuda(h, "mlp_block_megakernel_static")
    layer_args = (gateup_qw_l[None], down_qw_l[None], 0, _scale1(gateup_scale_l),
                  _scale1(down_scale_l), post_ln_l[None], _row1(ffn_sub_l))
    lead, hd = h.shape[:-1], h.shape[-1]
    h2 = h.reshape(-1, hd)
    outs = []
    for r0 in range(0, h2.shape[0], 8):
        args, out, _scratch = _k2_prep(h2[r0:r0 + 8], *layer_args, eps=eps, act=act, norm2=norm2)
        cuda_lib.call("wf_mlp_mega", *args, cuda_lib.stream(h))
        mlp_block_megakernel_static.launches += 1
        outs.append(out)
    if not outs:
        return torch.empty_like(h)
    return (outs[0] if len(outs) == 1 else torch.cat(outs)).reshape(*lead, hd)


mlp_block_megakernel_static.launches = 0


# ---------------------------------------------------------------------------
# K7: the packed-ternary matmul of caller-quantized codes
# ---------------------------------------------------------------------------

_OUT_MODES = {torch.bfloat16: 0, torch.float32: 1}
_OUT_I32 = 2


def _rescale(acc: torch.Tensor, act_scale: torch.Tensor, sw: torch.Tensor, out_dtype):
    """``acc * (1/(sx*sw))`` in f32, cast to ``out_dtype`` (the TPU kernels'
    epilogue, ``ternary_pallas.py:101-102``)."""
    sx = act_scale.float().reshape(*acc.shape[:-1], 1)
    inv = 1.0 / (sx * sw.float())
    return (acc.float() * inv).to(out_dtype)


def ternary_matmul_stacked_plain(x_q, qweight, layer, act_scale, weight_scale, *,
                                 out_dtype=torch.bfloat16):
    """Plain version of K7 over a layer stack: the exact integer dot of
    ``x_q`` with ``qweight[layer]``, then the rescale by the layer's scale
    (``[L]``) or its column scales (``[L, N]``)."""
    _check_args(qweight, weight_scale, None, layer)
    return _rescale(ternary_matmul_reference(x_q, qweight[layer]), act_scale,
                    weight_scale[layer], out_dtype)


def ternary_matmul_plain(x_q, qweight, act_scale=None, weight_scale=None, *,
                         out_dtype=torch.bfloat16):
    """Plain version of K7 on one ``[K/4, N]`` matrix: the exact int32 dot
    without scales, else its rescale (``weight_scale`` a scalar or ``[N]``)."""
    acc = ternary_matmul_reference(x_q, qweight)
    if act_scale is None:
        return acc
    return _rescale(acc, act_scale, weight_scale, out_dtype)


def _launch_k7(x_q, w_ptr, k, n, act_scale, sw_ptr, sw_stride, out_dtype):
    """Checks, scratch and the launch shared by K7's two wrappers."""
    if x_q.dtype != torch.int8 or x_q.shape[-1] != k:
        raise ValueError(f"x_q must be int8 [..., {k}], got {x_q.dtype} {tuple(x_q.shape)}")
    lead = x_q.shape[:-1]
    x2 = x_q.reshape(-1, k).contiguous()
    b = x2.shape[0]
    dev = x_q.device
    if act_scale is None:
        mode, dt, sx_ptr = _OUT_I32, torch.int32, None
    else:
        if out_dtype not in _OUT_MODES:
            raise ValueError(f"the CUDA kernel returns bfloat16 or float32, not {out_dtype}")
        if act_scale.device != dev or act_scale.numel() != b:
            raise ValueError(f"act_scale must hold {b} values on {dev}")
        sx = act_scale.reshape(b).float().contiguous()
        mode, dt, sx_ptr = _OUT_MODES[out_dtype], out_dtype, sx.data_ptr()
    out = torch.empty((b, n), dtype=dt, device=dev)
    if b == 0:
        return out.reshape(*lead, n)
    _check_rows16(k, n, w_ptr, "ternary_matmul")
    x4, split = None, 0
    if b > DECODE_ROWS:  # the GEMM's interleave pre-pass writes the codes here
        x4 = torch.empty((b, k), dtype=torch.int8, device=dev)
    else:
        split = gemv_split(k, n, cuda_lib.sm_count(dev))
        if x2.data_ptr() % 16:  # the GEMV reads the codes in 16-byte items
            x2 = x2.clone()
    cuda_lib.call(
        "wf_ternary_matmul", x2.data_ptr(), b, k, sx_ptr, w_ptr, sw_ptr, sw_stride, n, mode,
        split, x4.data_ptr() if x4 is not None else None, out.data_ptr(), cuda_lib.stream(x_q),
    )
    ternary_matmul_stacked.launches += 1
    ternary_matmul_stacked.tiled_launches += b > DECODE_ROWS
    return out.reshape(*lead, n)


def ternary_matmul_stacked(
    x_q: torch.Tensor,  # [..., K] int8 codes
    qweight: torch.Tensor,  # [L, K//4, N] uint8
    layer: int,
    act_scale: torch.Tensor,  # [..., 1] f32 (quantize_activations' scale)
    weight_scale: torch.Tensor,  # [L] or [L, N] f32
    *,
    out_dtype: torch.dtype = torch.bfloat16,  # bfloat16 or float32
) -> torch.Tensor:
    """K7 against stacked weights: ``(x_q @ W[layer]) * (1/(sx*sw))``; the
    layer is a Python int selecting ``qweight[layer]`` without a copy.
    ``launches`` counts K7's launches from this wrapper and
    :func:`ternary_matmul`, ``tiled_launches`` those above 8 rows."""
    if x_q.device.type == "cpu":
        return ternary_matmul_stacked_plain(x_q, qweight, layer, act_scale, weight_scale,
                                            out_dtype=out_dtype)
    cuda_lib.require_cuda(x_q, "ternary_matmul_stacked")
    _check_args(qweight, weight_scale, None, layer)
    _check_weights(qweight)
    _, k4, n = qweight.shape
    sw_ptr, sw_stride = _scale_args(weight_scale, layer, n)
    return _launch_k7(x_q, _layer_ptr(qweight, layer), 4 * k4, n, act_scale, sw_ptr, sw_stride,
                      out_dtype)


ternary_matmul_stacked.launches = 0
ternary_matmul_stacked.tiled_launches = 0


def ternary_matmul(
    x_q: torch.Tensor,  # [..., K] int8 codes
    qweight: torch.Tensor,  # [K//4, N] uint8, e.g. a view qw[l, e] of an expert stack
    act_scale: Optional[torch.Tensor] = None,  # [..., 1] f32
    weight_scale: Optional[torch.Tensor] = None,  # scalar or [N] f32
    *,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K7 on one matrix: with scales ``(x_q @ W) * (1/(sx*sw))`` in
    ``out_dtype``, without them the exact int32 accumulator. Counted in
    ``ternary_matmul_stacked.launches``."""
    if x_q.device.type == "cpu":
        return ternary_matmul_plain(x_q, qweight, act_scale, weight_scale, out_dtype=out_dtype)
    cuda_lib.require_cuda(x_q, "ternary_matmul")
    if qweight.dim() != 2:
        raise ValueError(f"packed weights must be [K/4, N], got {tuple(qweight.shape)}")
    _check_weights(qweight[None])
    k4, n = qweight.shape
    sw_ptr, sw_stride = None, 0
    if act_scale is not None:
        if weight_scale is None:
            raise ValueError("act_scale needs a weight_scale")
        if (weight_scale.dtype != torch.float32 or not weight_scale.is_contiguous()
                or weight_scale.device != x_q.device or weight_scale.numel() not in (1, n)):
            raise ValueError("weight scale must be one contiguous float32 value or [N] on "
                             "x_q's device")
        sw_ptr, sw_stride = weight_scale.data_ptr(), 1 if weight_scale.numel() > 1 else 0
    return _launch_k7(x_q, qweight.data_ptr(), 4 * k4, n, act_scale, sw_ptr, sw_stride,
                      out_dtype)


def ternary_linear_stacked(x, qweight, weight_scale, layer, *, out_dtype=torch.bfloat16,
                           matmul=ternary_matmul_stacked, quant_axis=None):
    """Quantize ``x`` (torch, per row), then K7 on ``qweight[layer]``. The
    quantization stays outside the kernel, as in the reference: with
    ``quant_axis`` (tensor parallelism) the per-row absmax is reduced with
    MAX over the axis's ranks between the two."""
    x_q, act_scale = quantize_activations(x, quant_axis=quant_axis)
    return matmul(x_q, qweight, layer, act_scale, weight_scale, out_dtype=out_dtype)


def make_linear(matmul=ternary_matmul):
    """Unstacked ``linear_fn`` ``(x, qweight [K/4, N], scale, out_dtype)``:
    quantize, then K7 on one matrix. ``matmul=ternary_matmul_plain`` gives the
    plain path on any device. ``quant_axis`` (a ``parallel.sharding.Axis``):
    the per-row absmax all-reduced with MAX over the axis before the codes
    are taken (a row-parallel linear under tensor parallelism)."""

    def linear_fn(x, qweight, scale, out_dtype=torch.bfloat16, quant_axis=None):
        x_q, act_scale = quantize_activations(x, quant_axis=quant_axis)
        return matmul(x_q, qweight, act_scale, scale, out_dtype=out_dtype)

    return linear_fn


def make_linear_stacked(matmul=ternary_matmul_stacked, expert_matmul=ternary_matmul):
    """Stacked ``linear_fn`` ``(x, qw_stack [L, K/4, N], scale_stack [L] or
    [L, N], layer, out_dtype)`` with ``.stacked`` set, for unfused or
    q/k/v-fused params. ``.expert_linear`` is ``make_linear(expert_matmul)``,
    which ``paged_forward`` hands to the MoE experts. The ``*_plain``
    functions give the plain path on any device."""

    def linear_fn(x, qw_stack, scale_stack, layer, out_dtype=torch.bfloat16, quant_axis=None):
        return ternary_linear_stacked(x, qw_stack, scale_stack, layer, out_dtype=out_dtype,
                                      matmul=matmul, quant_axis=quant_axis)

    linear_fn.stacked = True
    linear_fn.expert_linear = make_linear(expert_matmul)
    return linear_fn


def make_linear_fused(linear=ternary_matmul_stacked_fused, mlp=mlp_block_megakernel,
                      attn=attn_block_megakernel, layer=layer_block_megakernel,
                      attn_static=attn_block_megakernel_static,
                      mlp_static=mlp_block_megakernel_static, layer_mega=False):
    """Fused-prologue stacked ``linear_fn`` for ``paged_forward`` and
    ``models.bitnet.forward``: ``callable(h, qw_stack, scale, layer,
    norm_w=None, *, act, norm, eps)`` with ``.stacked``/``.prologue`` set,
    ``.mlp_mega`` collapsing the MLP block into one call, ``.attn_mega`` the
    batch-1 attention block, ``.attn_mega_static``/``.mlp_mega_static`` the
    two blocks on one layer's tensors (the unrolled decode over
    ``split_layers_for_decode``'s params) and, with ``layer_mega=True`` (the
    reference's ``WF_LAYER_MEGA=1``), ``.layer_mega`` the whole batch-1 decode
    layer. The functions default to the kernel wrappers; passing the
    ``*_plain`` functions gives the plain path on any device."""

    def linear_fn(h, qw_stack, scale, layer, norm_w=None, *, act="none", norm=True,
                  eps=1e-5, out_dtype=torch.bfloat16):
        return linear(h, qw_stack, layer, scale, norm_w, eps=eps, act=act, norm=norm,
                      out_dtype=out_dtype)

    def mlp_mega_fn(h, gateup_qw, down_qw, layer, gateup_scale, down_scale, post_ln,
                    ffn_sub, *, eps=1e-5, act="relu2", norm2=True):
        return mlp(h, gateup_qw, down_qw, layer, gateup_scale, down_scale, post_ln,
                   ffn_sub, eps=eps, act=act, norm2=norm2)

    linear_fn.stacked = True
    linear_fn.prologue = True
    linear_fn.mlp_mega = mlp_mega_fn
    linear_fn.attn_mega = attn
    linear_fn.attn_mega_static = attn_static
    linear_fn.mlp_mega_static = mlp_static
    if layer_mega:
        linear_fn.layer_mega = layer
    return linear_fn
