"""Fused packed-ternary linear (K1) and MLP block (K2): CUDA kernels and
their plain PyTorch versions.

Counterpart of ``wrinklefree_tpu/ops/ternary_pallas.py``:

- :func:`ternary_matmul_stacked_fused` <- ``ternary_matmul_stacked_fused``
  (optional relu^2/silu of ``[gate|up]``, optional RMS norm, int8 absmax
  quant, packed-ternary dot, ``acc * (1/(sx*sw))`` rounded to bf16);
- :func:`mlp_block_megakernel` <- ``mlp_block_megakernel``
  (``h + down(quant(subnorm(act(bf16(gateup(quant(norm(h))))))))`` in one
  cooperative launch, at most 8 rows);
- :func:`make_linear_fused` <- ``make_pallas_linear_fused``.

Layouts differ from the TPU kernels only by dropping Mosaic's padding: the
weight scale is ``[L]`` (one per layer) or ``[L, N]`` (per column, from
``fuse_projections``), and norm weights are the bf16 ``[L, K]`` rows as the
model stores them.

Each wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel (sources in ``csrc/ternary.cu``) or raises. Each
keeps a plain integer ``launches`` counter, incremented once per launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib
from .norms import rms_norm
from .ternary import quantize_activations, ternary_matmul_reference

_ACTS = {"none": 0, "relu2": 1, "silu": 2}


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
    acc = ternary_matmul_reference(xq, qweight[layer])
    inv = 1.0 / (sx * weight_scale[layer].float())
    return (acc.float() * inv).to(out_dtype)


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
    dev = h.device
    x4 = torch.empty((b, k), dtype=torch.int8, device=dev)
    rowsum = torch.empty((b,), dtype=torch.int32, device=dev)
    sx = torch.empty((b,), dtype=torch.float32, device=dev)
    out = torch.empty((b, n), dtype=torch.bfloat16, device=dev)
    sw_ptr, sw_stride = _scale_args(weight_scale, layer, n)
    nw_ptr = _layer_ptr(norm_w, layer) if (norm and norm_w is not None) else None
    cuda_lib.call(
        "wf_ternary_fused", h2.data_ptr(), b, kin, k, _ACTS[act], int(norm), nw_ptr,
        float(eps), _layer_ptr(qweight, layer), sw_ptr, sw_stride, n, x4.data_ptr(),
        rowsum.data_ptr(), sx.data_ptr(), out.data_ptr(), cuda_lib.stream(h),
    )
    ternary_matmul_stacked_fused.launches += 1
    return out.reshape(*lead, n)


ternary_matmul_stacked_fused.launches = 0


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
    x4a = torch.empty((b, hd), dtype=torch.int8, device=dev)
    x4b = torch.empty((b, inter), dtype=torch.int8, device=dev)
    ints = torch.empty((2, b), dtype=torch.int32, device=dev)
    scales = torch.empty((2, b), dtype=torch.float32, device=dev)
    gu = torch.empty((b, n_gu), dtype=torch.bfloat16, device=dev)
    out = torch.empty((b, hd), dtype=torch.bfloat16, device=dev)
    gsw, gsw_stride = _scale_args(gateup_scale, layer, n_gu)
    dsw, dsw_stride = _scale_args(down_scale, layer, hd)
    cuda_lib.call(
        "wf_mlp_mega", h2.data_ptr(), b, hd, inter, _ACTS[act], _layer_ptr(post_ln, layer),
        _layer_ptr(sub, layer) if sub is not None else None, float(eps),
        _layer_ptr(gateup_qw, layer), gsw, gsw_stride, _layer_ptr(down_qw, layer), dsw,
        dsw_stride, x4a.data_ptr(), ints[0].data_ptr(), scales[0].data_ptr(), gu.data_ptr(),
        x4b.data_ptr(), ints[1].data_ptr(), scales[1].data_ptr(), out.data_ptr(),
        cuda_lib.stream(h),
    )
    mlp_block_megakernel.launches += 1
    return out.reshape(*lead, hd)


mlp_block_megakernel.launches = 0


def make_linear_fused(linear=ternary_matmul_stacked_fused, mlp=mlp_block_megakernel):
    """Fused-prologue stacked ``linear_fn`` for ``paged_forward``:
    ``callable(h, qw_stack, scale, layer, norm_w=None, *, act, norm, eps)``
    with ``.stacked``/``.prologue`` set and ``.mlp_mega`` collapsing the MLP
    block into one call. ``linear``/``mlp`` default to the kernel wrappers;
    passing the ``*_plain`` functions gives the plain path on any device."""

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
    return linear_fn
