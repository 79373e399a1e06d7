"""Ternary (1.58-bit) weight format and the exact reference linear (torch).

Counterpart of ``wrinklefree_tpu/ops/ternary.py``; the on-disk and in-memory
weight format is the same "wf packed format v1" ("plane-major K"):

    A ternary weight matrix W[in=K, out=N] (stored K-major, i.e. already
    transposed for ``x @ W``) with values in {-1, 0, +1} is encoded as
    uint8 ``qweight[K//4, N]``:

        qweight[r, n] bits (2j, 2j+1)  <->  W[j*(K//4) + r, n] + 1

Scale semantics follow HuggingFace's BitLinear: per-token int8 activations
``x_q, s_x = activation_quant(x)`` with ``s_x = 127/absmax``, then
``y = (x_q @ W_ternary) / (s_x * weight_scale)``.

The numpy helpers are copied unchanged from the reference so the port reads
and writes the same bytes without importing it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "pack_ternary",
    "unpack_ternary",
    "pack_ternary_np",
    "unpack_ternary_np",
    "pack_i2s_np",
    "unpack_i2s_np",
    "unpack_hf_packed",
    "hf_packed_to_wf",
    "quantize_weights_ternary",
    "quantize_activations",
    "ternary_matmul_reference",
    "ternary_linear",
]


# ---------------------------------------------------------------------------
# numpy helpers (converters)
# ---------------------------------------------------------------------------


def pack_ternary_np(w_kn: np.ndarray) -> np.ndarray:
    """Pack ternary weights (K-major ``[K, N]``, values in {-1,0,+1}) to
    uint8 ``[K//4, N]`` in the plane-major layout."""
    k, n = w_kn.shape
    if k % 4 != 0:
        raise ValueError(f"K ({k}) must be divisible by 4")
    if np.issubdtype(w_kn.dtype, np.integer):
        enc = (w_kn.astype(np.int8, copy=False) + 1).astype(np.uint8)
    else:
        enc = (
            np.rint(np.asarray(w_kn, dtype=np.float32)).clip(-1, 1).astype(np.int32) + 1
        ).astype(np.uint8)
    planes = enc.reshape(4, k // 4, n)
    # contiguous: packing a transposed view yields an F-ordered result, and
    # some serializers write the raw buffer without honoring strides
    return np.ascontiguousarray(
        (planes[0] | (planes[1] << 2) | (planes[2] << 4) | (planes[3] << 6)).astype(
            np.uint8
        )
    )


def unpack_ternary_np(qweight: np.ndarray) -> np.ndarray:
    """Unpack uint8 ``[K//4, N]`` to int8 ternary ``[K, N]``."""
    q = np.asarray(qweight)
    planes = [((q >> (2 * j)) & 3).astype(np.int8) - 1 for j in range(4)]
    return np.concatenate(planes, axis=0)


def pack_i2s_np(w_nk: np.ndarray) -> np.ndarray:
    """Pack ternary ``[N, K]`` (llama.cpp row-major [out, in], values in
    {-1,0,+1}) into BitNet.cpp/llama.cpp **i2_s** bytes ``[N, K//4]``: byte
    ``c`` packs input columns ``4c..4c+3`` encoded as ``w+1`` in {0,1,2},
    column ``4c+i`` at bit shift ``6-2i`` (the first column in the top
    bits). This is the wire format of BitNet.cpp artifacts, distinct from
    the plane-major kernel layout (:func:`pack_ternary_np`)."""
    n, k = w_nk.shape
    if k % 4 != 0:
        raise ValueError(f"K ({k}) must be divisible by 4")
    enc = (np.asarray(w_nk).astype(np.int8, copy=False) + 1).astype(np.uint8)
    b = enc.reshape(n, k // 4, 4)
    return np.ascontiguousarray(
        (b[..., 0] << 6) | (b[..., 1] << 4) | (b[..., 2] << 2) | b[..., 3]
    )


def unpack_i2s_np(qbytes: np.ndarray) -> np.ndarray:
    """Unpack i2_s bytes ``[N, K//4]`` to int8 ternary ``[N, K]`` (inverse
    of :func:`pack_i2s_np`)."""
    q = np.asarray(qbytes)
    n, k4 = q.shape
    cols = np.stack(
        [((q >> s) & 3).astype(np.int8) - 1 for s in (6, 4, 2, 0)], axis=-1
    )
    return cols.reshape(n, 4 * k4)


def unpack_hf_packed(hf_packed: np.ndarray) -> np.ndarray:
    """Unpack HuggingFace BitNet packed weights ``uint8 [out//4, in]`` (OUT
    axis split into 4 planes: bits (2i, 2i+1) of packed row r give ternary
    row ``i*(out//4) + r``) to int8 ``[out, in]``."""
    q = np.asarray(hf_packed)
    planes = [((q >> (2 * i)) & 3).astype(np.int8) - 1 for i in range(4)]
    return np.concatenate(planes, axis=0)


def hf_packed_to_wf(hf_packed: np.ndarray) -> np.ndarray:
    """HF ``uint8 [out//4, in]`` -> wf ``uint8 [in//4, out]``. Both layouts
    are plane-major, along different axes: a transpose and a bit regroup."""
    w_nk = unpack_hf_packed(hf_packed)  # [out, in] int8
    return pack_ternary_np(w_nk.T)  # [in//4, out]


def quantize_weights_ternary(w: np.ndarray) -> Tuple[np.ndarray, float]:
    """FP weight -> ternary: ``round(clip(w / mean|w|, -1, 1))``; returns the
    HF-semantics ``weight_scale = 1/mean|w|``."""
    w = np.asarray(w, dtype=np.float32)
    scale = 1.0 / max(float(np.mean(np.abs(w))), 1e-5)
    ternary = np.rint(w * scale).clip(-1, 1)
    return ternary.astype(np.int8), float(scale)


# ---------------------------------------------------------------------------
# torch versions
# ---------------------------------------------------------------------------


def pack_ternary(w_kn: torch.Tensor) -> torch.Tensor:
    """torch version of :func:`pack_ternary_np` (runs on the tensor's device)."""
    k, n = w_kn.shape
    if k % 4 != 0:
        raise ValueError(f"K ({k}) must be divisible by 4")
    enc = (torch.round(w_kn.float()).clamp(-1, 1).to(torch.int32) + 1).to(torch.uint8)
    planes = enc.reshape(4, k // 4, n)
    return planes[0] | (planes[1] << 2) | (planes[2] << 4) | (planes[3] << 6)


def unpack_ternary(qweight: torch.Tensor) -> torch.Tensor:
    """uint8 ``[K//4, N]`` -> int8 ternary ``[K, N]``."""
    planes = [((qweight >> (2 * j)) & 3).to(torch.int8) - 1 for j in range(4)]
    return torch.cat(planes, dim=0)


def quantize_activations(
    x: torch.Tensor, hf_exact: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token int8 activation quantization.

    ``scale = 127 / clamp(absmax, 1e-5)``; returns (int8 values, f32 scale of
    shape ``x.shape[:-1] + (1,)``). ``hf_exact=True`` runs the scale and the
    multiply in x.dtype (bf16), as HF does; the default runs them in f32.
    Rounding is half-to-even (``torch.round``), as in the reference.
    """
    dt = x.dtype if hf_exact else torch.float32
    xf = x.to(dt)
    absmax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-5)
    # a tensor divided by a tensor (``127.0 / absmax`` would multiply by the
    # reciprocal); full_like fills on the device, so a CUDA graph can record it
    scale = (torch.full_like(absmax, 127.0) / absmax).to(dt)
    q = torch.round(xf * scale).clamp(-128, 127).to(torch.int8)
    return q, scale.float()


def int_dot(x_q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact ``x_q [..., K] (int8) @ w [K, N] (ternary int8)`` -> int32.

    Computed as an f32 product of integer values: every |partial sum| is at
    most 128*K < 2**24 for K <= 131072, so each is exact in f32 in any
    summation order and whatever TF32 setting is on (the inputs, |x| <= 128
    and |w| <= 1, are exact in TF32's 10-bit mantissa too).
    """
    return torch.matmul(x_q.float(), w.float()).to(torch.int32)


def ternary_matmul_reference(x_q: torch.Tensor, qweight: torch.Tensor) -> torch.Tensor:
    """Oracle: int8 activations ``[..., K]`` x packed ``[K//4, N]`` -> int32."""
    return int_dot(x_q, unpack_ternary(qweight))


def ternary_linear(
    x: torch.Tensor,
    qweight: torch.Tensor,
    weight_scale: torch.Tensor,
    *,
    out_dtype: torch.dtype = torch.bfloat16,
    hf_exact: bool = False,
    kernel=None,
) -> torch.Tensor:
    """Full BitLinear: quantize activations, integer matmul, rescale.

    y = (x_q @ W_ternary) / (act_scale * weight_scale)   [HF semantics]

    ``kernel`` optionally replaces the integer matmul: ``(x_q, qweight) ->
    int32``, for example ``ops.ternary_cuda.ternary_matmul`` (K7's exact
    int32 mode).
    """
    x_q, act_scale = quantize_activations(x, hf_exact=hf_exact)
    acc = (kernel or ternary_matmul_reference)(x_q, qweight)
    if hf_exact:
        # HF casts the exact-integer accumulation to bf16, then divides by
        # bf16 scales
        y = acc.to(out_dtype)
        denom = (act_scale.to(out_dtype) * weight_scale.to(out_dtype)).to(out_dtype)
        return (y / denom).to(out_dtype)
    inv = 1.0 / (act_scale * weight_scale.float())
    return (acc.float() * inv).to(out_dtype)
