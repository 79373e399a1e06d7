"""KV-cache dtypes: BF16 / FP16 / FP32 / FP8 (e4m3, e5m2) / INT8.

Counterpart of ``wrinklefree_tpu/kv/quantized.py``: symmetric per-vector
(token x head) absmax scales, so dequantization is a broadcast multiply in
the attention gather. The reference's quality bar: cosine >= 0.998 of the
logits at INT8/FP8 with half the memory of bf16.

The f32 -> fp8 casts store the reference's bytes: both round to nearest
even, and ``quantize_kv`` keeps every value within the format's maximum
(the absmax element lands on it), where the two libraries' handling of
out-of-range values (torch saturates, ml_dtypes makes NaN) never applies.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

KV_DTYPES = {
    "f32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
    "int8": torch.int8,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
}

_FP8_MAX = {"fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}


def kv_torch_dtype(kv_dtype: str) -> torch.dtype:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r}: one of {sorted(KV_DTYPES)}")
    return KV_DTYPES[kv_dtype]


def kv_dtype_name(dt: torch.dtype) -> str:
    for name, d in KV_DTYPES.items():
        if d == dt:
            return name
    raise ValueError(dt)


def needs_scale(kv_dtype: str) -> bool:
    return kv_dtype in ("int8", "fp8_e4m3", "fp8_e5m2")


def quantize_kv(x: torch.Tensor, kv_dtype: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x [..., D] -> (stored values, f32 scale [..., 1] or None).

    The scale is absmax (clamped below at 1e-6) over 127 (INT8) or the
    format's largest finite value (448 for e4m3, 57344 for e5m2); INT8 rounds
    x / scale half to even into [-127, 127], FP8 casts it. The reference runs
    this inside its jitted programs, where XLA folds the division by the
    constant into a product with its f32 reciprocal; the port computes the
    scale that way too, so both store the same bytes."""
    dt = kv_torch_dtype(kv_dtype)
    if not needs_scale(kv_dtype):
        return x.to(dt), None
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    top = 127.0 if kv_dtype == "int8" else _FP8_MAX[kv_dtype]
    scale = absmax * (1.0 / top)
    if kv_dtype == "int8":
        q = torch.round(xf / scale).clamp(-127, 127).to(dt)
    else:
        q = (xf / scale).to(dt)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: Optional[torch.Tensor],
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    if scale is None:
        return q.to(out_dtype)
    return (q.float() * scale).to(out_dtype)
