"""KV-cache dtypes. Counterpart of ``wrinklefree_tpu/kv/quantized.py``; the
port holds the unquantized pools only (bf16 and f32, stored as they are).
int8 and fp8 pools are not ported yet."""

from __future__ import annotations

import torch

KV_DTYPES = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
}


def kv_torch_dtype(kv_dtype: str) -> torch.dtype:
    if kv_dtype not in KV_DTYPES:
        raise NotImplementedError(
            f"kv_dtype {kv_dtype!r}: the port stores bf16 or f32 KV only")
    return KV_DTYPES[kv_dtype]


def quantize_kv(x: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """Identity store for the unquantized dtypes."""
    return x.to(kv_torch_dtype(kv_dtype))
