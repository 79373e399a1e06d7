"""Rotary position embeddings, HF rotate-half (non-interleaved) convention.

cos/sin are computed in float32 and applied in the activation dtype.
Counterpart of ``wrinklefree_tpu/ops/rope.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float, dtype=torch.bfloat16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...,] int -> (cos, sin) each [..., head_dim]."""
    dev = positions.device
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim)
    )
    freqs = positions.float()[..., None] * inv_freq  # [..., D/2]
    emb = torch.cat([freqs, freqs], dim=-1)  # [..., D]
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [..., S, NH, D], k [..., S, NK, D]; cos/sin [..., S, D]."""
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    q_out = q * cos + _rotate_half(q) * sin
    k_out = k * cos + _rotate_half(k) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
