"""Activation sparsity (Q-Sparse style) in PyTorch.

Counterpart of ``wrinklefree_tpu/ops/activation_sparsity.py``: per-token
zeroing of low-magnitude activations before the ternary linears, as
threshold, top-k or statistics-adaptive policies, each on the last axis
of an arbitrarily batched tensor with static shapes (the top-k policy
keeps every entry at or above the k-th largest magnitude, so ties at the
cutoff are all kept).

The policies compute what the reference's compute: the standard
deviation with ddof 0 (``jnp.std``; ``torch.std`` defaults to ddof 1),
``k`` through Python's half-to-even ``round``, and only the values of the
top-k (``lax.top_k`` and ``torch.topk`` order ties differently).

30% sparsity is the "inference-safe" preset (no retraining); 60% (the
Q-Sparse paper point) needs quantization-aware training and is exposed
but off by default.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class SparsityMode(str, enum.Enum):
    NONE = "none"
    THRESHOLD = "threshold"
    TOP_K = "top_k"
    ADAPTIVE = "adaptive"


@dataclasses.dataclass(frozen=True)
class ActivationSparsityConfig:
    """Static sparsity policy.

    mode: which policy.
    threshold: absolute magnitude cutoff (THRESHOLD mode).
    sparsity_ratio: fraction of entries to ZERO per token (TOP_K mode);
        0.6 means keep the top 40% magnitudes.
    adaptive_alpha: threshold = alpha * std(x) per token (ADAPTIVE mode).
    min_keep: lower bound on kept entries per token (TOP_K/ADAPTIVE).
    """

    mode: SparsityMode = SparsityMode.NONE
    threshold: float = 0.1
    sparsity_ratio: float = 0.3
    adaptive_alpha: float = 1.0
    min_keep: int = 8

    @classmethod
    def qsparse(cls) -> "ActivationSparsityConfig":
        """The Q-Sparse paper point: 60% sparsity (needs QAT for full
        quality; ``configs/sparsity/qsparse.yaml``)."""
        return cls(mode=SparsityMode.TOP_K, sparsity_ratio=0.6)

    @classmethod
    def inference_safe(cls) -> "ActivationSparsityConfig":
        """30% sparsity, usable without retraining
        (``configs/sparsity/inference_safe.yaml``)."""
        return cls(mode=SparsityMode.TOP_K, sparsity_ratio=0.3)


def _kth_largest(mag: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest value of each row of ``mag`` [..., n], as [..., 1]."""
    return torch.topk(mag, k, dim=-1).values[..., -1:]


def apply_threshold_sparsity(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """Zero entries with |x| < threshold."""
    return torch.where(x.abs() >= threshold, x, torch.zeros((), dtype=x.dtype, device=x.device))


def apply_top_k_sparsity(x: torch.Tensor, sparsity_ratio: float,
                         min_keep: int = 1) -> torch.Tensor:
    """Keep the top-(1-ratio) magnitudes per token (last axis), zero the rest:
    the k-th largest |x| of each row is an inclusive cutoff, so ties at it are
    all kept (possibly more than k: the quality-safe direction)."""
    n = x.shape[-1]
    k = max(min_keep, min(n, int(round(n * (1.0 - sparsity_ratio)))))
    if k >= n:
        return x
    mag = x.float().abs()
    return torch.where(mag >= _kth_largest(mag, k), x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def apply_adaptive_sparsity(x: torch.Tensor, alpha: float = 1.0,
                            min_keep: int = 1) -> torch.Tensor:
    """Per-token statistical threshold: zero |x| < alpha * std(x) (ddof 0),
    keeping at least ``min_keep`` entries per row. Rows with near-uniform
    magnitudes keep most entries; peaked rows sparsify hard."""
    xf = x.float()
    thresh = alpha * torch.std(xf, dim=-1, keepdim=True, correction=0)
    mag = xf.abs()
    keep = mag >= thresh
    if min_keep > 1:
        keep = keep | (mag >= _kth_largest(mag, min(min_keep, x.shape[-1])))
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def apply_sparsity(x: torch.Tensor, cfg: ActivationSparsityConfig) -> torch.Tensor:
    """Dispatch on the policy's mode."""
    mode = SparsityMode(cfg.mode)
    if mode == SparsityMode.NONE:
        return x
    if mode == SparsityMode.THRESHOLD:
        return apply_threshold_sparsity(x, cfg.threshold)
    if mode == SparsityMode.TOP_K:
        return apply_top_k_sparsity(x, cfg.sparsity_ratio, cfg.min_keep)
    if mode == SparsityMode.ADAPTIVE:
        return apply_adaptive_sparsity(x, cfg.adaptive_alpha, cfg.min_keep)
    raise ValueError(f"unknown sparsity mode: {cfg.mode}")


def sparsity_ratio(x: torch.Tensor) -> torch.Tensor:
    """Fraction of exact zeros (0-d f32 tensor): the count times the f32
    reciprocal of the size, the product XLA makes of the reference's mean."""
    return (x == 0).sum(dtype=torch.float32) * (1.0 / x.numel())


def make_sparse_linear_fn(linear_fn, cfg: Optional[ActivationSparsityConfig]):
    """Wrap an unstacked ``linear_fn`` so every ternary linear sees sparsified
    activations. The wrapper is a plain function: it carries none of the
    ``stacked``/``prologue`` attributes, so a forward under sparsity takes the
    plain layer step (and fused params raise there, as in the reference)."""
    if cfg is None or SparsityMode(cfg.mode) == SparsityMode.NONE:
        return linear_fn

    def sparse_linear(x, qweight, scale, **kw):
        return linear_fn(apply_sparsity(x, cfg), qweight, scale, **kw)

    return sparse_linear
