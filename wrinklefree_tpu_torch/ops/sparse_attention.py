"""Attention sparsity in PyTorch.

Counterpart of ``wrinklefree_tpu/ops/sparse_attention.py``:

- TOP_K:     keep the k largest post-softmax weights per query, renormalize.
- THRESHOLD: zero weights below a probability floor, renormalize.
- WINDOW:    local window + global tokens + strided keys, applied before the
             softmax as a mask (``create_window_mask``).
- DYNAMIC:   entropy-adaptive top-k: peaked rows keep few keys, diffuse rows
             many, chosen by probability rank with static shapes.

Every function works on the last axis (keys) of an arbitrarily batched
tensor. DYNAMIC ranks with a stable descending sort, the order of the
reference's ``jnp.argsort(..., descending=True)``.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class AttentionSparsityMode(str, enum.Enum):
    NONE = "none"
    TOP_K = "top_k"
    THRESHOLD = "threshold"
    WINDOW = "window"
    DYNAMIC = "dynamic"


@dataclasses.dataclass(frozen=True)
class AttentionSparsityConfig:
    """Static attention-sparsity policy.

    top_k: keys kept per query (TOP_K mode).
    threshold: post-softmax probability floor (THRESHOLD mode).
    window_size / global_tokens / stride: WINDOW mode geometry: keep keys
        within ``window_size`` of the query, the first ``global_tokens`` keys,
        and every ``stride``-th key (stride=0 disables striding).
    min_keep_frac / max_keep_frac: DYNAMIC mode entropy -> keep range.
    """

    mode: AttentionSparsityMode = AttentionSparsityMode.NONE
    top_k: int = 64
    threshold: float = 1e-3
    window_size: int = 256
    global_tokens: int = 1
    stride: int = 64
    min_keep_frac: float = 0.1
    max_keep_frac: float = 0.5


def create_window_mask(
    q_pos: torch.Tensor,  # [...] absolute query positions (int)
    num_keys: int,
    window_size: int,
    global_tokens: int = 1,
    stride: int = 0,
) -> torch.Tensor:
    """Boolean [..., num_keys] mask, True = key visible (key index = absolute
    position, a contiguous cache): causal, and within the window, among the
    global prefix or on the stride."""
    key_idx = torch.arange(num_keys, device=q_pos.device).reshape(
        (1,) * q_pos.dim() + (num_keys,))
    qp = q_pos[..., None]
    keep = (key_idx >= qp - (window_size - 1)) | (key_idx < global_tokens)
    if stride and stride > 0:
        keep = keep | (key_idx % stride == 0)
    return (key_idx <= qp) & keep


def _renormalized(kept: torch.Tensor, dtype) -> torch.Tensor:
    total = kept.sum(dim=-1, keepdim=True)
    return (kept / total.clamp_min(1e-9)).to(dtype)


def apply_top_k_attention(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest weights per query (last axis), renormalize."""
    if k >= probs.shape[-1]:
        return probs
    pf = probs.float()
    kth = torch.topk(pf, k, dim=-1).values[..., -1:]
    return _renormalized(torch.where(pf >= kth, pf, 0.0), probs.dtype)


def apply_threshold_attention(probs: torch.Tensor, threshold: float) -> torch.Tensor:
    """Zero weights below the probability floor, renormalize; each row keeps
    its maximum, so no row becomes all-zero."""
    pf = probs.float()
    row_max = pf.amax(dim=-1, keepdim=True)
    return _renormalized(torch.where((pf >= threshold) | (pf >= row_max), pf, 0.0),
                         probs.dtype)


def apply_dynamic_attention(
    probs: torch.Tensor,
    min_keep_frac: float = 0.1,
    max_keep_frac: float = 0.5,
) -> torch.Tensor:
    """Entropy-adaptive top-k with static shapes: a row's normalized entropy
    e in [0, 1] maps linearly to a keep fraction in [min, max], and keys are
    kept by probability rank."""
    n = probs.shape[-1]
    pf = probs.float()
    ent = -(pf * torch.log(pf.clamp_min(1e-12))).sum(dim=-1, keepdim=True)
    # the f32 log of n, as jnp.log(float(n))
    ent_norm = ent / torch.log(torch.tensor(float(n), dtype=torch.float32, device=pf.device))
    keep_frac = min_keep_frac + (max_keep_frac - min_keep_frac) * ent_norm
    keep_k = torch.clamp(torch.round(keep_frac * n), 1, n)
    order = torch.argsort(pf, dim=-1, descending=True, stable=True)  # rank 0 = largest
    ranks = torch.argsort(order, dim=-1, stable=True).float()
    return _renormalized(torch.where(ranks < keep_k, pf, 0.0), probs.dtype)


def apply_attention_sparsity(probs: torch.Tensor, cfg: AttentionSparsityConfig) -> torch.Tensor:
    """Post-softmax dispatcher. WINDOW acts before the softmax (the caller
    masks the scores with ``create_window_mask``), so it returns ``probs``."""
    mode = AttentionSparsityMode(cfg.mode)
    if mode in (AttentionSparsityMode.NONE, AttentionSparsityMode.WINDOW):
        return probs
    if mode == AttentionSparsityMode.TOP_K:
        return apply_top_k_attention(probs, cfg.top_k)
    if mode == AttentionSparsityMode.THRESHOLD:
        return apply_threshold_attention(probs, cfg.threshold)
    if mode == AttentionSparsityMode.DYNAMIC:
        return apply_dynamic_attention(probs, cfg.min_keep_frac, cfg.max_keep_frac)
    raise ValueError(f"unknown attention sparsity mode: {cfg.mode}")


def attention_sparsity_ratio(probs: torch.Tensor) -> torch.Tensor:
    """Fraction of zeroed attention weights (0-d f32 tensor): the count times
    the f32 reciprocal of the size, the product XLA makes of the reference's
    mean."""
    return (probs == 0).sum(dtype=torch.float32) * (1.0 / probs.numel())
