"""Sampling: greedy / temperature / top-k / top-p / min-p / typical / tail-free,
penalties and logit bias (PyTorch port).

Counterpart of ``wrinklefree_tpu/ops/sampling.py``. Logits, token rings and
lengths are device tensors; the per-row sampler settings are host arrays
(numpy or lists), as the engine holds them, so the branches the reference
takes with ``lax.cond`` (skip a filter no row uses, skip sampling when every
row is greedy) are decided on the host without reading the device. The
reference's per-request PRNG keys become one ``torch.Generator`` per row,
seeded per request; a greedy row draws nothing. Mirostat is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

NEG_INF = float("-inf")


def _rows(x, b: int, dtype) -> np.ndarray:
    return np.broadcast_to(np.asarray(x, dtype=dtype), (b,))


def _dev(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=like.device)


def apply_top_k(logits: torch.Tensor, k) -> torch.Tensor:
    """Mask all but the top-k logits per row (k per row, or a scalar)."""
    vocab = logits.shape[-1]
    kk = _dev(_rows(k, logits.shape[0], np.int64), logits)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    kth = sorted_logits.gather(-1, torch.clamp(kk - 1, 0, vocab - 1)[:, None])
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set with cumulative prob > p
    (position i is kept while the cumulative prob before it is <= p)."""
    tp = _dev(_rows(top_p, logits.shape[0], np.float32), logits)
    sort_idx = torch.argsort(logits, dim=-1, descending=True)
    sorted_logits = logits.gather(-1, sort_idx)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) <= tp[:, None]
    keep[:, 0] = True
    masked = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, NEG_INF))
    inv = torch.argsort(sort_idx, dim=-1)
    return masked.gather(-1, inv)


def apply_penalties(
    logits: torch.Tensor,  # [B, V] float32
    ring: torch.Tensor,  # [B, W] token at seq position p at ring[b, p % W]; -1 = unset
    seq_lens: torch.Tensor,  # [B] tokens so far (next position index)
    last_n,  # [B] penalty window (<= W), host
    rep,  # [B] repetition penalty (1.0 = off), host
    pres,  # [B] presence penalty (0.0 = off), host
    freq,  # [B] frequency penalty (0.0 = off), host
) -> torch.Tensor:
    """Repetition / presence / frequency penalties over a rolling window,
    llama.cpp semantics: tokens seen in the last ``last_n`` positions have
    positive logits divided by ``rep`` and negative ones multiplied;
    ``pres``/``freq`` subtract pres*[count>0] + freq*count. Skipped when
    every row is at the identity defaults."""
    B, V = logits.shape
    rep = _rows(rep, B, np.float32)
    pres = _rows(pres, B, np.float32)
    freq = _rows(freq, B, np.float32)
    if not np.any((rep != 1.0) | (pres != 0.0) | (freq != 0.0)):
        return logits
    W = ring.shape[1]
    dev = logits.device
    sl = seq_lens.to(torch.int64)[:, None]
    ln = _dev(_rows(last_n, B, np.int64), logits)[:, None]
    j = torch.arange(W, device=dev)[None, :]
    # seq position held by ring slot j: the largest p <= seq_len-1 with p % W == j
    d = torch.remainder(sl - 1 - j, W)
    p = sl - 1 - d
    valid = (p >= 0) & (p >= sl - ln)
    ids = torch.where(valid & (ring >= 0), ring.to(torch.int64), torch.full_like(p, V))
    cnt = torch.zeros((B, V + 1), dtype=torch.float32, device=dev)
    cnt.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.float32))
    cnt = cnt[:, :V]
    present = cnt > 0
    r = _dev(rep, logits)[:, None]
    rp = torch.where(logits > 0, logits / r, logits * r)
    out = torch.where(present, rp, logits)
    return out - _dev(freq, logits)[:, None] * cnt - _dev(pres, logits)[:, None] * present.float()


def apply_logit_bias(
    logits: torch.Tensor,  # [B, V] float32
    bias_ids,  # [B, K] token ids; -1 = empty slot, host
    bias_vals,  # [B, K] additive bias, host
) -> torch.Tensor:
    """Per-request additive logit bias (OpenAI/llama.cpp ``logit_bias``);
    skipped when no row carries a bias."""
    B, V = logits.shape
    bias_ids = np.asarray(bias_ids, dtype=np.int64).reshape(B, -1)
    if not np.any(bias_ids >= 0):
        return logits
    ids = _dev(np.where(bias_ids >= 0, bias_ids, V), logits)
    vals = _dev(np.asarray(bias_vals, dtype=np.float32).reshape(B, -1), logits)
    add = torch.zeros((B, V + 1), dtype=torch.float32, device=logits.device)
    add.scatter_add_(1, ids, vals)
    return logits + add[:, :V]


def _tail_free(vals: torch.Tensor, tfs_z: torch.Tensor) -> torch.Tensor:
    # llama.cpp tail-free: candidate i (of the first c-2, which have a second
    # derivative) survives iff the inclusive cumsum of normalized |p''| through
    # i is <= z; the last two survive only when no prefix exceeded z;
    # position 0 always survives
    p = torch.softmax(vals, dim=-1)
    d2 = torch.abs(p[:, :-2] - 2 * p[:, 1:-1] + p[:, 2:])
    d2 = d2 / torch.clamp_min(d2.sum(dim=-1, keepdim=True), 1e-9)
    cum = torch.cumsum(d2, dim=-1)
    keep2 = cum <= tfs_z[:, None]
    tail = keep2[:, -1:]
    keep = torch.cat([keep2, tail, tail], dim=1)
    keep[:, 0] = True
    return torch.where(keep | (tfs_z >= 1.0)[:, None], vals, torch.full_like(vals, NEG_INF))


def _typical(vals: torch.Tensor, typical_p: torch.Tensor) -> torch.Tensor:
    # llama.cpp locally-typical: keep the tokens closest to the entropy, the
    # smallest set with cumulative prob >= typical_p
    lp = torch.log_softmax(vals, dim=-1)
    p = torch.exp(lp)
    ent = -torch.where(p > 0, p * lp, torch.zeros_like(p)).sum(dim=-1, keepdim=True)
    dev_ = torch.abs(-lp - ent)
    order = torch.argsort(dev_, dim=-1, stable=True)
    p_sorted = p.gather(-1, order)
    cum = torch.cumsum(p_sorted, dim=-1)
    keep_sorted = (cum - p_sorted) < typical_p[:, None]
    keep_sorted[:, 0] = True
    inv = torch.argsort(order, dim=-1)
    keep = keep_sorted.gather(-1, inv)
    return torch.where(keep | (typical_p >= 1.0)[:, None], vals, torch.full_like(vals, NEG_INF))


def sample_token(
    logits: torch.Tensor,  # [B, V] float32
    generators: Optional[Sequence[Optional[torch.Generator]]] = None,
    temperature=0.0,
    top_p=1.0,
    top_k=0,
    min_p=0.0,
    typical_p=1.0,
    tfs_z=1.0,
    nucleus_candidates: int = 256,
) -> torch.Tensor:
    """Next token ids [B] int32. Sampler settings are scalars or per-row
    host arrays; temperature == 0 rows decode greedily; top_k == 0, min_p ==
    0 and typical_p/tfs_z == 1 are identities. Filter order: top_k -> tfs ->
    typical -> min_p -> top_p, over the ``nucleus_candidates`` largest
    logits. A sampling row draws Gumbel noise from its own generator."""
    B, V = logits.shape
    temperature = _rows(temperature, B, np.float32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampling = temperature > 0
    if not np.any(sampling):
        return greedy
    if generators is None or any(
        generators[b] is None for b in range(B) if sampling[b]
    ):
        raise ValueError("every sampling row needs a torch.Generator")
    top_p = _dev(_rows(top_p, B, np.float32), logits)
    top_k = _rows(top_k, B, np.int64)
    min_p = _rows(min_p, B, np.float32)
    typical_p = _rows(typical_p, B, np.float32)
    tfs_z = _rows(tfs_z, B, np.float32)

    safe_t = _dev(np.where(sampling, temperature, 1.0).astype(np.float32), logits)
    scaled = logits / safe_t[:, None]
    c = min(nucleus_candidates, V)
    vals, idx = torch.topk(scaled, c, dim=-1)  # [B, c] descending
    k_eff = _dev(np.where(top_k > 0, np.minimum(top_k, c), c), logits)
    ar = torch.arange(c, device=logits.device)[None, :]
    vals = torch.where(ar < k_eff[:, None], vals, torch.full_like(vals, NEG_INF))
    if np.any(tfs_z < 1.0):
        vals = _tail_free(vals, _dev(tfs_z, logits))
    if np.any(typical_p < 1.0):
        vals = _typical(vals, _dev(typical_p, logits))
    # min_p: p_i/p_max >= min_p  <=>  v_i - v_max >= log(min_p), v_max over
    # the surviving candidates
    vmax = vals.max(dim=-1, keepdim=True).values
    log_mp = _dev(np.log(np.maximum(min_p, 1e-38)).astype(np.float32), logits)
    keep_mp = (vals - vmax) >= log_mp[:, None]
    vals = torch.where(keep_mp | _dev(min_p <= 0.0, logits)[:, None], vals,
                       torch.full_like(vals, NEG_INF))
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) <= top_p[:, None]
    keep[:, 0] = True
    masked = torch.where(keep, vals, torch.full_like(vals, NEG_INF))
    noise = torch.zeros_like(masked)
    for b in range(B):
        if sampling[b]:
            u = torch.rand((c,), generator=generators[b], device=logits.device)
            noise[b] = -torch.log(-torch.log(torch.clamp_min(u, 1e-20)))
    choice = torch.argmax(masked + noise, dim=-1)
    sampled = idx.gather(1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(_dev(sampling, logits), sampled, greedy)
