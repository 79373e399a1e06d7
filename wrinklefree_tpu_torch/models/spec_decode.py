"""Speculative decoding with n-gram (prompt-lookup) drafts (PyTorch port).

Counterpart of ``wrinklefree_tpu/models/spec_decode.py``. Batch-1 decode
reads every weight once per step whatever the row count, so verifying k
draft tokens in one k+1-token forward costs little more than one token,
and every accepted draft is a token gained. The drafts come from the
sequence itself: the tokens that followed the most recent earlier
occurrence of the current n-gram. No draft model, no extra weights, and
the greedy output is the plain greedy output token for token: a draft is
emitted only where it equals the verifier's own argmax.

The reference's ``lax.scan`` over the window's steps is a Python loop over
device tensors here; nothing in it reads the device, so the steps queue
back to back and the caller's read of the tokens ends the window. Rejected
drafts leave stale KV rows at positions >= the sequence length; the next
step overwrites them before attention can see them (a query sees keys at
positions <= its own, and a step writes its keys before it attends).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import BitNetConfig
from .bitnet import KVCache, forward, resolve_device


def _draft_ngram(hist: torch.Tensor, seq_len: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Propose k tokens per row by n-gram lookup in ``hist`` [B, H] (int32;
    hist[b, p] = the token at position p, valid through index seq_len[b]).

    Finds the most recent position p < seq_len whose n-gram ending at p
    matches the one ending at seq_len, and returns hist[p+1 : p+1+k] (the
    start clipped to [0, H-k]). A row without a match gets tokens all the
    same; the verifier accepts none of them, which is a plain decode step.
    ``torch.roll`` wraps around, as ``jnp.roll``; the ``p - j >= 0`` mask
    removes the wrapped columns."""
    B, H = hist.shape
    dev = hist.device
    pos = torch.arange(H, device=dev)[None, :]
    sl = seq_len.long()[:, None]
    ok = torch.ones((B, H), dtype=torch.bool, device=dev)
    for j in range(n):
        # hist[p - j] must equal the j-th token back from the tail
        tail = hist.gather(1, torch.clamp(sl - j, 0, H - 1))  # [B, 1]
        ok = ok & (torch.roll(hist, j, dims=1) == tail) & (pos - j >= 0)
    # p is the match's END; it must end strictly before the tail
    ok = ok & (pos < sl)
    p_star = torch.where(ok, pos, torch.full_like(pos, -1)).amax(dim=1)  # [B], -1 = none
    start = torch.clamp(p_star + 1, 0, H - k)
    return hist.gather(1, start[:, None] + torch.arange(k, device=dev)[None, :])


def _accepted(draft: torch.Tensor, g: torch.Tensor, limit=None) -> torch.Tensor:
    """Accepted drafts per row [B]: the longest prefix of ``draft`` [B, k]
    equal to the verifier's greedy tokens ``g[:, :k]``, with ``limit`` [B]
    (when given) masking draft j >= limit."""
    match = draft == g[:, :-1]
    if limit is not None:
        match = match & (torch.arange(draft.shape[1], device=draft.device)[None, :]
                         < limit[:, None])
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def _record(hist: torch.Tensor, seq_len: torch.Tensor, g: torch.Tensor) -> None:
    """Write a step's greedy tokens g [B, k+1] into ``hist`` at positions
    seq_len+1 .. seq_len+k+1 (clipped to H-1), in place. Positions past the
    emitted count get tokens that drafting never reads before they are
    overwritten (drafting looks only at positions < the sequence length)."""
    B, H = hist.shape
    idx = seq_len.long()[:, None] + 1 + torch.arange(g.shape[1], device=hist.device)[None, :]
    rows = torch.arange(B, device=hist.device)[:, None].expand_as(idx)
    hist[rows, idx.clamp(0, H - 1)] = g


def spec_decode_window(
    params,
    cfg: BitNetConfig,
    last_tok: torch.Tensor,  # [B] int32: the last emitted token per row
    cache: KVCache,
    start: torch.Tensor,  # [B] int32: tokens already in the cache
    hist: torch.Tensor,  # [B, H] int32: the token at each sequence position
    *,
    steps: int,
    k: int = 4,
    ngram: int = 2,
    linear_fn=None,
    force_accept: Optional[int] = None,
):
    """Run ``steps`` speculative greedy decode steps over the contiguous
    cache: each drafts k tokens, verifies them in one ``forward(...,
    logits_all=True)`` of k+1 tokens, and advances by the accepted count + 1.

    Returns (tokens [steps, B, k+1], counts [steps, B], last_tok, cache,
    start, hist), all on the device; step s emits tokens[s, b, :counts[s, b]]
    for row b. The cache is written in place (the reference donates it);
    ``hist`` is copied first, so the caller's tensor is left as it was.

    ``force_accept``: for cost measurement only. It replaces the accepted
    count with min(force_accept, k) while running the same compute, so the
    speed at a chosen acceptance can be timed; the tokens are then no longer
    the greedy ones."""
    hist = hist.clone()
    last, sl = last_tok.to(torch.int32), start.to(torch.int32)
    toks, counts = [], []
    for _ in range(steps):
        draft = _draft_ngram(hist, sl, k, ngram)
        logits, cache = forward(params, cfg, torch.cat([last[:, None], draft], dim=1), cache,
                                sl, logits_all=True, linear_fn=linear_fn)
        g = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, k+1]
        acc = _accepted(draft, g)
        if force_accept is not None:
            acc = torch.full_like(acc, min(int(force_accept), k))
        _record(hist, sl, g)
        last = g.gather(1, acc.long()[:, None])[:, 0]
        sl = sl + acc + 1
        toks.append(g)
        counts.append(acc + 1)
    return torch.stack(toks), torch.stack(counts), last, cache, sl, hist


def generate_spec(
    params,
    cfg: BitNetConfig,
    prompt_ids,
    max_new_tokens: int = 32,
    max_len: Optional[int] = None,
    k: int = 4,
    ngram: int = 2,
    window: int = 8,
    linear_fn=None,
    device=None,
):
    """Greedy batch-1 generation with n-gram speculative decoding: the tokens
    of ``models.bitnet.generate(temperature=0)`` after the prompt, in windows
    of ``window`` steps with one host read each. ``device`` defaults to
    CUDA."""
    dev = resolve_device(device)
    P = len(prompt_ids)
    prompt = torch.as_tensor(np.asarray(prompt_ids, np.int64), device=dev)[None, :]
    budget = P + max_new_tokens + window * (k + 1) + 1
    T = max_len or min(cfg.max_position, budget)
    cache = KVCache.zeros(cfg, 1, T, device=dev)
    logits, cache = forward(params, cfg, prompt, cache,
                            torch.zeros(1, dtype=torch.int32, device=dev), logits_all=False,
                            linear_fn=linear_fn)
    last = torch.argmax(logits, dim=-1).to(torch.int32).reshape(1)
    hist = torch.zeros((1, T), dtype=torch.int32, device=dev)
    hist[0, :P] = prompt[0].to(torch.int32)
    hist[0, P] = last[0]
    start = torch.full((1,), P, dtype=torch.int32, device=dev)

    out = [int(last[0])]
    while len(out) < max_new_tokens:
        toks, counts, last, cache, start, hist = spec_decode_window(
            params, cfg, last, cache, start, hist, steps=window, k=k, ngram=ngram,
            linear_fn=linear_fn)
        toks_np, counts_np = toks.cpu().numpy(), counts.cpu().numpy()
        for s in range(toks_np.shape[0]):
            out.extend(int(t) for t in toks_np[s, 0, :int(counts_np[s, 0])])
            if len(out) >= max_new_tokens:
                break
        if int(start[0]) + window * (k + 1) + 1 >= T:
            break
    return out[:max_new_tokens]
