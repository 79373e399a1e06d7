"""Serving programs: decode bursts and prefills (PyTorch port).

Counterpart of ``wrinklefree_tpu/engine/programs.py``. The reference's
``lax.scan`` over K = ``decode_burst`` steps becomes a Python loop over
device tensors: every step's inputs (last token, lengths, penalty ring) stay
on the device, the sampler settings are host arrays fixed for the burst, and
the host reads the sampled tokens once per burst. Nothing in the loop reads
the device (no ``.item()``), so the steps queue back to back on the stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kv.paged import paged_forward
from ..models.bitnet import compute_logits, exact_topk_shortlist, full_head_argmax
from ..models.spec_decode import _accepted, _draft_ngram, _record
from ..ops.sampling import (
    NUCLEUS_CANDIDATES,
    apply_logit_bias,
    apply_penalties,
    gumbel,
    per_request_keys,
    sample_token,
    sample_token_mirostat,
    token_logprobs,
)


def _penalised(logits, ring, n_tokens, samp):
    return apply_logit_bias(
        apply_penalties(logits, ring, n_tokens, samp["lastn"], samp["reps"],
                        samp["pres"], samp["freqs"]),
        samp["bias_ids"], samp["bias_vals"],
    )


def _sampler_kw(samp):
    return dict(temperature=samp["temps"], top_p=samp["tps"], top_k=samp["topks"],
                min_p=samp["minps"], typical_p=samp["typps"], tfs_z=samp["tfs"])


def _host(*tensors):
    """The tensors as numpy arrays: the program's one host read."""
    return tuple(t.cpu().numpy() for t in tensors)


def _clean_head(params):
    """params without the int8 head: ``compute_logits`` takes the bf16 one."""
    return {k: v for k, v in params.items() if not k.startswith("lm_head_")}


def _needs_distribution(samp) -> bool:
    """Whether some row of a burst samples, penalises or biases: decided on
    the host from the burst's fixed sampler arrays (the reference's
    ``lax.cond`` predicate in its exact-head burst)."""
    return bool(np.any(np.asarray(samp["temps"]) > 0)
                or np.any(np.asarray(samp["reps"]) != 1.0)
                or np.any(np.asarray(samp["pres"]) != 0.0)
                or np.any(np.asarray(samp["freqs"]) != 0.0)
                or np.any(np.asarray(samp["bias_ids"]) >= 0))


def build_decode(eng, burst_steps: int | None = None, with_logprobs: bool = False,
                 return_logits: bool = False, with_mirostat: bool = False):
    """K-step decode burst: K tokens per slot per call, one host read.

    ``burst(pools, last_tokens, page_table, seq_lens, seeds, counters,
    slot_ids, ring, samp[, mu])`` takes device tensors for the per-slot state
    and host arrays in ``samp``; returns ``(outs, pools, last, seq_lens,
    counters, ring[, mu])`` with the state tensors advanced on the device
    (``counters`` by one per step, as the reference's ``ctr + 1``). Step k
    of a sampling row draws the Gumbel noise of ``fold_in(PRNGKey(seed),
    counter + k)``; the burst draws all K steps' noise in one call before
    its first step.

    ``outs`` is the tokens [K, S] (numpy); with ``with_logprobs`` also the
    chosen tokens' logprobs [K, S] and the top-``logprobs_top`` ids and
    logprobs [K, S, N] of the penalised, pre-temperature distribution. With
    ``return_logits`` the burst is one step that also returns the
    post-penalty logits [1, S, V], left on the device (the host re-selects a
    constrained row's token from its row). ``with_mirostat`` carries the
    mirostat state ``mu`` [S] through the steps (``sample_token_mirostat``).

    Heads, as the reference's: under ``int8_logits`` every variant samples
    from the int8 head. Under ``exact_head_k`` the logprobs and full-logits
    variants take the clean bf16 head; the mirostat-only variant keeps the
    int8 one (the reference strips it only for ``lp_n or return_logits``);
    and the plain burst takes the final hidden state from ``paged_forward``
    and picks the head per burst: where some row samples, penalises or
    biases (a host decision on the burst's fixed ``samp`` arrays), the clean
    bf16 head with penalties and bias; otherwise the exact greedy head, the
    shortlist and the full head's argmax both computed every step and the
    certified rows' shortlist winner taken (``torch.where``), so the burst
    keeps its one host read. ``eng.exact_fallbacks`` (a device tensor)
    counts the steps whose certificate failed."""
    cfg = eng.cfg
    K = 1 if return_logits else (burst_steps or eng.ecfg.decode_burst)
    fd = eng.ecfg.flash_decode
    lp_n = eng.ecfg.logprobs_top if with_logprobs else 0
    ek = 0 if (with_logprobs or return_logits or with_mirostat) else eng.ecfg.exact_head_k
    params = eng.params
    if (lp_n or return_logits) and eng.ecfg.exact_head_k:
        params = _clean_head(params)  # a distribution needs the bf16 head
    clean = _clean_head(params)

    def burst(pools, last_tokens, page_table, seq_lens, seeds, counters, slot_ids, ring, samp,
              mu=None):
        W = ring.shape[1]
        dev = last_tokens.device
        rows = torch.arange(last_tokens.shape[0], device=dev)
        tok, sl, ctr = last_tokens, seq_lens, counters
        ones = torch.ones_like(sl)
        noise = None
        if np.any(np.asarray(samp["temps"]) > 0):
            steps = torch.arange(K, device=dev)[:, None]
            noise = gumbel(per_request_keys(seeds[None, :], ctr[None, :] + steps),
                           min(NUCLEUS_CANDIDATES, cfg.vocab_size))  # [K, S, c]
        kw = _sampler_kw(samp)
        exact = ek and not _needs_distribution(samp)
        outs, lps = [], []
        for k in range(K):
            # the token being fed sits at position sl: it is part of the
            # penalty window for the token sampled this step
            ring[rows, (sl % W).long()] = tok
            out, pools = paged_forward(
                params, cfg, tok[:, None], pools, page_table, sl, ones,
                linear_fn=eng._linear_fn, attention_fn=eng._attention_fn,
                slot_ids=slot_ids, flash_decode=fd,
                head_fn=(lambda h, p: h) if ek else None,
            )
            nz = None if noise is None else noise[k]
            if exact:
                minid, certified = exact_topk_shortlist(out, params, cfg, k=ek)
                tok = torch.where(certified, minid, full_head_argmax(out, params, cfg))
                eng.exact_fallbacks += ~certified
            else:
                if ek:  # the hidden state through the clean bf16 head
                    out = compute_logits(out, clean, cfg)
                pen = _penalised(out, ring, sl + 1, samp)
                if with_mirostat:
                    tok, mu = sample_token_mirostat(pen, nz, mu, miro=samp["miro"],
                                                    tau=samp["mtau"], eta=samp["meta"], **kw)
                else:
                    tok = sample_token(pen, nz, **kw)
            outs.append(tok)
            if lp_n:
                lps.append(token_logprobs(pen, tok, lp_n))
            sl = sl + 1
            ctr = ctr + 1
        toks = torch.stack(outs)
        if lp_n:
            out = _host(toks, *(torch.stack(x) for x in zip(*lps)))
        elif return_logits:
            out = (toks.cpu().numpy(), pen[None])
        else:
            out = toks.cpu().numpy()  # the burst's one host read
        if with_mirostat:
            return out, pools, tok, sl, ctr, ring, mu
        return out, pools, tok, sl, ctr, ring

    return burst


def build_decode_spec(eng):
    """Speculative decode burst (greedy rows only): K = ``decode_burst``
    steps, each drafting up to k = ``speculative_k`` tokens per slot by
    n-gram lookup in the device history ``hist`` [S, H], verifying them in
    one k+1-token ``paged_forward(..., logits_all=True)`` and advancing by
    the accepted count + 1. A step's window is clamped to the slot's current
    page (win = min(k+1, ps - sl % ps)), so a rejected draft's KV row lands
    in that page past the sequence (overwritten before it is visible) or in
    the trash; a page flushed with such rows is flushed again when the
    sequence completes it.

    ``burst(pools, last_tokens, page_table, seq_lens, slot_ids, hist)`` ->
    ``((tokens [K, S, k+1], counts [K, S]), pools, last, seq_lens, hist)``:
    tokens and counts on the host (the burst's one read), the rest advanced
    on the device (``hist`` in place). Step s emits tokens[s, b, :counts[s,
    b]]. Heads, as the reference's: under ``exact_head_k`` the verify takes
    the clean bf16 head (its greedy tokens are the exact head's); under
    ``int8_logits`` the int8 head."""
    cfg = eng.cfg
    K = eng.ecfg.decode_burst
    k = eng.ecfg.speculative_k
    ps = eng.page_size
    params = _clean_head(eng.params) if eng.ecfg.exact_head_k else eng.params

    def burst(pools, last_tokens, page_table, seq_lens, slot_ids, hist):
        tok, sl = last_tokens, seq_lens
        outs, counts = [], []
        for _ in range(K):
            win = torch.clamp(ps - sl % ps, max=k + 1).to(torch.int32)
            draft = _draft_ngram(hist, sl, k, 2)
            logits, pools = paged_forward(
                params, cfg, torch.cat([tok[:, None], draft], dim=1), pools, page_table, sl,
                win, linear_fn=eng._linear_fn, attention_fn=eng._attention_fn,
                slot_ids=slot_ids, logits_all=True,
            )
            g = torch.argmax(logits, dim=-1).to(torch.int32)  # [S, k+1]
            n_new = torch.minimum(_accepted(draft, g, win - 1) + 1, win)
            _record(hist, sl, g)
            tok = g.gather(1, (n_new - 1).long()[:, None])[:, 0]
            sl = sl + n_new
            outs.append(g)
            counts.append(n_new)
        # the burst's one host read
        flat = torch.cat([torch.stack(outs).flatten(), torch.stack(counts).flatten()]).cpu()
        n = K * tok.shape[0] * (k + 1)
        toks = flat[:n].numpy().reshape(K, -1, k + 1)
        return (toks, flat[n:].numpy().reshape(K, -1)), pools, tok, sl, hist

    return burst


def prefill_for_bucket(eng, bucket: int, with_logprobs: bool = False,
                       return_logits: bool = False):
    """Prefill of one ``bucket``-token chunk per row; samples the next token
    of every row (used for rows whose prompt this chunk completes) from the
    keys ``fold_in(PRNGKey(seed), counter)``. ``prefill(pools, tokens,
    page_table, seq_len, new_len, seeds, counters, slot_ids, ring, samp)`` ->
    ``(out, pools)``: ``out`` is the next tokens [B] (numpy); with
    ``with_logprobs`` also their logprobs [B] and the top-N ids and logprobs
    [B, N]; with ``return_logits`` the tokens and the post-penalty logits
    [B, V] on the device (a constrained row's first token is re-selected on
    the host). Under ``exact_head_k`` every prefill takes the clean bf16
    head (the reference's choice: its cost is small beside the chunk's);
    under ``int8_logits`` the int8 one."""
    cfg = eng.cfg
    lp_n = eng.ecfg.logprobs_top if with_logprobs else 0
    params = _clean_head(eng.params) if eng.ecfg.exact_head_k else eng.params

    def prefill(pools, tokens, page_table, seq_len, new_len, seeds, counters, slot_ids, ring,
                samp):
        if tokens.shape[1] != bucket:
            raise ValueError(f"chunk of {tokens.shape[1]} tokens in the {bucket} bucket")
        logits, pools = paged_forward(
            params, cfg, tokens, pools, page_table, seq_len, new_len,
            linear_fn=eng._linear_fn, attention_fn=eng._attention_fn, slot_ids=slot_ids,
        )
        pen = _penalised(logits, ring, seq_len + new_len, samp)
        noise = None
        if np.any(np.asarray(samp["temps"]) > 0):
            noise = gumbel(per_request_keys(seeds, counters),
                           min(NUCLEUS_CANDIDATES, cfg.vocab_size))
        nxt = sample_token(pen, noise, **_sampler_kw(samp))
        if lp_n:
            return _host(nxt, *token_logprobs(pen, nxt, lp_n)), pools
        if return_logits:
            return (nxt.cpu().numpy(), pen), pools
        return nxt.cpu().numpy(), pools

    return prefill


def warmup(eng):
    """Run the serving programs once ahead of the first request, as the
    reference's ``warmup`` compiles them: build the kernels, then run the
    decode burst (K = ``decode_burst``, page-table width 8) and every
    prefill bucket (batch 1, the fresh request's table width) on zero
    tokens. Eager programs take any table width or burst length with no
    further build, so one run of each is the whole warmup. The programs run
    on scratch pools, so the engine's pools, radix cache, allocator and
    stats are left as they were. Returns {program: seconds}."""
    import time

    dev = eng.device
    if dev.type == "cuda":
        from ..ops import cuda_lib

        cuda_lib.library()
    S = len(eng.slots)
    W = eng.ecfg.penalty_window
    K = eng.ecfg.decode_burst
    samp = eng._samp_arrays
    buckets = eng.ecfg.prefill_buckets
    widths = {8} | {eng._pages_bucket(b + 1) for b in buckets}
    scratch = eng._zero_pools(max(widths) + 1)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    def table(B, mp):
        return t(np.tile(np.arange(1, mp + 1), (B, 1)))

    timings = {}
    t0 = time.perf_counter()
    z = t(np.zeros(S))
    eng._decode_fn(K)(scratch, z, table(S, 8), z, z.long(), z.long(), t(np.arange(S)),
                      t(np.full((S, W), -1)), samp(S))
    timings[f"decode_burst[K={K}]"] = time.perf_counter() - t0
    for bucket in buckets:
        t0 = time.perf_counter()
        eng._prefill_fn(bucket)(
            scratch, t(np.zeros((1, bucket))), table(1, eng._pages_bucket(bucket + 1)),
            t(np.zeros(1)), t(np.full(1, bucket)), t(np.zeros(1)).long(), t(np.zeros(1)).long(),
            t(np.zeros(1)), t(np.full((1, W), -1)), samp(1))
        timings[f"prefill[{bucket}]"] = time.perf_counter() - t0
    return timings
