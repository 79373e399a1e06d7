"""Constrained-decoding host logic (JSON / GBNF re-selection; PyTorch port).

The port of ``wrinklefree_tpu/engine/constrained.py``: the full-logits
program returns the post-penalty logits of a constrained row; these helpers
re-select its token through a prefix validator with llama.cpp-equivalent
sampling semantics. The sampled preference order draws from numpy's
generator seeded ``(seed << 20) ^ (counter_base + #emitted)``, as the
reference's, so a constrained sampled token equals the reference's on equal
logits.
"""

from __future__ import annotations

import numpy as np

from .sampling_params import SamplingParams


def make_validator(eng, s: SamplingParams):
    if s.json_mode or not s.grammar:
        from .json_constraint import JsonPrefixValidator

        return JsonPrefixValidator()
    from .gbnf import GbnfValidator

    return GbnfValidator(s.grammar)

def select_constrained(eng, req, logits_row: np.ndarray):
    """Next token for a json_mode request from full post-penalty
    logits: walk candidates in preference order, accept the first
    whose decoded piece keeps the JSON-prefix validator alive.

    Greedy preference = descending logits (matches the device
    sampler exactly when the best token is legal). Sampled
    preference uses the gumbel-top-k trick: argsort of
    (logits/T + gumbel) yields a categorical draw followed by
    sampling-without-replacement from the renormalized remainder —
    exactly the llama.cpp resample-until-grammar-accepts semantics
    in one sort. Deterministic per (seed, step) numpy stream.

    Returns (token, status) with status "ok"/"complete", or
    (None, "dead") when no candidate is acceptable."""
    s = req.sampling
    pieces = eng.token_pieces
    lg = logits_row.astype(np.float64)
    V = lg.shape[0]
    g = None
    if s.temperature > 0:
        t = lg / s.temperature
        t_raw = t.copy()  # pre-filter scores for the dead-end fallback
        # top-k / tfs / typical / min_p / top-p masks
        # (device-sampler semantics and order)
        if s.top_k > 0:
            kth = np.partition(t, -s.top_k)[-s.top_k]
            t[t < kth] = -np.inf
        if s.tfs_z < 1.0:
            order0 = np.argsort(-t)
            p = np.exp(t[order0] - t[order0[0]])
            p /= p.sum()
            d2 = np.abs(p[:-2] - 2 * p[1:-1] + p[2:])
            d2 = d2 / max(d2.sum(), 1e-9)
            cum = np.cumsum(d2)  # inclusive (device-kernel rule)
            keep2 = cum <= s.tfs_z
            keep = np.concatenate([keep2, keep2[-1:], keep2[-1:]])
            keep[0] = True
            t[order0[~keep]] = -np.inf
        if s.typical_p < 1.0:
            finite = np.isfinite(t)
            lpv = np.full_like(t, -np.inf)
            m = t[finite].max()
            lse = m + np.log(np.exp(t[finite] - m).sum())
            lpv[finite] = t[finite] - lse
            pv = np.exp(lpv, where=finite, out=np.zeros_like(t))
            ent = -(pv[finite] * lpv[finite]).sum()
            dev = np.where(finite, np.abs(-lpv - ent), np.inf)
            order0 = np.argsort(dev)
            cum = np.cumsum(pv[order0])
            keep_n = max(1, int(np.searchsorted(cum, s.typical_p) + 1))
            t[order0[keep_n:]] = -np.inf
        if s.min_p > 0:
            t[t - t.max() < np.log(max(s.min_p, 1e-38))] = -np.inf
        if s.top_p < 1.0:
            order0 = np.argsort(-t)
            p = np.exp(t[order0] - t[order0[0]])
            p /= p.sum()
            cum = np.cumsum(p)
            drop = order0[1:][cum[:-1] > s.top_p]  # keep first always
            t[drop] = -np.inf
        rng = np.random.default_rng(
            (int(req.seed) << 20)
            ^ (req.counter_base + len(req.output_ids))
        )
        g = rng.gumbel(size=V)
        score = t + g
    else:
        score = lg
    eos = eng.eos_token_id

    def walk(order_scores):
        order = np.argsort(-order_scores)
        for tok in order[:4096]:
            if not np.isfinite(order_scores[tok]):
                break
            if (
                eos is not None and tok == eos
                and getattr(req.grammar, "completable", False)
                and not s.ignore_eos
            ):
                # GBNF: input fully matches root and the model
                # prefers EOS — accept it (llama.cpp: EOS legal when
                # a parse stack is empty)
                return int(tok), "complete"
            piece = pieces[tok]
            if not piece:  # specials decode to "" — never legal text
                continue
            cand = req.grammar.clone()
            try:
                r = cand.advance(piece)
            except ValueError:
                # grammar blow-up (GbnfError: stack explosion /
                # too-deep expansion) — treat as dead so the request
                # finishes instead of wedging the engine step loop
                continue
            if r != "dead":
                req.grammar = cand
                return int(tok), r
        return None, "dead"

    tok, r = walk(score)
    if tok is None and s.temperature > 0:
        # every nucleus/top-k candidate was grammar-illegal: fall
        # back to the UNFILTERED distribution (same temperature +
        # gumbel noise, so it is still a sample, not a deterministic
        # argmax) — llama.cpp's grammar resample never dead-ends
        # while a legal token exists
        tok, r = walk(t_raw + g)
    return tok, r

