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
from ..ops.sampling import apply_logit_bias, apply_penalties, sample_token


def _sample(logits, ring, n_tokens, samp, gens):
    pen = apply_logit_bias(
        apply_penalties(logits, ring, n_tokens, samp["lastn"], samp["reps"],
                        samp["pres"], samp["freqs"]),
        samp["bias_ids"], samp["bias_vals"],
    )
    return sample_token(
        pen, gens, temperature=samp["temps"], top_p=samp["tps"], top_k=samp["topks"],
        min_p=samp["minps"], typical_p=samp["typps"], tfs_z=samp["tfs"],
    )


def build_decode(eng, burst_steps: int | None = None):
    """K-step decode burst: K tokens per slot per call, one host read.

    ``burst(pools, last_tokens, page_table, seq_lens, slot_ids, ring, samp,
    gens)`` takes device tensors for the per-slot state, host arrays in
    ``samp`` and one generator (or None) per slot; returns
    ``(tokens [K, S] numpy, pools, last, seq_lens, ring)`` with the state
    tensors advanced on the device."""
    cfg = eng.cfg
    K = burst_steps or eng.ecfg.decode_burst

    def burst(pools, last_tokens, page_table, seq_lens, slot_ids, ring, samp, gens):
        W = ring.shape[1]
        rows = torch.arange(last_tokens.shape[0], device=last_tokens.device)
        tok, sl = last_tokens, seq_lens
        ones = torch.ones_like(sl)
        outs = []
        for _ in range(K):
            # the token being fed sits at position sl: it is part of the
            # penalty window for the token sampled this step
            ring[rows, (sl % W).long()] = tok
            logits, pools = paged_forward(
                eng.params, cfg, tok[:, None], pools, page_table, sl, ones,
                linear_fn=eng._linear_fn, attention_fn=eng._attention_fn,
                slot_ids=slot_ids,
            )
            tok = _sample(logits, ring, sl + 1, samp, gens)
            outs.append(tok)
            sl = sl + 1
        toks = torch.stack(outs).cpu().numpy()  # the burst's one host read
        return toks, pools, tok, sl, ring

    return burst


def prefill_for_bucket(eng, bucket: int):
    """Prefill of one ``bucket``-token chunk per row; samples the next token
    of every row (used for rows whose prompt this chunk completes).
    ``prefill(pools, tokens, page_table, seq_len, new_len, slot_ids, ring,
    samp, gens)`` -> ``(next tokens [B] numpy, pools)``."""
    cfg = eng.cfg

    def prefill(pools, tokens, page_table, seq_len, new_len, slot_ids, ring, samp, gens):
        if tokens.shape[1] != bucket:
            raise ValueError(f"chunk of {tokens.shape[1]} tokens in the {bucket} bucket")
        logits, pools = paged_forward(
            eng.params, cfg, tokens, pools, page_table, seq_len, new_len,
            linear_fn=eng._linear_fn, attention_fn=eng._attention_fn, slot_ids=slot_ids,
        )
        nxt = _sample(logits, ring, seq_len + new_len, samp, gens)
        return nxt.cpu().numpy().astype(np.int32), pools

    return prefill
