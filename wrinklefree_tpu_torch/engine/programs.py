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
    fd = eng.ecfg.flash_decode

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
                slot_ids=slot_ids, flash_decode=fd,
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

    from ..kv.paged import PagedKV

    dev = eng.device
    if dev.type == "cuda":
        from ..ops import cuda_lib

        cuda_lib.library()
    S = len(eng.slots)
    W = eng.ecfg.penalty_window
    Kb = eng.ecfg.logit_bias_slots
    K = eng.ecfg.decode_burst
    buckets = eng.ecfg.prefill_buckets
    widths = {8} | {eng._pages_bucket(b + 1) for b in buckets}
    scratch = PagedKV.zeros_dual(eng.cfg, max(widths) + 1, eng.page_size, S,
                                 eng.ecfg.kv_dtype, device=dev)

    def samp(B):
        return {
            "temps": np.zeros((B,), np.float32), "tps": np.ones((B,), np.float32),
            "topks": np.zeros((B,), np.int32), "minps": np.zeros((B,), np.float32),
            "typps": np.ones((B,), np.float32), "tfs": np.ones((B,), np.float32),
            "reps": np.ones((B,), np.float32), "pres": np.zeros((B,), np.float32),
            "freqs": np.zeros((B,), np.float32), "lastn": np.zeros((B,), np.int32),
            "bias_ids": np.full((B, Kb), -1, np.int32),
            "bias_vals": np.zeros((B, Kb), np.float32),
        }

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    def table(B, mp):
        return t(np.tile(np.arange(1, mp + 1), (B, 1)))

    timings = {}
    t0 = time.perf_counter()
    eng._decode_fn(K)(scratch, t(np.zeros(S)), table(S, 8), t(np.zeros(S)), t(np.arange(S)),
                      t(np.full((S, W), -1)), samp(S), [None] * S)
    timings[f"decode_burst[K={K}]"] = time.perf_counter() - t0
    for bucket in buckets:
        t0 = time.perf_counter()
        eng._prefill_fn(bucket)(
            scratch, t(np.zeros((1, bucket))), table(1, eng._pages_bucket(bucket + 1)),
            t(np.zeros(1)), t(np.full(1, bucket)), t(np.zeros(1)), t(np.full((1, W), -1)),
            samp(1), [None])
        timings[f"prefill[{bucket}]"] = time.perf_counter() - t0
    return timings
