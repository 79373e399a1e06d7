"""Request-level preemption snapshot/restore (host side; PyTorch port).

The port of ``wrinklefree_tpu/engine/snapshot.py``. KV is treated as a
recomputable cache: a snapshot captures request state (prompt, emitted
tokens, sampling settings, RNG counters; no tensors) and restore
re-prefills, continuing each stream exactly, seeded sampling included.
The snapshot dict is the reference's, so either package restores the
other's.
"""

from __future__ import annotations

from typing import List

from .constrained import make_validator
from .sampling_params import SamplingParams


def snapshot(eng) -> dict:
    """Preemption-safe state capture, designed fresh (the reference
    has no elastic recovery — SURVEY.md §5.3).

    Key design point: KV pools are RECOMPUTABLE caches of the token
    stream, so the snapshot is request-level and tiny (token ids +
    sampling state, no tensors). `restore()` re-prefills
    prompt+generated-so-far — the radix cache recovers shared
    prefixes — and the per-request RNG counter offset keeps sampled
    continuations on the same stream as an uninterrupted run.
    """
    with eng._lock:
        eng._drain_waiting()
        reqs = []
        live = [s for s in eng.slots if s is not None] + eng._backlog
        for r in live:
            if r.finished:
                continue
            s = r.sampling
            reqs.append({
                "prompt_ids": list(r.prompt_ids),
                "output_ids": list(r.output_ids),
                "counter_base": r.counter_base + len(r.output_ids),
                "seed": int(r.seed),
                "max_new_tokens": s.max_new_tokens - len(r.output_ids),
                "temperature": s.temperature,
                "top_p": s.top_p,
                "top_k": s.top_k,
                "min_p": s.min_p,
                "typical_p": s.typical_p,
                "tfs_z": s.tfs_z,
                "mirostat": s.mirostat,
                "mirostat_tau": s.mirostat_tau,
                "mirostat_eta": s.mirostat_eta,
                "stop_token_ids": list(s.stop_token_ids or []),
                "ignore_eos": s.ignore_eos,
                "repetition_penalty": s.repetition_penalty,
                "presence_penalty": s.presence_penalty,
                "frequency_penalty": s.frequency_penalty,
                "penalty_last_n": s.penalty_last_n,
                "logprobs_k": s.logprobs_k,
                "logit_bias": [
                    [int(t), float(b)] for t, b in (s.logit_bias or [])
                ],
                "json_mode": s.json_mode,
                "grammar": s.grammar,
            })
        return {"version": 1, "requests": reqs}

def restore(eng, snap: dict, on_token_factory=None) -> List:
    """Resubmit every in-flight request from a `snapshot()`. Each
    restored request's prompt is original-prompt + generated-so-far;
    `on_token_factory(entry) -> callback` re-attaches streaming."""
    if snap.get("version") != 1:
        raise ValueError(f"unknown snapshot version: {snap.get('version')}")
    entries = []
    for d in snap["requests"]:
        sp = SamplingParams(
            temperature=d["temperature"], top_p=d["top_p"],
            top_k=d["top_k"], min_p=d.get("min_p", 0.0),
            typical_p=d.get("typical_p", 1.0),
            tfs_z=d.get("tfs_z", 1.0),
            mirostat=d.get("mirostat", 0),
            mirostat_tau=d.get("mirostat_tau", 5.0),
            mirostat_eta=d.get("mirostat_eta", 0.1),
            max_new_tokens=d["max_new_tokens"],
            stop_token_ids=d["stop_token_ids"] or None,
            ignore_eos=d["ignore_eos"], seed=d["seed"],
            repetition_penalty=d.get("repetition_penalty", 1.0),
            presence_penalty=d.get("presence_penalty", 0.0),
            frequency_penalty=d.get("frequency_penalty", 0.0),
            penalty_last_n=d.get("penalty_last_n", 64),
            logprobs_k=d.get("logprobs_k", 0),
            logit_bias=[
                (int(t), float(b)) for t, b in d.get("logit_bias", [])
            ] or None,
            json_mode=d.get("json_mode", False),
            grammar=d.get("grammar"),
        )
        entries.append((d, sp))
    # atomic: validate EVERY entry before submitting any, so a bad
    # snapshot can't leave a partial restore running
    for d, sp in entries:
        eng._validate_submit(d["prompt_ids"] + d["output_ids"], sp)
    out = []
    for d, sp in entries:
        cb = on_token_factory(d) if on_token_factory else None
        # counter_base and the replayed validator are set before the request
        # is queued: a scheduler thread may admit it at once
        r = eng._new_request(d["prompt_ids"] + d["output_ids"], sp, cb)
        r.counter_base = d["counter_base"]
        dead = False
        if sp.constrained:
            # the generated-so-far text is part of the restored
            # prompt: replay it through a fresh validator
            r.grammar = make_validator(eng, sp)
            r.replayed = list(d["output_ids"])
            try:
                for t in d["output_ids"]:
                    r.grammar.advance(eng.token_pieces[t])
            except ValueError:
                # grammar blow-up on replay: end this request
                # cleanly instead of aborting the whole restore
                dead = True
        eng._enqueue(r)
        if dead:
            eng.cancel(r, "stop")
        out.append(r)
    return out
