"""Request-level snapshot/restore in the port's Engine, on the CPU.

``Engine.snapshot`` captures each live or queued request (prompt, emitted
tokens, sampler settings, ``counter_base``; no tensors) and ``restore``
resubmits them: prompt + emitted tokens re-prefill and each request's draws
continue at ``counter_base``, a constrained request's validator replays its
emitted text. The port's snapshot dict equals the reference's for the same
state, a restore continues greedy, seeded, penalised, ``logit_bias``,
mirostat and constrained requests to the tokens of the uninterrupted run
(either package's snapshot restores into the port), and a bad snapshot
restores nothing. The comparisons with the reference run the reference's
tiny weights with the o and down projections set to ternary zeros, so both
packages compute the same logits up to f32 rounding and sampled streams
compare token for token; the restore is also held to the uninterrupted run
on the full tiny weights, where the logits depend on the whole history.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
from wrinklefree_tpu.engine import Engine as RefEngine
from wrinklefree_tpu.engine import SamplingParams as RefSampling
from wrinklefree_tpu.models.bitnet import fuse_projections as ref_fuse
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu.ops.ternary_pallas import make_pallas_linear_fused
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.engine import Engine, SamplingParams
from wrinklefree_tpu_torch.engine.json_constraint import JsonPrefixValidator
from wrinklefree_tpu_torch.weights import params_from_numpy

# decode bursts of 2: snapshots land mid-stream
ECFG = dict(max_batch_slots=4, page_size=8, num_pages=64, max_context=64,
            prefill_buckets=(8, 16, 32), decode_burst=2)
PIECES = [chr(i) if 32 <= i < 127 else "" for i in range(256)]
JOBS = [
    ([1, 5, 9, 2, 7], dict(max_new_tokens=16)),
    ([3, 4, 5, 6], dict(max_new_tokens=16, temperature=0.8, seed=123)),
    ([11, 12, 13], dict(max_new_tokens=16, temperature=1.1, seed=7, repetition_penalty=1.4,
                        presence_penalty=0.3, penalty_last_n=8)),
    ([2, 2, 9], dict(max_new_tokens=16, temperature=0.9, seed=5,
                     logit_bias=[(40, 4.0), (41, -1e9)])),
    ([8, 1], dict(max_new_tokens=16, temperature=2.0, seed=9, mirostat=2, mirostat_tau=4.0)),
    ([4, 9, 9], dict(max_new_tokens=20, json_mode=True, temperature=1.5, seed=4,
                     ignore_eos=True)),
    ([5, 6, 7], dict(max_new_tokens=12, grammar='root ::= [a-z]+ "!"', temperature=1.5,
                     seed=2)),
    ([9, 8, 7, 6, 5, 4, 3, 2, 1, 10, 11], dict(max_new_tokens=10, logprobs_k=2)),
]


@pytest.fixture(scope="module")
def weights():
    w = jax.tree.map(np.asarray, ref_init(RefConfig.tiny(), seed=0))
    for name in ("o_qw", "down_qw"):
        w["layers"][name] = np.full_like(w["layers"][name], 0x55)
    return w


def port_engine(weights, **over):
    cfg = BitNetConfig.tiny()
    eng = Engine(params_from_numpy(weights, cfg, device="cpu"), cfg,
                 EngineConfig(**dict(ECFG, **over)), eos_token_id=0, device="cpu")
    eng.token_pieces = PIECES
    return eng


def ref_engine(weights):
    cfg = RefConfig.tiny()
    eng = RefEngine(ref_fuse(jax.tree.map(jnp.asarray, weights), cfg), cfg,
                    RefEngineConfig(kv_layout="layer", **ECFG), eos_token_id=0,
                    linear_fn=make_pallas_linear_fused(interpret=True))
    eng.token_pieces = PIECES
    return eng


def _submit(eng, sp_cls):
    return [eng.submit(p, sp_cls(**kw)) for p, kw in JOBS]


def _finish(eng, reqs):
    while not all(r.finished for r in reqs):
        eng.step()
    return [(r.output_ids, r.finish_reason) for r in reqs]


def _snapshot_after(eng, reqs, steps=4):
    for _ in range(steps):
        eng.step()
    return eng.snapshot()


@pytest.fixture(scope="module")
def uninterrupted(weights):
    eng = port_engine(weights)
    return _finish(eng, _submit(eng, SamplingParams))


@pytest.fixture(scope="module")
def snaps(weights):
    """The same state in both packages: 8 requests over 4 slots (4 queued),
    four engine steps in."""
    port = port_engine(weights)
    ref = ref_engine(weights)
    p_reqs, r_reqs = _submit(port, SamplingParams), _submit(ref, RefSampling)
    return (_snapshot_after(port, p_reqs), [list(r.output_ids) for r in p_reqs],
            _snapshot_after(ref, r_reqs))


def test_snapshot_dict_equals_reference(snaps):
    port_snap, _, ref_snap = snaps
    assert port_snap == ref_snap
    assert port_snap["version"] == 1 and len(port_snap["requests"]) == len(JOBS)
    assert any(d["output_ids"] for d in port_snap["requests"])  # mid-stream
    assert any(not d["output_ids"] for d in port_snap["requests"])  # still queued


@pytest.mark.parametrize("source", ["port", "reference"])
def test_restore_continues_the_uninterrupted_run(weights, snaps, uninterrupted, source):
    """A fresh port engine restores the snapshot (the port's, or the
    reference's of the same state) and continues every request to the
    uninterrupted run's tokens: prefix emitted before the snapshot +
    continuation."""
    port_snap, before, ref_snap = snaps
    snap = port_snap if source == "port" else ref_snap
    eng = port_engine(weights)
    restored = eng.restore(snap)
    got = _finish(eng, restored)
    by_prompt = {tuple(p): i for i, (p, _) in enumerate(JOBS)}
    for d, (ids, why) in zip(snap["requests"], got):
        i = by_prompt[tuple(d["prompt_ids"])]
        want_ids, want_why = uninterrupted[i]
        assert d["output_ids"] == before[i][: len(d["output_ids"])]
        assert d["output_ids"] + ids == want_ids and why == want_why
    # the json request's whole text stays a JSON prefix across the restore
    j = next(k for k, (_, kw) in enumerate(JOBS) if kw.get("json_mode"))
    assert JsonPrefixValidator().advance("".join(PIECES[t] for t in uninterrupted[j][0])) in (
        "ok", "complete")


@pytest.fixture(scope="module")
def full_weights():
    return jax.tree.map(np.asarray, ref_init(RefConfig.tiny(), seed=0))


@pytest.mark.parametrize("steps", [4, 11])
def test_restore_on_the_full_model_continues_the_uninterrupted_run(full_weights, steps):
    """The restore on the full tiny model, where every logit depends on the
    KV history and its positions: a snapshot ``steps`` engine steps in,
    restored on a fresh engine (prompt + emitted tokens re-prefilled, draws
    resumed at ``counter_base``), continues every request (greedy, sampled,
    penalised, ``logit_bias``, mirostat, GBNF, logprobs; queued ones too) to
    exactly the uninterrupted run's tokens and finish reason, with its
    logprob ids and values (within 1e-4). A restore that lost or shifted
    the history would part here. The snapshot keeps no mirostat mu (the
    reference's dict), so a mirostat request restored mid-stream restarts mu
    at 2 tau: it must continue as that request submitted anew on prompt +
    emitted tokens with its draws at ``counter_base``."""
    eng = port_engine(full_weights)
    reqs = _submit(eng, SamplingParams)
    want = _finish(eng, reqs)
    src = port_engine(full_weights)
    snap = _snapshot_after(src, _submit(src, SamplingParams), steps)
    # mid-stream: the first four requests at 4 steps; mirostat, GBNF and
    # logprobs at 11 (the json request has finished by then)
    assert sum(bool(d["output_ids"]) for d in snap["requests"]) >= 3
    eng2 = port_engine(full_weights)
    restored = eng2.restore(snap)
    got = _finish(eng2, restored)
    by_prompt = {tuple(p): i for i, (p, _) in enumerate(JOBS)}
    for d, r, (ids, why) in zip(snap["requests"], restored, got):
        i = by_prompt[tuple(d["prompt_ids"])]
        if JOBS[i][1].get("mirostat") and d["output_ids"]:
            fresh = port_engine(full_weights)
            r0 = fresh.submit(d["prompt_ids"] + d["output_ids"],
                              SamplingParams(**dict(JOBS[i][1],
                                                    max_new_tokens=d["max_new_tokens"])))
            r0.counter_base = d["counter_base"]
            assert (ids, why) == _finish(fresh, [r0])[0]
            continue
        assert (d["output_ids"] + ids, why) == want[i]
        tail = reqs[i].logprobs_seq[len(d["output_ids"]):]
        assert len(r.logprobs_seq) == len(tail)
        for (c, tops), (wc, wtops) in zip(r.logprobs_seq, tail):
            assert [t for t, _ in tops] == [t for t, _ in wtops]
            np.testing.assert_allclose([c] + [v for _, v in tops],
                                       [wc] + [v for _, v in wtops], rtol=0, atol=1e-4)


def test_restore_keeps_logprobs_and_stream_callbacks(weights, snaps, uninterrupted):
    port_snap, _, _ = snaps
    eng = port_engine(weights)
    seen = {}
    restored = eng.restore(port_snap, on_token_factory=lambda d: (
        lambda tok, fin, key=tuple(d["prompt_ids"]): seen.setdefault(key, []).append(tok)))
    _finish(eng, restored)
    for d, r in zip(port_snap["requests"], restored):
        assert [t for t in seen[tuple(d["prompt_ids"])] if t >= 0] == r.output_ids
        if d["logprobs_k"]:
            assert len(r.logprobs_seq) == len(r.output_ids)


@pytest.mark.parametrize("bad", ["version", "too_long", "missing_key", "bad_grammar"])
def test_bad_snapshot_restores_nothing(weights, snaps, bad):
    snap = {"version": 1, "requests": [dict(d) for d in snaps[0]["requests"]]}
    last = snap["requests"][-1]
    if bad == "version":
        snap["version"] = 2
    elif bad == "too_long":
        last["prompt_ids"] = list(range(1, 70))  # >= max_context 64
    elif bad == "missing_key":
        del last["temperature"]
    else:
        last["grammar"] = "root ::= undefined_rule"
    eng = port_engine(weights)
    with pytest.raises((ValueError, KeyError)):
        eng.restore(snap)
    assert not eng.has_work() and eng.stats["requests"] == 0
