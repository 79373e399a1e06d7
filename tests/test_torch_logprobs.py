"""Logprobs in the port's Engine vs the reference Engine, on the CPU.

A logprobs request records, per emitted token, the chosen token's logprob
and the top-N ids and logprobs of the distribution the step sampled from
(penalised, pre-temperature), through its prefill's first token and its
decode bursts; a round mixing a logprobs row with a constrained row takes
them from the full logits on the host.

On the layer-free weights (the reference's tiny weights with the o and down
projections set to ternary zeros, so both packages compute the same logits
up to f32 rounding) the ids equal the reference's and the values agree
within 1e-4. On the full tiny model, whose logits part from the reference's
by up to 6e-2, the greedy stream and its ids equal the reference's up to a
near-tie of the reference's own top-2 logprobs (the bar of
``tests/test_torch_engine.py``), the values agree within that bar, and the
port's own invariants hold at every step.
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
from wrinklefree_tpu_torch.weights import params_from_numpy

ECFG = dict(max_batch_slots=4, page_size=8, num_pages=64, max_context=64,
            prefill_buckets=(8, 16, 32))
NEAR_TIE = 6e-2
PIECES = [chr(i) if 32 <= i < 127 else "" for i in range(256)]


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, ref_init(RefConfig.tiny(), seed=0))


@pytest.fixture(scope="module")
def layer_free(weights):
    w = jax.tree.map(np.copy, weights)
    for name in ("o_qw", "down_qw"):
        w["layers"][name] = np.full_like(w["layers"][name], 0x55)
    return w


def _engines(weights, **over):
    e = dict(ECFG, **over)
    cfg, rcfg = BitNetConfig.tiny(), RefConfig.tiny()
    port = Engine(params_from_numpy(weights, cfg, device="cpu"), cfg, EngineConfig(**e),
                  eos_token_id=0, device="cpu")
    ref = RefEngine(ref_fuse(jax.tree.map(jnp.asarray, weights), rcfg), rcfg,
                    RefEngineConfig(kv_layout="layer", **e), eos_token_id=0,
                    linear_fn=make_pallas_linear_fused(interpret=True))
    port.token_pieces = ref.token_pieces = PIECES
    return port, ref


def _run(eng, sp_cls, jobs):
    reqs = [eng.submit(p, sp_cls(**kw)) for p, kw in jobs]
    while not all(r.finished for r in reqs):
        eng.step()
    return reqs


def _assert_equal(got_reqs, want_reqs, atol=1e-4):
    for got, want in zip(got_reqs, want_reqs):
        assert (got.output_ids, got.finish_reason) == (want.output_ids, want.finish_reason)
        assert len(got.logprobs_seq) == len(want.logprobs_seq)
        for (c, tops), (rc, rtops) in zip(got.logprobs_seq, want.logprobs_seq):
            assert [t for t, _ in tops] == [t for t, _ in rtops]
            np.testing.assert_allclose([c] + [v for _, v in tops],
                                       [rc] + [v for _, v in rtops], rtol=0, atol=atol)


JOBS = [
    ([1, 5, 9, 2, 7], dict(max_new_tokens=40, logprobs_k=3, ignore_eos=True)),
    ([3, 4, 5, 6, 7, 8, 9, 10, 11, 12], dict(max_new_tokens=20, logprobs_k=1,
                                             temperature=1.2, seed=6, ignore_eos=True)),
    (list(range(2, 25)), dict(max_new_tokens=18, logprobs_k=20, repetition_penalty=1.5,
                              logit_bias=[(7, 2.0)], ignore_eos=True)),
    ([6, 6, 6], dict(max_new_tokens=30, temperature=0.9, seed=2, ignore_eos=True)),
]


@pytest.mark.parametrize("burst", [16, 4])
def test_logprobs_match_reference(layer_free, burst):
    """Four requests at once over prefill (a 23-token prompt in two chunks)
    and several bursts: logprobs_k 3, a sampled 1, a penalised and biased 20
    (clamped to EngineConfig.logprobs_top = 8) and a plain sampled row that
    shares the logprobs bursts and records nothing."""
    port, ref = _engines(layer_free, decode_burst=burst)
    got = _run(port, SamplingParams, JOBS)
    want = _run(ref, RefSampling, JOBS)
    _assert_equal(got, want)
    assert [len(r.logprobs_seq) for r in got] == [40, 20, 18, 0]
    assert all(len(tops) == 8 for _, tops in got[2].logprobs_seq)


def test_mixed_round_logprobs_from_full_logits(layer_free):
    """A logprobs row admitted with a json_mode row: their prefill round runs
    the full-logits program, and the first token's logprobs come from the
    host's log-softmax of that row (then the logprobs bursts take over)."""
    port, ref = _engines(layer_free)
    jobs = [([1, 5, 9], dict(max_new_tokens=12, logprobs_k=4, ignore_eos=True)),
            ([2, 3, 4], dict(max_new_tokens=12, json_mode=True, temperature=1.5, seed=3))]
    _assert_equal(_run(port, SamplingParams, jobs), _run(ref, RefSampling, jobs))


def test_logprobs_full_model_invariants_and_reference(weights):
    """The full tiny model, greedy: the top-1 id is the emitted token and its
    logprob the chosen one (<= 0) at every step, the stream equals the same
    request without logprobs, and against the reference the ids and values
    agree (within 6e-2) up to a divergence, which is accepted only at a
    near-tie of the reference's own top-2 logprobs."""
    port, ref = _engines(weights)
    prompts = [[1, 5, 9, 2, 7], list(range(3, 20)), [7, 7, 7]]
    jobs = [(p, dict(max_new_tokens=24, logprobs_k=4, ignore_eos=True)) for p in prompts]
    got = _run(port, SamplingParams, jobs)
    want = _run(ref, RefSampling, jobs)
    plain = _run(port, SamplingParams,
                 [(p, dict(max_new_tokens=24, ignore_eos=True)) for p in prompts])
    for g, w, p in zip(got, want, plain):
        assert g.output_ids == p.output_ids and len(g.logprobs_seq) == 24
        for tok, (chosen, tops) in zip(g.output_ids, g.logprobs_seq):
            assert tops[0][0] == tok and chosen == tops[0][1] and chosen <= 0
            assert [v for _, v in tops] == sorted((v for _, v in tops), reverse=True)
        for step, (a, b) in enumerate(zip(g.output_ids, w.output_ids)):
            (rc, rtops), (c, tops) = w.logprobs_seq[step], g.logprobs_seq[step]
            if a != b:
                gap = rtops[0][1] - rtops[1][1]
                assert gap < NEAR_TIE, f"diverged at token {step}, top-2 gap {gap}"
                break
            np.testing.assert_allclose(c, rc, atol=NEAR_TIE)
            if rtops[0][1] - rtops[1][1] >= NEAR_TIE:
                assert tops[0][0] == rtops[0][0]
