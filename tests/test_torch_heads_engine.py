"""The engine's output heads (``exact_head_k``, ``int8_logits``) of the port
against the JAX reference, on the CPU.

The full tiny model (2 layers, H 128) on both packages, the reference's
``Engine`` on its kernel path in interpret mode over the dual layout. Under
the exact head the port's streams equal its default engine's (greedy rows
take the exact greedy head, whose token is the bf16 head's argmax; sampled,
penalised and biased rows route their bursts to the clean bf16 head), and
the reference Engine's under ``tests/test_torch_engine.py``'s near-tie rule,
on staggered prefill rounds and radix sharing. ``int8_logits`` samples every
token from the int8 head, against the reference's. Mirostat under the exact
head keeps the int8 head (ROADMAP F7), token for token with the reference.
The plain burst reads the host once under the exact head. Setting both heads
raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests.test_torch_engine import (ECFG, SHARED, _assert_divergence_is_a_near_tie,
                                     _layer_free, _run_jobs)
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
from wrinklefree_tpu.engine import Engine as RefEngine
from wrinklefree_tpu.engine import SamplingParams as RefSampling
from wrinklefree_tpu.models.bitnet import fuse_projections as ref_fuse
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu.ops.ternary_pallas import make_pallas_linear_fused
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.engine import Engine, SamplingParams
from wrinklefree_tpu_torch.engine import programs
from wrinklefree_tpu_torch.weights import params_from_numpy

CFG, RCFG = BitNetConfig.tiny(), RefConfig.tiny()


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, ref_init(RCFG, seed=0))


def _port(weights, **over):
    return Engine(params_from_numpy(weights, CFG, device="cpu"), CFG,
                  EngineConfig(**dict(ECFG, **over)), eos_token_id=0, device="cpu")


def _ref(weights, **over):
    return RefEngine(ref_fuse(jax.tree.map(jnp.asarray, weights), RCFG), RCFG,
                     RefEngineConfig(**dict(ECFG, kv_layout="layer", **over)), eos_token_id=0,
                     linear_fn=make_pallas_linear_fused(interpret=True))


def _jobs(schedule):
    """6 requests over 4 slots, greedy and seeded rows alternating (the
    greedy ones longer, so the last bursts are all greedy), with prompts of
    3..18 tokens (staggered multi-chunk prefill rounds), or all sharing a
    two-page prefix (radix sharing, in-queue re-match)."""
    prefix = SHARED if schedule == "radix" else []
    return [(prefix + list(range(i + 1, i + 4 + 3 * i)),
             dict(ignore_eos=True, seed=100 + i,
                  **(dict(max_new_tokens=14 + i) if i % 2 == 0 else
                     dict(max_new_tokens=8 + i, temperature=0.9, top_p=0.95, top_k=40))))
            for i in range(6)]


def _held_to_reference(weights, port, jobs, got, want, int8_head=False):
    for (p, kw), g, w in zip(jobs, got, want):
        assert g[1] == w[1] == "length"
        _assert_divergence_is_a_near_tie(weights, port, p, SamplingParams(**kw), kw["seed"],
                                         w[0], g[0], int8_head=int8_head)


def test_both_heads_raise(weights):
    with pytest.raises(ValueError, match="mutually exclusive"):
        _port(weights, exact_head_k=8, int8_logits=True)


@pytest.mark.parametrize("schedule", ["stagger", "radix"])
def test_exact_head_streams(weights, schedule, monkeypatch):
    """``exact_head_k=8``: the default engine's streams token for token (the
    bursts with a sampled row take the clean bf16 head, the all-greedy ones,
    which ran, the exact head, whose token is the bf16 head's argmax), and
    the reference Engine's under the near-tie rule."""
    shortlists = []
    shortlist = programs.exact_topk_shortlist
    monkeypatch.setattr(programs, "exact_topk_shortlist",
                        lambda *a, **k: shortlists.append(1) or shortlist(*a, **k))
    jobs = _jobs(schedule)
    port = _port(weights, exact_head_k=8)
    got = _run_jobs(port, SamplingParams, jobs)
    assert got == _run_jobs(_port(weights), SamplingParams, jobs)
    want = _run_jobs(_ref(weights, exact_head_k=8), RefSampling, jobs)
    _held_to_reference(weights, port, jobs, got, want)
    assert shortlists
    if schedule == "radix":
        assert port.stats["radix_hit_tokens"] > 0


def test_int8_logits_streams(weights):
    """``int8_logits``: every token from the int8 head, greedy and seeded,
    the reference Engine's streams under the near-tie rule on both
    packages' int8-head logits; the greedy tokens part from the bf16 head's
    somewhere (the head is really the int8 one)."""
    jobs = _jobs("stagger")
    port = _port(weights, int8_logits=True)
    got = _run_jobs(port, SamplingParams, jobs)
    want = _run_jobs(_ref(weights, int8_logits=True), RefSampling, jobs)
    _held_to_reference(weights, port, jobs, got, want, int8_head=True)
    assert "lm_head_q" in port.params
    bf16 = _run_jobs(_port(weights), SamplingParams, jobs)
    assert got != bf16


def test_penalties_and_bias_route_to_the_clean_head(weights):
    """``tests/test_penalties.py`` (exact head falls back to full) and
    ``tests/test_logit_bias.py`` (biased rows stay correct) on the port: a
    penalised greedy request under ``exact_head_k`` equals the default
    engine's, a +1e9 bias forces its token every step, and a greedy row
    sharing bursts with them equals its run on the default engine."""
    pen = ([1, 5, 9, 2, 7, 5, 5], dict(max_new_tokens=10, repetition_penalty=1.8,
                                       penalty_last_n=16))
    bias = ([1, 5, 9], dict(max_new_tokens=3, ignore_eos=True, logit_bias=[(37, 1e9)]))
    plain = ([4, 4, 4, 4], dict(max_new_tokens=12, ignore_eos=True))
    for jobs in ([pen], [bias], [pen, bias, plain]):
        got = _run_jobs(_port(weights, exact_head_k=8), SamplingParams, jobs)
        assert got == _run_jobs(_port(weights), SamplingParams, jobs)
    assert got[1][0] == [37, 37, 37]


def test_mirostat_keeps_the_int8_head(weights):
    """ROADMAP F7: the reference strips the int8 head only for its logprobs
    and full-logits variants, so a mirostat burst under ``exact_head_k``
    samples from the int8 head. On the layer-free weights (both packages'
    logits equal up to f32 rounding) the port's mirostat streams equal the
    reference Engine's token for token, and the ``int8_logits`` engine's,
    and part from the default engine's (the bf16 head)."""
    w = _layer_free(weights)
    jobs = [([1, 2, 3, 9], dict(max_new_tokens=24, ignore_eos=True, mirostat=2,
                                temperature=1.0, seed=3)),
            ([5, 6], dict(max_new_tokens=12, temperature=1.0, seed=8))]
    got = _run_jobs(_port(w, exact_head_k=8), SamplingParams, jobs)
    assert got == _run_jobs(_ref(w, exact_head_k=8), RefSampling, jobs)
    assert got == _run_jobs(_port(w, int8_logits=True), SamplingParams, jobs)
    assert got[0] != _run_jobs(_port(w), SamplingParams, jobs)[0]


def test_exact_burst_reads_the_host_once(weights, monkeypatch):
    """A plain burst under the exact head (greedy rows: the exact branch,
    shortlist and full head both on the device) reads the device once: its
    tokens' ``.cpu()``, no ``.item()``, ``bool()`` or ``.tolist()``."""
    eng = _port(weights, exact_head_k=8, decode_burst=8)
    eng.submit([1, 2, 3, 4, 5], SamplingParams(max_new_tokens=40))
    eng.submit([6, 7, 8], SamplingParams(max_new_tokens=40))
    eng.step()  # admission, prefill, a first burst
    reads = []
    for name in ("cpu", "item", "tolist", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _o=orig, _n=name, **k: reads.append(_n)
                            or _o(self, *a, **k))
    d_last, d_pt, d_sl, d_seeds, d_ctr, d_sids, d_ring, _ = eng._dstate
    on = np.zeros(4, bool)
    on[:2] = True
    fallbacks = int(eng.exact_fallbacks)
    reads.clear()
    outs, *_ = programs.build_decode(eng)(eng.pools, d_last, d_pt, d_sl, d_seeds, d_ctr, d_sids,
                                          d_ring, eng._slot_samp(on))
    assert reads == ["cpu"] and outs.shape == (8, 4)
    monkeypatch.undo()
    assert int(eng.exact_fallbacks) >= fallbacks
