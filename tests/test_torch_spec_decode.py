"""The port's speculative decoding vs its plain greedy decoding and the JAX
reference, on the CPU.

  models/spec_decode.py  (_draft_ngram, spec_decode_window, generate_spec)
  engine/programs.py::build_decode_spec and the Engine's spec burst

A speculative stream emits a draft only where it equals the verifier's own
argmax, so it equals the plain greedy stream token for token, up to the
rounding of a k+1-row verify against a one-row step: a parting is accepted
only at a near-tie of the port's own logits (teacher-forced, one slot, the
same pools), within the packages' 6e-2 bar. Against the reference's spec
``Engine`` on the same weights a parting is accepted at a near-tie of the
reference's logits, and where every stream is equal the spec statistics
are equal too.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests.test_torch_engine import ref_config_logits
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
from wrinklefree_tpu.engine import Engine as RefEngine
from wrinklefree_tpu.engine import SamplingParams as RefSampling
from wrinklefree_tpu.models import bitnet as rb
from wrinklefree_tpu.models import spec_decode as rsd
from wrinklefree_tpu.models.bitnet import fuse_projections as ref_fuse
from wrinklefree_tpu.ops.ternary_pallas import make_pallas_linear_fused
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.engine import Engine, SamplingParams
from wrinklefree_tpu_torch.kv.paged import PagedKV, paged_forward
from wrinklefree_tpu_torch.models import bitnet as tb
from wrinklefree_tpu_torch.models import spec_decode as tsd
from wrinklefree_tpu_torch.weights import params_from_numpy

NEAR_TIE = 6e-2  # the packages' logits bar (tests/test_torch_engine.py)
BASE = dict(max_batch_slots=4, page_size=8, num_pages=64, max_context=64,
            prefill_buckets=(8, 16, 32), decode_burst=4)
# the reference test's prompts (tests/test_spec_decode.py), one repeating
PROMPTS = [[1, 5, 9, 2, 7], [3, 4, 5, 3, 4, 5, 3, 4], [11, 12, 13]]
# four prompts that end at different page offsets (ps 8): windows cross pages
CROSSING = [list(range(1, n)) for n in (4, 7, 11, 14)]


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, rb.init_params(RefConfig.tiny(), seed=0))


def _layer_free(weights):
    """The o and down projections as ternary zeros (0x55): the logits depend
    on the current token alone, so both packages agree up to f32 rounding and
    the greedy stream soon cycles, which the drafts then predict."""
    w = jax.tree.map(np.copy, weights)
    for name in ("o_qw", "down_qw"):
        w["layers"][name] = np.full_like(w["layers"][name], 0x55)
    return w


# ---------------------------------------------------------------------------
# _draft_ngram, spec_decode_window, generate_spec
# ---------------------------------------------------------------------------


def _hists(seed, B=6, H=40):
    """Histories with repeats (so n-grams match), one row of distinct tokens
    (no match), and lengths from 0 to H-1."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 5, (B, H)).astype(np.int32)
    hist[1] = np.arange(H)  # no n-gram repeats
    hist[2] = np.tile([7, 3, 9, 5], H // 4)
    seq = np.asarray([0, 5, 17, H - 2, H - 1, 1][:B], np.int32)
    return hist, seq


@pytest.mark.parametrize("k,n", [(1, 1), (3, 2), (4, 2), (4, 3), (8, 2), (39, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draft_ngram_matches_reference(seed, k, n):
    hist, seq = _hists(seed)
    ref = rsd._draft_ngram(jnp.asarray(hist), jnp.asarray(seq), k, n)
    got = tsd._draft_ngram(torch.from_numpy(hist), torch.from_numpy(seq), k, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_draft_ngram_finds_repetition():
    """The reference test's case: tail bigram (7, 3) at positions 4-5
    matches positions 0-1, so the draft is hist[2:5]."""
    hist = torch.tensor([[7, 3, 9, 5, 7, 3, 0, 0]], dtype=torch.int32)
    assert tsd._draft_ngram(hist, torch.tensor([5]), 3, 2).tolist() == [[9, 5, 7]]


def _window_inputs(rparams, tparams, rcfg, cfg, prompt, T=96):
    """Prefill ``prompt`` in both packages; the reference's and the port's
    (last, cache, start, hist) for a window."""
    P = len(prompt)
    rcache = rb.KVCache.zeros(rcfg, 1, T)
    rl, rcache = rb.forward(rparams, rcfg, jnp.asarray(prompt, jnp.int32)[None], rcache,
                            jnp.zeros((1,), jnp.int32), logits_all=False)
    tcache = tb.KVCache.zeros(cfg, 1, T, device="cpu")
    tl, tcache = tb.forward(tparams, cfg, torch.tensor([prompt]), tcache, torch.zeros(1),
                            logits_all=False)
    last = int(np.argmax(np.asarray(rl)[0]))
    assert int(tl.argmax()) == last
    hist = np.zeros((1, T), np.int32)
    hist[0, :P], hist[0, P] = prompt, last
    return ((jnp.asarray([last], jnp.int32), rcache, jnp.asarray([P], jnp.int32),
             jnp.asarray(hist)),
            (torch.tensor([last], dtype=torch.int32), tcache, torch.tensor([P], dtype=torch.int32),
             torch.from_numpy(hist)))


@pytest.mark.parametrize("force_accept", [None, 0, 2, 3])
def test_spec_decode_window_matches_reference(weights, force_accept):
    """Two 6-step windows, k 3, on the layer-free weights: tokens, counts,
    last token, start and history equal to the reference's; with
    ``force_accept`` a every step emits a + 1 tokens."""
    w = _layer_free(weights)
    rcfg, cfg = RefConfig.tiny(), BitNetConfig.tiny()
    rparams, tparams = jax.tree.map(jnp.asarray, w), params_from_numpy(w, cfg, device="cpu")
    (rl, rc, rs, rh), (tl, tc, ts, th) = _window_inputs(rparams, tparams, rcfg, cfg,
                                                        [5, 9, 2, 7, 5, 9])
    th0, th0_copy = th, th.clone()
    accepted = emitted = 0
    for _ in range(2):
        rt, rn, rl, rc, rs, rh = rsd.spec_decode_window(
            rparams, rcfg, rl, rc, rs, rh, steps=6, k=3, force_accept=force_accept)
        tt, tn, tl, tc, ts, th = tsd.spec_decode_window(
            tparams, cfg, tl, tc, ts, th, steps=6, k=3, force_accept=force_accept)
        for r, t in ((rt, tt), (rn, tn), (rl, tl), (rs, ts), (rh, th)):
            np.testing.assert_array_equal(np.asarray(r), t.numpy())
        accepted += int((tn - 1).sum())
        emitted += int(tn.sum())
        if force_accept is not None:
            assert (tn == force_accept + 1).all()
    assert int(ts[0]) == 6 + emitted
    np.testing.assert_allclose(tc.k.float().numpy(), np.asarray(rc.k, np.float32), atol=0.05)
    if force_accept is None:
        assert accepted > 0  # the cycling stream is drafted
    assert torch.equal(th0, th0_copy)  # the caller's history is left as it was


@pytest.mark.parametrize("k,ngram,window", [(4, 2, 4), (3, 1, 4), (8, 2, 3)])
def test_generate_spec_equals_greedy_generate(weights, k, ngram, window):
    """``generate_spec`` gives the port's greedy ``generate`` tokens on the
    full tiny model (the reference test's prompts and settings), or parts at
    a near-tie of the port's own logits."""
    cfg = BitNetConfig.tiny()
    params = params_from_numpy(weights, cfg, device="cpu")
    for seed, plen in ((0, 5), (1, 12), (2, 3)):
        prompt = [int(t) for t in np.random.default_rng(seed).integers(1, cfg.vocab_size, plen)]
        want = tb.generate(params, cfg, prompt, max_new_tokens=24, device="cpu")[plen:]
        got = tsd.generate_spec(params, cfg, prompt, max_new_tokens=24, k=k, ngram=ngram,
                                window=window, device="cpu")
        assert len(got) == 24
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if j is not None:
            lg = _dense_logits(params, cfg, prompt + want[:j])
            assert max(lg.max() - lg[t] for t in (want[j], got[j])) < NEAR_TIE, (prompt, j)


def _dense_logits(params, cfg, ids):
    cache = tb.KVCache.zeros(cfg, 1, len(ids) + 8, device="cpu")
    out, _ = tb.forward(params, cfg, torch.tensor([ids]), cache, torch.zeros(1),
                        logits_all=False)
    return out[0].numpy()


# ---------------------------------------------------------------------------
# the Engine's speculative burst
# ---------------------------------------------------------------------------


def port_engine(weights, cfg=None, **over):
    cfg = cfg or BitNetConfig.tiny()
    params = (weights if isinstance(weights, dict) and isinstance(weights["embed"], torch.Tensor)
              else params_from_numpy(weights, cfg, device="cpu"))
    return Engine(params, cfg, EngineConfig(**{**BASE, **over}), device="cpu")


def ref_engine(weights, **over):
    rcfg = RefConfig.tiny()
    return RefEngine(ref_fuse(jax.tree.map(jnp.asarray, weights), rcfg), rcfg,
                     RefEngineConfig(**{**BASE, **over}),
                     linear_fn=make_pallas_linear_fused(interpret=True))


def run(eng, sp_cls, prompts, n=18, concurrent=True, **sp):
    """Greedy streams (output ids) of ``prompts``: submitted together, or one
    after another."""
    if not concurrent:
        return [eng.generate(p, sp_cls(max_new_tokens=n, temperature=0.0, **sp)).output_ids
                for p in prompts]
    reqs = [eng.submit(p, sp_cls(max_new_tokens=n, temperature=0.0, **sp)) for p in prompts]
    while not all(r.finished for r in reqs):
        eng.step()
    assert all(r.finish_reason == "length" for r in reqs)
    return [r.output_ids for r in reqs]


def port_logits(params, cfg, prompt, tokens, kv_layout="layer", kv_dtype="bf16", ps=8):
    """The port's logits [V] for the token after prompt + tokens: its paged
    forward on one slot's pools of ``kv_layout``/``kv_dtype``, the prompt in
    one chunk, then one decode step per token (teacher-forced)."""
    pools = (PagedKV.zeros_dual(cfg, 16, ps, 1, kv_dtype, device="cpu") if kv_layout == "layer"
             else PagedKV.zeros(cfg, 16, ps, kv_dtype, device="cpu"))
    pt = torch.arange(1, 16, dtype=torch.int32)[None]
    chunk = torch.zeros((1, -(-len(prompt) // ps) * ps), dtype=torch.long)
    chunk[0, :len(prompt)] = torch.tensor(prompt)
    feed = [(chunk, 0, len(prompt))] + [
        (torch.tensor([[t]]), len(prompt) + i, 1) for i, t in enumerate(tokens)]
    sid = torch.zeros(1, dtype=torch.int32)
    for toks, sl, n in feed:
        logits, pools = paged_forward(params, cfg, toks, pools, pt, torch.tensor([sl]),
                                      torch.tensor([n]), slot_ids=sid)
    return logits[0].numpy()


# partings seen by the held-to-plain checks: (case, prompt, step, gaps)
PARTINGS = []


def assert_equal_or_near_tie(case, prompts, got, want, logits_fn):
    """``got`` equals ``want`` stream by stream, or parts at step j where
    ``logits_fn(prompt, want[:j])`` holds both tokens within NEAR_TIE of its
    maximum."""
    for p, g, w in zip(prompts, got, want):
        assert len(g) == len(w), (p, g, w)
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            continue
        lg = logits_fn(p, w[:j])
        gaps = [float(lg.max() - lg[t]) for t in (w[j], g[j])]
        PARTINGS.append((case, p, j, gaps))
        assert max(gaps) < NEAR_TIE, f"{case}: {p} parts at token {j}, gaps {gaps}"


ENGINE_CASES = {
    "layer": dict(kv_layout="layer"),
    "token": dict(kv_layout="token"),
    "int8_kv": dict(kv_dtype="int8"),  # the auto layout: token-major
    "exact_head": dict(exact_head_k=64),
    "int8_logits": dict(int8_logits=True),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_spec_engine_equals_plain(weights, case):
    """The reference test's prompts one after another, then the page-crossing
    prompts at once (ps 8, k 3, bursts of 4): the spec engine's streams equal
    the port's plain engine's (or part at a near-tie of the port's own logits),
    and it drafted and accepted."""
    over = ENGINE_CASES[case]
    plain, spec = port_engine(weights, **over), port_engine(weights, speculative_k=3, **over)
    want = run(plain, SamplingParams, PROMPTS, concurrent=False)
    want += run(plain, SamplingParams, CROSSING, n=25)
    got = run(spec, SamplingParams, PROMPTS, concurrent=False)
    got += run(spec, SamplingParams, CROSSING, n=25)
    assert spec.stats["spec_drafted"] > 0 and spec.stats["spec_accepted"] > 0
    assert spec.stats["decode_tokens"] == plain.stats["decode_tokens"]
    params = spec.params if not (over.get("exact_head_k") or over.get("int8_logits")) else (
        plain.params if over.get("int8_logits") else
        {k: v for k, v in spec.params.items() if not k.startswith("lm_head_")})
    assert_equal_or_near_tie(
        case, PROMPTS + CROSSING, got, want,
        lambda p, t: port_logits(params, spec.cfg, p, t, spec.kv_layout,
                                 over.get("kv_dtype", "bf16")))


@pytest.mark.parametrize("layout", ["layer", "token"])
def test_spec_engine_matches_reference_spec_engine(weights, layout):
    """The same spec engine in both packages (k 3, bursts of 4, the reference
    with its kernels in interpret mode): streams equal or parted at a
    near-tie of the reference's logits; where every stream is equal, the
    drafted and accepted counts and decode steps are equal too."""
    port = port_engine(weights, speculative_k=3, kv_layout=layout)
    ref = ref_engine(weights, speculative_k=3, kv_layout=layout)
    got = run(port, SamplingParams, PROMPTS, concurrent=False)
    got += run(port, SamplingParams, CROSSING, n=25)
    want = run(ref, RefSampling, PROMPTS, concurrent=False)
    want += run(ref, RefSampling, CROSSING, n=25)
    assert_equal_or_near_tie(f"reference-{layout}", PROMPTS + CROSSING, got, want,
                             lambda p, t: ref_config_logits(weights, p, t, kv_layout=layout))
    if got == want:
        for key in ("spec_drafted", "spec_accepted", "decode_steps", "decode_tokens"):
            assert port.stats[key] == ref.stats[key], key
    assert port.stats["spec_accepted"] > 0


def test_spec_engine_equals_reference_on_layer_free_weights(weights):
    """On the layer-free weights (both packages' logits agree up to f32
    rounding) the concurrent page-crossing streams and the spec statistics
    equal the reference's exactly."""
    w = _layer_free(weights)
    port, ref = (port_engine(w, speculative_k=3, kv_layout="layer"),
                 ref_engine(w, speculative_k=3, kv_layout="layer"))
    got, want = run(port, SamplingParams, CROSSING, n=25), run(ref, RefSampling, CROSSING, n=25)
    assert got == want
    for key in ("spec_drafted", "spec_accepted", "decode_steps"):
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["spec_accepted"] > 0


def test_spec_adaptive_cutoff(weights, caplog):
    """spec_min_accept 0.99 over a 4-draft window: drafting turns itself off
    (sticky, with its log line) and the tokens stay the plain engine's."""
    eng = port_engine(weights, max_batch_slots=2, prefill_buckets=(8, 16), speculative_k=3,
                      spec_min_accept=0.99, spec_min_accept_window=4)
    with caplog.at_level(logging.INFO, logger="wrinklefree_tpu_torch.engine.engine"):
        r = eng.generate([1, 9, 4, 2, 7, 5], SamplingParams(max_new_tokens=24))
    assert len(r.output_ids) == 24 and eng._spec_off is True
    assert any("speculative decoding auto-disabled" in m for m in caplog.messages)
    drafted = eng.stats["spec_drafted"]
    assert drafted >= 4
    r2 = eng.generate([6, 8, 3], SamplingParams(max_new_tokens=8))
    assert len(r2.output_ids) == 8 and eng.stats["spec_drafted"] == drafted
    plain = port_engine(weights, max_batch_slots=2, prefill_buckets=(8, 16))
    want = plain.generate([1, 9, 4, 2, 7, 5], SamplingParams(max_new_tokens=24)).output_ids
    assert_equal_or_near_tie("cutoff", [[1, 9, 4, 2, 7, 5]], [r.output_ids], [want],
                             lambda p, t: port_logits(plain.params, plain.cfg, p, t))
    ref = ref_engine(weights, max_batch_slots=2, prefill_buckets=(8, 16), speculative_k=3,
                     spec_min_accept=0.99, spec_min_accept_window=4, kv_layout="layer")
    ref.generate([1, 9, 4, 2, 7, 5], RefSampling(max_new_tokens=24, temperature=0.0))
    assert ref._spec_off is True and ref.stats["spec_drafted"] == drafted


@pytest.mark.parametrize("sp", [dict(temperature=0.9, seed=7), dict(logprobs_k=2),
                                dict(repetition_penalty=1.2)])
def test_spec_falls_back_to_the_plain_burst(weights, sp):
    """A sampled, logprobs or penalised request runs the plain burst: alone it
    drafts nothing, and beside a greedy request the whole burst is plain
    while it runs; its tokens are the plain engine's."""
    eng = port_engine(weights, max_batch_slots=2, prefill_buckets=(8, 16), speculative_k=3)
    r = eng.generate([1, 2, 3], SamplingParams(max_new_tokens=8, **sp))
    assert len(r.output_ids) == 8 and eng.stats.get("spec_drafted", 0) == 0
    plain = port_engine(weights, max_batch_slots=2, prefill_buckets=(8, 16))
    assert plain.generate([1, 2, 3], SamplingParams(max_new_tokens=8, **sp)).output_ids == \
        r.output_ids
    a = eng.submit([4, 5, 6], SamplingParams(max_new_tokens=6, **sp))
    b = eng.submit([7, 8, 9], SamplingParams(max_new_tokens=6))
    while not (a.finished and b.finished):
        eng.step()
    assert eng.stats.get("spec_drafted", 0) == 0


def test_spec_engine_retracts_on_a_dry_pool(weights):
    """A spec burst covers K * (k+1) positions per slot: on a 16-page pool
    four 10-token prompts x 30 tokens run dry, a victim is retracted (and
    re-prefilled), and every stream equals the roomy plain engine's or parts
    at a near-tie; the reference's spec engine retracts as often."""
    prompts = [list(range(10 * i + 1, 10 * i + 11)) for i in range(4)]
    spec = port_engine(weights, num_pages=16, speculative_k=3)
    got = run(spec, SamplingParams, prompts, n=30)
    assert spec.stats.get("preemptions", 0) > 0
    plain = port_engine(weights)
    want = run(plain, SamplingParams, prompts, n=30)
    assert_equal_or_near_tie("dry pool", prompts, got, want,
                             lambda p, t: port_logits(plain.params, plain.cfg, p, t))
    ref = ref_engine(weights, num_pages=16, speculative_k=3, kv_layout="layer")
    run(ref, RefSampling, prompts, n=30)
    assert ref.stats.get("preemptions", 0) == spec.stats["preemptions"]


def test_spec_moe_engine_equals_plain():
    """The MoE model (4 experts, top-2; the stacked K7 linear) with k 3."""
    cfg = BitNetConfig(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
                       num_heads=4, num_kv_heads=2, head_dim=32, max_position=256,
                       num_experts=4, num_experts_per_tok=2)
    params = tb.init_params(cfg, seed=0, device="cpu")
    plain = Engine(params, cfg, EngineConfig(**BASE), device="cpu")
    spec = Engine(params, cfg, EngineConfig(speculative_k=3, **BASE), device="cpu")
    want = run(plain, SamplingParams, CROSSING, n=25)
    got = run(spec, SamplingParams, CROSSING, n=25)
    assert spec.stats["spec_drafted"] > 0
    assert_equal_or_near_tie("moe", CROSSING, got, want,
                             lambda p, t: port_logits(spec.params, cfg, p, t))


def test_spec_burst_reads_the_host_once(weights, monkeypatch):
    """One host read per speculative burst, whatever K."""
    eng = port_engine(weights, speculative_k=3, decode_burst=6)
    reads = []
    real = torch.Tensor.cpu

    def counting(t, *a, **kw):
        reads.append(tuple(t.shape))
        return real(t, *a, **kw)

    req = eng.submit(PROMPTS[1], SamplingParams(max_new_tokens=40))
    while eng.slots[0] is None or eng.slots[0].pending:
        eng.step()
    steps0 = eng.stats["decode_steps"]
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    eng.step()
    monkeypatch.undo()
    assert eng.stats["decode_steps"] - steps0 == 6 and len(reads) == 1
    while not req.finished:
        eng.step()


def test_decode_bench_spec_metric():
    """``bench/decode.py --spec K`` on the tiny model: ``bench.py``'s spec
    fields, between one and K+1 tokens a step."""
    from wrinklefree_tpu_torch.bench import decode

    got = decode.run("tiny", prompt_len=8, steps=8, device="cpu", spec=3)
    assert got["spec_k"] == 3 and got["spec_tok_s"] > 0
    assert 1.0 <= got["spec_accept_per_step"] <= 4.0
