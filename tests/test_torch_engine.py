"""The port's paged forward and serving engine vs the JAX reference, on the CPU.

Both packages run the tiny config (2 layers, H 128) on identical weights
(the reference's ``init_params`` carried over with ``params_from_numpy``).
The reference runs its kernel path in interpret mode: fused projections,
``make_pallas_linear_fused(interpret=True)`` (prologue-fused linears and
the MLP megakernel) over the dual ("layer") KV layout. The port runs the
plain versions of its kernels, which its wrappers take for CPU tensors.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
from wrinklefree_tpu.engine import Engine as RefEngine
from wrinklefree_tpu.engine import SamplingParams as RefSampling
from wrinklefree_tpu.kv import paged as ref_paged
from wrinklefree_tpu.models.bitnet import fuse_projections as ref_fuse
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu.ops.ternary_pallas import make_pallas_linear_fused
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.engine import Engine, SamplingParams
from wrinklefree_tpu_torch.engine import programs
from wrinklefree_tpu_torch.engine.constrained import make_validator, select_constrained
from wrinklefree_tpu_torch.kv import paged
from wrinklefree_tpu_torch.models.bitnet import fuse_projections
from wrinklefree_tpu_torch.ops import sampling
from wrinklefree_tpu_torch.weights import params_from_numpy

ECFG = dict(max_batch_slots=4, page_size=8, num_pages=64, max_context=64,
            prefill_buckets=(8, 16, 32))
# the prompts of tests/test_dual_kv.py::test_dual_matches_token_greedy
PROMPTS = [
    list(range(1, 6)),        # mid-page prompt end
    list(range(2, 15)),       # crosses a page in prefill
    list(range(3, 12)),
    [7, 7, 7],                # tiny
    list(range(1, 25)),       # multi-bucket chunked prefill
]
SHARED = list(range(1, 17))  # two full pages
# id i -> chr(i) over printable ASCII, for the constrained requests
PIECES = [chr(i) if 32 <= i < 127 else "" for i in range(256)]


@pytest.fixture(scope="module")
def weights():
    cfg = RefConfig.tiny()
    np_params = jax.tree.map(np.asarray, ref_init(cfg, seed=0))
    return np_params


CONCURRENT = [list(range(i + 1, i + 7)) for i in range(8)]  # 8 requests, 4 slots
RADIX = [SHARED + [20], SHARED + [21]]
# A divergence is accepted only at a near-tie: where the reference's own top-2
# logits are closer than the 6e-2 logit bar the paged forward is held to.
NEAR_TIE = 6e-2


def _scenarios(eng, sp_cls):
    """Greedy generations on one engine: the five prompts one at a time,
    8 requests over 4 slots at once (slot reuse), then a radix reuse pair."""
    out = {}
    out["sequential"] = []
    for p in PROMPTS:
        r = eng.generate(p, sp_cls(max_new_tokens=20, temperature=0.0))
        out["sequential"].append((r.output_ids, r.finish_reason))
    reqs = [eng.submit(p, sp_cls(max_new_tokens=10, temperature=0.0)) for p in CONCURRENT]
    while any(not r.finished for r in reqs):
        eng.step()
    out["concurrent"] = [(r.output_ids, r.finish_reason) for r in reqs]
    a = eng.generate(RADIX[0], sp_cls(max_new_tokens=8, temperature=0.0))
    hits0 = eng.stats["radix_hit_tokens"]
    b = eng.generate(RADIX[1], sp_cls(max_new_tokens=8, temperature=0.0))
    out["radix"] = [(a.output_ids, a.finish_reason), (b.output_ids, b.finish_reason)]
    out["radix_hit"] = eng.stats["radix_hit_tokens"] > hits0
    return out


def _ref_top2_gap(weights, prompt, tokens, step):
    """The reference's top-2 logit gap where it chose tokens[step]: its own
    paged forward (interpret-mode kernels, dual pools), teacher-forced on
    the prompt and tokens[:step]."""
    cfg = RefConfig.tiny()
    params = ref_fuse(jax.tree.map(jnp.asarray, weights), cfg)
    lf = make_pallas_linear_fused(interpret=True)
    pools = ref_paged.PagedKV.zeros_dual(cfg, 16, 8, num_slots=1)
    pt = jnp.arange(1, 9, dtype=jnp.int32)[None]
    chunk = np.zeros((1, -(-len(prompt) // 8) * 8), np.int32)
    chunk[0, :len(prompt)] = prompt
    logits, pools = ref_paged.paged_forward(
        params, cfg, jnp.asarray(chunk), pools, pt, jnp.asarray([0]),
        jnp.asarray([len(prompt)]), linear_fn=lf, slot_ids=jnp.asarray([0]))
    for i, t in enumerate(tokens[:step]):
        logits, pools = ref_paged.paged_forward(
            params, cfg, jnp.asarray([[t]], jnp.int32), pools, pt,
            jnp.asarray([len(prompt) + i]), jnp.asarray([1]), linear_fn=lf,
            slot_ids=jnp.asarray([0]))
    top2 = np.sort(np.asarray(logits)[0])[-2:]
    assert int(np.argmax(np.asarray(logits)[0])) == tokens[step]
    return float(top2[1] - top2[0])


@pytest.fixture(scope="module")
def ref_outputs(weights):
    cfg = RefConfig.tiny()
    fused = ref_fuse(jax.tree.map(jnp.asarray, weights), cfg)
    eng = RefEngine(fused, cfg, RefEngineConfig(kv_layout="layer", **ECFG),
                    linear_fn=make_pallas_linear_fused(interpret=True))
    return _scenarios(eng, RefSampling)


@pytest.fixture(scope="module")
def port_outputs(weights):
    cfg = BitNetConfig.tiny()
    eng = Engine(params_from_numpy(weights, cfg, device="cpu"), cfg, EngineConfig(**ECFG),
                 device="cpu")
    return _scenarios(eng, SamplingParams)


@pytest.mark.parametrize("scenario,prompts", [
    ("sequential", PROMPTS), ("concurrent", CONCURRENT), ("radix", RADIX)])
def test_engine_greedy_matches_reference(ref_outputs, port_outputs, weights, scenario,
                                         prompts):
    """Equal greedy output_ids and finish_reason; a sequence may part from the
    reference only at a near-tie of the reference's own logits (recorded in
    ROADMAP.md, queue 3)."""
    for prompt, (got, got_why), (want, want_why) in zip(
            prompts, port_outputs[scenario], ref_outputs[scenario]):
        assert got_why == want_why and len(got) == len(want)
        if got == want:
            continue
        step = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        gap = _ref_top2_gap(weights, prompt, want, step)
        assert gap < NEAR_TIE, f"prompt {prompt}: diverged at token {step}, top-2 gap {gap}"


def test_engine_radix_reuse_hits(ref_outputs, port_outputs):
    assert ref_outputs["radix_hit"] and port_outputs["radix_hit"]


@pytest.fixture(scope="module")
def port_flash_outputs(weights):
    """The scenarios with ``flash_decode=True``: every decode step's attention
    goes through ``flash_paged_decode`` (its plain version on the CPU),
    counted through the name ``kv/paged.py`` calls."""
    cfg = BitNetConfig.tiny()
    eng = Engine(params_from_numpy(weights, cfg, device="cpu"), cfg,
                 EngineConfig(flash_decode=True, **ECFG), device="cpu")
    calls = []
    orig = paged.flash_paged_decode
    paged.flash_paged_decode = lambda *a: calls.append(1) or orig(*a)
    try:
        out = _scenarios(eng, SamplingParams)
    finally:
        paged.flash_paged_decode = orig
    out["flash_calls"] = len(calls)
    out["decode_steps"] = eng.stats["decode_steps"]
    return out


@pytest.mark.parametrize("scenario,prompts", [
    ("sequential", PROMPTS), ("concurrent", CONCURRENT), ("radix", RADIX)])
def test_engine_flash_decode_matches_reference(ref_outputs, port_flash_outputs, port_outputs,
                                               weights, scenario, prompts):
    """EngineConfig(flash_decode=True): the decode steps run the flash decode
    attention (once per layer and step) and give the tokens of the default
    run and of the reference, under the default run's rule: a sequence may
    part only at a near-tie of the reference's own logits."""
    assert port_flash_outputs["flash_calls"] == (
        BitNetConfig.tiny().num_layers * port_flash_outputs["decode_steps"])
    for other in (port_outputs, ref_outputs):
        for prompt, (got, got_why), (want, want_why), (ref, _) in zip(
                prompts, port_flash_outputs[scenario], other[scenario], ref_outputs[scenario]):
            assert got_why == want_why and len(got) == len(want)
            if got == want:
                continue
            step = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            gap = _ref_top2_gap(weights, prompt, ref, step)
            assert gap < NEAR_TIE, f"prompt {prompt}: diverged at token {step}, top-2 gap {gap}"


def test_paged_forward_logits_match_reference(weights):
    """One 128-token prefill chunk (flash path, 3 staging tokens left over),
    then 10 decode steps that cross a page, both packages teacher-forced with
    the reference's token; logits within 6e-2 (tests/test_dual_kv.py's bar
    for the prologue-fused path)."""
    rcfg, cfg = RefConfig.tiny(), BitNetConfig.tiny()
    ps, MP, P = 8, 32, 40
    r_params = ref_fuse(jax.tree.map(jnp.asarray, weights), rcfg)
    p_params = fuse_projections(params_from_numpy(weights, cfg, device="cpu"), cfg)
    lf = make_pallas_linear_fused(interpret=True)
    r_pools = ref_paged.PagedKV.zeros_dual(rcfg, P, ps, num_slots=2)
    p_pools = paged.PagedKV.zeros_dual(cfg, P, ps, 2, device="cpu")
    pt = np.arange(1, MP + 1, dtype=np.int32)[None]
    rng = np.random.default_rng(0)
    toks = np.zeros((1, 128), np.int32)
    toks[0, :123] = rng.integers(1, cfg.vocab_size, 123)
    sl, n = 0, 123
    slot = np.asarray([1], np.int32)
    for step in range(11):
        lo_r, r_pools = ref_paged.paged_forward(
            r_params, rcfg, jnp.asarray(toks), r_pools, jnp.asarray(pt), jnp.asarray([sl]),
            jnp.asarray([n]), linear_fn=lf, slot_ids=jnp.asarray(slot))
        lo_p, p_pools = paged.paged_forward(
            p_params, cfg, torch.from_numpy(toks), p_pools, torch.from_numpy(pt),
            torch.tensor([sl]), torch.tensor([n]), slot_ids=torch.from_numpy(slot))
        np.testing.assert_allclose(lo_p.numpy(), np.asarray(lo_r), rtol=6e-2, atol=6e-2,
                                   err_msg=f"step {step} (seq_len {sl})")
        sl += n
        nxt = int(np.argmax(np.asarray(lo_r), -1)[0])
        toks, n = np.asarray([[nxt]], np.int32), 1
    assert sl == 133  # crossed the page boundary at 128


def test_seeded_sampling_independent_of_schedule(weights):
    """Counter-keyed draws: a seeded sampling request draws the same tokens
    alone as beside other requests."""
    cfg = BitNetConfig.tiny()
    params = params_from_numpy(weights, cfg, device="cpu")
    sp = SamplingParams(max_new_tokens=12, temperature=0.9, top_p=0.95, top_k=40, seed=123)
    eng = Engine(params, cfg, EngineConfig(**ECFG), device="cpu")
    alone = eng.generate(list(range(3, 20)), sp).output_ids
    eng2 = Engine(params, cfg, EngineConfig(**ECFG), device="cpu")
    others = [eng2.submit(list(range(i, i + 9)), SamplingParams(max_new_tokens=9, temperature=0.7,
                                                               seed=i)) for i in range(1, 4)]
    mine = eng2.submit(list(range(3, 20)), sp)
    while not all(r.finished for r in others + [mine]):
        eng2.step()
    assert mine.output_ids == alone


SAMPLED = [dict(temperature=0.8), dict(temperature=1.3, top_k=40, top_p=0.9),
           dict(temperature=1.0, min_p=0.05, repetition_penalty=1.3, presence_penalty=0.5),
           dict(temperature=1.5, typical_p=0.9, logit_bias=[(7, 3.0), (9, -1e9)]),
           dict(temperature=2.0, tfs_z=0.9, frequency_penalty=0.4)]


@pytest.mark.parametrize("schedule", ["stagger", "radix", "retraction"])
def test_seeded_sampling_matches_reference(weights, schedule):
    """Seeded sampled streams of the port Engine equal the reference Engine's
    on the layer-free weights, token for token: 8 requests over 4 slots with
    prompts of 3..30 tokens (staggered multi-chunk prefill rounds), the same
    with every prompt sharing a two-page prefix (radix sharing, in-queue
    re-match), and a dry pool that retracts requests (each resumes its stream
    at counter_base + #sampled)."""
    prefix = SHARED if schedule == "radix" else []
    prompts = [prefix + list(range(i + 1, i + 4 + 3 * i)) for i in range(8)]
    new = [14 + i for i in range(8)]
    over = {}
    if schedule == "retraction":
        # tests/test_torch_preemption.py's contended pool: each request's
        # last burst needs a page past its budget and the pool is dry
        over = dict(num_pages=18, decode_burst=8)
        prompts, new = [[1 + i, 2, 3, 4, 5, 6] for i in range(8)], [26] * 8
    port, ref = _feature_engines(_layer_free(weights), **over)
    outs, stats = [], []
    for eng, sp_cls in ((port, SamplingParams), (ref, RefSampling)):
        reqs = [eng.submit(p, sp_cls(max_new_tokens=n, seed=100 + i, ignore_eos=True,
                                     **SAMPLED[i % len(SAMPLED)]))
                for i, (p, n) in enumerate(zip(prompts, new))]
        while not all(r.finished for r in reqs):
            eng.step()
        outs.append([(r.output_ids, r.finish_reason) for r in reqs])
        stats.append({k: eng.stats.get(k, 0) for k in ("radix_hit_tokens", "preemptions",
                                                        "decode_tokens")})
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]
    if schedule == "radix":
        assert stats[0]["radix_hit_tokens"] > 0
    if schedule == "retraction":
        assert stats[0]["preemptions"] > 0


def _port_engine(weights, **over):
    cfg = BitNetConfig.tiny()
    eng = Engine(params_from_numpy(weights, cfg, device="cpu"), cfg,
                 EngineConfig(**dict(ECFG, **over)), eos_token_id=0, device="cpu")
    eng.token_pieces = PIECES
    return eng


@functools.lru_cache(maxsize=1)
def _ref_forward():
    """The reference's paged forward, jitted as its engine's programs are
    (interpret-mode kernels): compiled once per token shape."""
    return jax.jit(functools.partial(ref_paged.paged_forward, cfg=RefConfig.tiny(),
                                     linear_fn=make_pallas_linear_fused(interpret=True)))


def _forced_logits(weights, prompt, tokens, int8_head=False):
    """Both packages' logits [V] for the token after prompt + tokens,
    teacher-forced through their paged forwards (one slot): the prompt in
    one prefill chunk of 48, then one decode step per token; through each
    package's int8 head with ``int8_head``. Returns (reference, port)."""
    from wrinklefree_tpu.models.bitnet import quantize_lm_head as ref_quantize_head
    from wrinklefree_tpu_torch.models.bitnet import quantize_lm_head

    rcfg, cfg = RefConfig.tiny(), BitNetConfig.tiny()
    r_params = jax.tree.map(jnp.asarray, weights)
    p_params = params_from_numpy(weights, cfg, device="cpu")
    if int8_head:
        r_params, p_params = ref_quantize_head(r_params, rcfg), quantize_lm_head(p_params, cfg)
    r_params = ref_fuse(r_params, rcfg)
    r_pools = ref_paged.PagedKV.zeros_dual(rcfg, 16, 8, num_slots=1)
    p_pools = paged.PagedKV.zeros_dual(cfg, 16, 8, 1, device="cpu")
    pt = np.arange(1, 9, dtype=np.int32)[None]
    chunk = np.zeros((1, 48), np.int32)
    chunk[0, :len(prompt)] = prompt
    feed = [(chunk, 0, len(prompt))] + [
        (np.asarray([[t]], np.int32), len(prompt) + i, 1) for i, t in enumerate(tokens)]
    for toks, sl, n in feed:
        lr, r_pools = _ref_forward()(
            r_params, tokens=jnp.asarray(toks), pools=r_pools, page_table=jnp.asarray(pt),
            seq_lens=jnp.asarray([sl]), new_lens=jnp.asarray([n]), slot_ids=jnp.asarray([0]))
        lp, p_pools = paged.paged_forward(
            p_params, cfg, torch.from_numpy(toks), p_pools, torch.from_numpy(pt),
            torch.tensor([sl]), torch.tensor([n]), slot_ids=torch.tensor([0]))
    return np.asarray(lr)[0], lp[0].numpy()


def _penalised(eng, logits, sp, hist):
    """A row's post-penalty logits [1, V] after the tokens ``hist`` and its
    sampler settings, as ``eng``'s programs make them."""
    samp, window = eng._samp_arrays(1), eng.ecfg.penalty_window
    for key, v in (("temps", sp.temperature), ("tps", sp.top_p), ("topks", max(0, sp.top_k)),
                   ("minps", max(0.0, sp.min_p)), ("typps", sp.typical_p), ("tfs", sp.tfs_z),
                   ("reps", sp.repetition_penalty), ("pres", sp.presence_penalty),
                   ("freqs", sp.frequency_penalty),
                   ("lastn", window if sp.penalty_last_n < 0 else min(sp.penalty_last_n,
                                                                       window))):
        samp[key][0] = v
    for k, (tid, b) in enumerate(sp.logit_bias or []):
        samp["bias_ids"][0, k], samp["bias_vals"][0, k] = tid, b
    n = len(hist)
    ring = torch.full((1, window), -1, dtype=torch.int32)
    for p in range(max(0, n - window), n):
        ring[0, p % window] = hist[p]
    return programs._penalised(torch.from_numpy(logits.copy())[None], ring, torch.tensor([n]),
                               samp), samp


def _assert_divergence_is_a_near_tie(weights, eng, prompt, sp, seed, want, got,
                                     int8_head=False):
    """The port's stream ``got`` against the reference's ``want`` for one
    request on the full model. Where they part (at step j), both packages'
    logits for prompt + want[:j], teacher-forced, must agree within the
    paged forward's NEAR_TIE bar (eps apart at most); each package's sampler,
    on its own logits and the request's draw for step j, must pick its own
    engine's token (so each engine's history and counter were right); and
    the pick must be a near-tie that eps can flip: for the device sampler,
    whose Gumbel noise goes by candidate rank, the two tokens' penalised
    logits lie within 2 eps (a rounding can trade their ranks, and with them
    their noise) or the reference's perturbed scores (masked logits / T +
    noise) lie within 2 eps / T at the top; for a constrained row, whose
    noise goes by token id, the two tokens' scores (logits / T + noise;
    logits when greedy) lie within 2 eps (/ T). ``int8_head``: both
    packages' logits through their int8 heads."""
    j = next((k for k, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if j is None:
        assert len(want) == len(got)
        return
    lr, lp = _forced_logits(weights, prompt, want[:j], int8_head)
    eps = float(np.abs(lp - lr).max())
    assert eps <= NEAR_TIE, f"step {j}: logits {eps} apart"
    hist = prompt + want[:j]
    (pr, samp), (pp, _) = (_penalised(eng, lg, sp, hist) for lg in (lr, lp))
    T = sp.temperature
    if sp.constrained:
        picks = []
        for row in (pr, pp):
            req = types.SimpleNamespace(sampling=sp, seed=seed, counter_base=0,
                                        output_ids=list(want[:j]),
                                        grammar=make_validator(eng, sp))
            for t in want[:j]:
                req.grammar.advance(PIECES[t])
            picks.append(select_constrained(eng, req, row[0].numpy())[0])
        assert picks == [want[j], got[j]], f"step {j}: picks {picks}"
        score = pr[0].double().numpy() / (T or 1.0)
        if T > 0:
            score = score + np.random.default_rng((seed << 20) ^ j).gumbel(size=score.shape[0])
        assert score[want[j]] - score[got[j]] <= 2 * eps / (T or 1.0), f"step {j}"
        return
    c = min(sampling.NUCLEUS_CANDIDATES, pr.shape[1])
    noise = (sampling.gumbel(sampling.per_request_keys(torch.tensor([seed]), torch.tensor([j])),
                             c) if T > 0 else None)
    kw = programs._sampler_kw(samp)
    picks = [int(sampling.sample_token(row, noise, **kw)[0]) for row in (pr, pp)]
    assert picks == [want[j], got[j]], f"step {j}: picks {picks}"
    trade = abs(float(pr[0, want[j]] - pr[0, got[j]])) <= 2 * eps
    if T > 0 and not trade:
        masked, _ = sampling._filtered_candidates(
            pr, np.asarray([T], np.float32), samp["tps"], samp["topks"], samp["minps"],
            samp["typps"], samp["tfs"], c)
        top2 = torch.topk(masked + noise, 2).values[0]
        trade = float(top2[0] - top2[1]) <= 2 * eps / T
    assert trade, f"step {j}: {want[j]} vs {got[j]} is no near-tie at eps {eps}"


@pytest.mark.parametrize("schedule", ["stagger", "radix", "retraction"])
def test_seeded_sampling_full_model(weights, schedule):
    """The schedules of test_seeded_sampling_matches_reference on the full
    tiny model, where the KV history and the page tables shape every logit:
    each scheduled port stream equals the same request run alone on a fresh
    engine, token for token, and where it parts from the reference Engine's
    stream the divergence is a near-tie (_assert_divergence_is_a_near_tie)."""
    prefix = SHARED if schedule == "radix" else []
    prompts = [prefix + list(range(i + 1, i + 4 + 3 * i)) for i in range(8)]
    new = [14 + i for i in range(8)]
    over = {}
    if schedule == "retraction":
        over = dict(num_pages=18, decode_burst=8)
        prompts, new = [[1 + i, 2, 3, 4, 5, 6] for i in range(8)], [26] * 8
    jobs = [(p, dict(max_new_tokens=n, seed=100 + i, ignore_eos=True,
                     **SAMPLED[i % len(SAMPLED)]))
            for i, (p, n) in enumerate(zip(prompts, new))]
    port, ref = _feature_engines(weights, **over)
    got = _run_jobs(port, SamplingParams, jobs)
    want = _run_jobs(ref, RefSampling, jobs)
    if schedule == "radix":
        assert port.stats["radix_hit_tokens"] > 0
    if schedule == "retraction":
        assert port.stats["preemptions"] > 0
    for (p, kw), g, w in zip(jobs, got, want):
        (alone,) = _run_jobs(_port_engine(weights), SamplingParams, [(p, kw)])
        assert g == alone
        assert g[1] == w[1] == "length"
        _assert_divergence_is_a_near_tie(weights, port, p, SamplingParams(**kw), kw["seed"],
                                         w[0], g[0])


def test_segregated_constrained_step_full_model(weights):
    """Constrained rows (json_mode and a json_schema grammar, sampled; a
    GBNF grammar, greedy) step one token at a time on their own view beside
    unconstrained rows' bursts, on the full tiny model: every port stream
    equals the request run alone, and its divergence from the reference
    Engine's is a near-tie."""
    from wrinklefree_tpu_torch.engine.schema_to_gbnf import schema_to_gbnf

    schema = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                               "n": {"type": "integer"}},
              "required": ["ok", "n"]}
    jobs = [([1, 5, 9], dict(json_mode=True, max_new_tokens=24, temperature=1.5, seed=11)),
            ([4, 4, 4], dict(max_new_tokens=20, ignore_eos=True, seed=1)),
            ([7, 8, 9, 10], dict(max_new_tokens=20, temperature=1.0, seed=9)),
            ([2, 3], dict(grammar='root ::= "yes" | "no"', max_new_tokens=8, seed=2)),
            ([6, 1, 6], dict(grammar=schema_to_gbnf(schema), max_new_tokens=30,
                             temperature=1.3, seed=5))]
    port, ref = _feature_engines(weights, decode_burst=8)
    got = _run_jobs(port, SamplingParams, jobs)
    want = _run_jobs(ref, RefSampling, jobs)
    for (p, kw), g, w in zip(jobs, got, want):
        (alone,) = _run_jobs(_port_engine(weights, decode_burst=8), SamplingParams, [(p, kw)])
        assert g == alone
        _assert_divergence_is_a_near_tie(weights, port, p, SamplingParams(**kw), kw["seed"],
                                         w[0], g[0])


def _run_jobs(eng, sp_cls, jobs):
    reqs = [eng.submit(p, sp_cls(**kw)) for p, kw in jobs]
    while not all(r.finished for r in reqs):
        eng.step()
    return [(r.output_ids, r.finish_reason) for r in reqs]


@functools.lru_cache(maxsize=None)
def _ref_forward_for(window: int = 0, global_tokens: int = 0):
    """The reference's paged forward, jitted (interpret-mode kernels), with
    its sliding-window attention when ``window`` > 0."""
    af = ref_paged.make_dual_window_attention(window, global_tokens) if window else None
    return jax.jit(functools.partial(ref_paged.paged_forward, cfg=RefConfig.tiny(),
                                     linear_fn=make_pallas_linear_fused(interpret=True),
                                     attention_fn=af))


def ref_config_logits(weights, prompt, tokens, kv_layout="layer", kv_dtype="bf16",
                      int8_head=False, window=0, global_tokens=0):
    """The reference's logits [V] for the token after prompt + tokens on
    pools of ``kv_layout``/``kv_dtype`` (its int8 head with ``int8_head``,
    its window attention with ``window`` and ``global_tokens``), teacher-forced through its paged
    forward: the prompt in one 48-token chunk, then one decode step per
    token (one slot)."""
    from wrinklefree_tpu.models.bitnet import quantize_lm_head as ref_quantize_head

    rcfg = RefConfig.tiny()
    params = jax.tree.map(jnp.asarray, weights)
    if int8_head:
        params = ref_quantize_head(params, rcfg)
    params = ref_fuse(params, rcfg)
    pools = (ref_paged.PagedKV.zeros_dual(rcfg, 16, 8, num_slots=1, kv_dtype=kv_dtype)
             if kv_layout == "layer" else ref_paged.PagedKV.zeros(rcfg, 16, 8, kv_dtype))
    pt = jnp.arange(1, 9, dtype=jnp.int32)[None]
    chunk = np.zeros((1, 48), np.int32)
    chunk[0, :len(prompt)] = prompt
    feed = [(chunk, 0, len(prompt))] + [
        (np.asarray([[t]], np.int32), len(prompt) + i, 1) for i, t in enumerate(tokens)]
    for toks, sl, n in feed:
        logits, pools = _ref_forward_for(window, global_tokens)(
            params, tokens=jnp.asarray(toks), pools=pools, page_table=pt,
            seq_lens=jnp.asarray([sl]), new_lens=jnp.asarray([n]), slot_ids=jnp.asarray([0]))
    return np.asarray(logits)[0]


def assert_greedy_near_ties(weights, prompts, got, want, **ref_kw):
    """Greedy streams ``got`` (the port's) against ``want`` (the reference
    Engine's), as (output_ids, finish_reason) per prompt: equal reasons and
    lengths, and where a stream parts (step j) the reference's own logits
    there (``ref_config_logits`` under ``ref_kw``, one slot, teacher-forced)
    put both tokens within NEAR_TIE of their maximum."""
    for prompt, (g, g_why), (w, w_why) in zip(prompts, got, want):
        assert g_why == w_why and len(g) == len(w), (prompt, g, w)
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            continue
        lg = ref_config_logits(weights, prompt, w[:j], **ref_kw)
        gaps = [float(lg.max() - lg[t]) for t in (w[j], g[j])]
        assert max(gaps) < NEAR_TIE, f"prompt {prompt}: parted at token {j}, gaps {gaps}"


def greedy_scenario(eng, sp_cls, n=10):
    """Three greedy requests at once (a mid-page prompt end, a page crossed
    in prefill, a two-chunk prefill), then the radix pair one after the
    other: their (output_ids, finish_reason) in that order."""
    prompts = [PROMPTS[0], PROMPTS[1], PROMPTS[4]]
    out = _run_jobs(eng, sp_cls, [(p, dict(max_new_tokens=n, temperature=0.0))
                                  for p in prompts])
    for p in RADIX:
        out += _run_jobs(eng, sp_cls, [(p, dict(max_new_tokens=6, temperature=0.0))])
    return prompts + RADIX, out


@pytest.mark.parametrize("kw", [
    dict(kv_dtype="int8"), dict(speculative_k=2), dict(attn_window=16),
    dict(exact_head_k=64), dict(int8_logits=True), dict(use_native_runtime=True),
])
def test_out_of_slice_config_raises(weights, kw):
    """These engine configurations, all once refused by the port, run on the
    full tiny model beside the reference Engine under the same configuration
    (int8 KV on its auto layout, token-major; the rest on the dual layout):
    greedy streams over concurrent prompts and a radix pair, equal or parted
    only at a near-tie of the reference's own logits, with the same radix
    hits; speculative decoding drafts and accepts in both."""
    cfg = BitNetConfig.tiny()
    params = params_from_numpy(weights, cfg, device="cpu")
    layout = "token" if "kv_dtype" in kw else "layer"
    port = Engine(params, cfg, EngineConfig(**ECFG, **kw), device="cpu")
    rcfg = RefConfig.tiny()
    ref = RefEngine(ref_fuse(jax.tree.map(jnp.asarray, weights), rcfg), rcfg,
                    RefEngineConfig(**ECFG, kv_layout=layout, **kw),
                    linear_fn=make_pallas_linear_fused(interpret=True))
    assert port.kv_layout == ref.kv_layout == layout
    assert port.native_runtime and ref.native_runtime
    prompts, got = greedy_scenario(port, SamplingParams)
    _, want = greedy_scenario(ref, RefSampling)
    assert port.stats["radix_hit_tokens"] == ref.stats["radix_hit_tokens"] > 0
    assert_greedy_near_ties(weights, prompts, got, want, kv_layout=layout,
                            kv_dtype=kw.get("kv_dtype", "bf16"),
                            int8_head=bool(kw.get("int8_logits")),
                            window=kw.get("attn_window", 0))
    if "speculative_k" in kw:
        assert port.stats["spec_accepted"] > 0 and ref.stats["spec_accepted"] > 0


def _layer_free(weights):
    """The tiny weights with the o and down projections set to ternary zeros
    (0x55: code 1 in every 2-bit field): the residual stream is the token
    embedding, so both packages compute the same logits up to f32 rounding
    and sampled, logprobs and constrained streams compare token for token
    (the full model's logits part by up to 6e-2, which reorders the near-equal
    candidates of a sampled draw)."""
    w = jax.tree.map(np.copy, weights)
    for name in ("o_qw", "down_qw"):
        w["layers"][name] = np.full_like(w["layers"][name], 0x55)
    return w


def _feature_engines(weights, **over):
    e = dict(ECFG, **over)
    cfg, rcfg = BitNetConfig.tiny(), RefConfig.tiny()
    port = Engine(params_from_numpy(weights, cfg, device="cpu"), cfg, EngineConfig(**e),
                  eos_token_id=0, device="cpu")
    ref = RefEngine(ref_fuse(jax.tree.map(jnp.asarray, weights), rcfg), rcfg,
                    RefEngineConfig(kv_layout="layer", **e), eos_token_id=0,
                    linear_fn=make_pallas_linear_fused(interpret=True))
    port.token_pieces = ref.token_pieces = PIECES
    return port, ref


@pytest.mark.parametrize("kw", [dict(logprobs_k=2),
                                dict(json_mode=True, temperature=1.5, seed=4),
                                dict(mirostat=2, temperature=2.0, seed=3)])
def test_out_of_slice_request_raises(weights, kw):
    """These request features (logprobs, json_mode, mirostat), which the
    port's engine once refused, run: on the layer-free weights each request,
    alone and beside a plain sampled one, gives the reference Engine's tokens,
    finish reasons and logprob ids (values within 1e-4)."""
    port, ref = _feature_engines(_layer_free(weights))
    outs = []
    for eng, sp_cls in ((port, SamplingParams), (ref, RefSampling)):
        reqs = [eng.submit([1, 2, 3, 9], sp_cls(max_new_tokens=20, ignore_eos=True, **kw)),
                eng.submit([5, 6], sp_cls(max_new_tokens=12, temperature=1.0, seed=8))]
        while not all(r.finished for r in reqs):
            eng.step()
        outs.append(reqs)
    for got, want in zip(*outs):
        assert (got.output_ids, got.finish_reason) == (want.output_ids, want.finish_reason)
        assert len(got.logprobs_seq) == len(want.logprobs_seq)
        for (c, tops), (rc, rtops) in zip(got.logprobs_seq, want.logprobs_seq):
            assert [t for t, _ in tops] == [t for t, _ in rtops]
            np.testing.assert_allclose([c] + [v for _, v in tops],
                                       [rc] + [v for _, v in rtops], rtol=0, atol=1e-4)
    if kw.get("logprobs_k"):
        assert len(outs[0][0].logprobs_seq) == 20


def test_mesh_and_exhausted_pool_raise(weights):
    cfg = BitNetConfig.tiny()
    params = params_from_numpy(weights, cfg, device="cpu")
    # a mesh (once refused) shards the engine, with no collective at
    # construction: rank 1 of tp 2 holds query heads 2-3, KV head 1 (tp
    # divides the tiny model's two), its pools one KV head wide, the params
    # unfused on the stacked linear; fused params are refused
    mesh = types.SimpleNamespace(
        shape={"data": 1, "model": 2}, model=types.SimpleNamespace(index=1, size=2),
        data=types.SimpleNamespace(index=0, size=1), device=torch.device("cpu"),
        control=None, leader=0)
    mesh.axis = {"model": mesh.model, "data": mesh.data}
    tp = Engine(params, cfg, EngineConfig(**ECFG), mesh=mesh, device="cpu")
    D = cfg.head_dim
    assert torch.equal(tp.params["layers"]["q_qw"], params["layers"]["q_qw"][..., 2 * D:])
    assert torch.equal(tp.params["layers"]["k_qw"], params["layers"]["k_qw"][..., D:])
    assert tp.pools.kv.shape[-1] == D and not tp._tp_kv_rep
    assert getattr(tp._linear_fn, "stacked", False)
    assert not getattr(tp._linear_fn, "prologue", False)
    with pytest.raises(ValueError, match="unfused"):
        Engine(fuse_projections(params, cfg), cfg, EngineConfig(**ECFG), mesh=mesh,
               device="cpu")
    assert Engine(params, cfg, EngineConfig(**ECFG), device="cpu").snapshot() == {
        "version": 1, "requests": []}
    # 4 usable pages: two 9-token prompts take 2 pages each at admission; the
    # first decode burst needs a third page per slot and the pool is dry. The
    # engine retracts a request there, as the reference does, and both finish
    # with the reference's tokens.
    small = dict(ECFG, num_pages=5, enable_radix_cache=False)
    prompts = ([1, 2, 3, 4, 5, 6, 7, 8, 9], [3, 4, 5, 6, 7, 8, 9, 10, 11])
    eng = Engine(params, cfg, EngineConfig(**small), device="cpu")
    rcfg = RefConfig.tiny()
    ref = RefEngine(ref_fuse(jax.tree.map(jnp.asarray, weights), rcfg),
                    rcfg, RefEngineConfig(kv_layout="layer", **small),
                    linear_fn=make_pallas_linear_fused(interpret=True))
    outs = []
    for e, sp_cls in ((eng, SamplingParams), (ref, RefSampling)):
        reqs = [e.submit(p, sp_cls(max_new_tokens=4)) for p in prompts]
        while not all(r.finished for r in reqs):
            e.step()
        outs.append([(r.output_ids, r.finish_reason) for r in reqs])
    assert outs[0] == outs[1]
    assert eng.stats["preemptions"] == ref.stats["preemptions"] == 1


def test_cancel_and_latency_summary(weights):
    """cancel() ends a queued and an in-flight request (slot and pages
    freed); latency_summary() reports the finished ones."""
    cfg = BitNetConfig.tiny()
    eng = Engine(params_from_numpy(weights, cfg, device="cpu"), cfg,
                 EngineConfig(**dict(ECFG, max_batch_slots=1)), device="cpu")
    assert eng.latency_summary() == {}
    running = eng.submit(list(range(1, 10)), SamplingParams(max_new_tokens=40))
    queued = eng.submit([3, 4, 5], SamplingParams(max_new_tokens=4))
    eng.step()
    free = eng.allocator.num_free
    assert eng.cancel(queued) and queued.finish_reason == "abort"
    assert eng.cancel(running, "stop") and running.finish_reason == "stop"
    assert not eng.cancel(running)
    assert eng.slots == [None] and eng.allocator.num_free > free
    done = eng.generate([7, 8, 9], SamplingParams(max_new_tokens=3))
    assert done.finish_reason == "length" and len(done.output_ids) == 3
    summary = eng.latency_summary()
    assert summary["window"] == 2  # the in-flight cancel had emitted a token
    assert set(summary["ttft_s"]) == {"p50", "p95", "p99"}
