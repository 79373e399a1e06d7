"""The port's paged forward and serving engine vs the JAX reference, on the CPU.

Both packages run the tiny config (2 layers, H 128) on identical weights
(the reference's ``init_params`` carried over with ``params_from_numpy``).
The reference runs its kernel path in interpret mode: fused projections,
``make_pallas_linear_fused(interpret=True)`` (prologue-fused linears and
the MLP megakernel) over the dual ("layer") KV layout. The port runs the
plain versions of its kernels, which its wrappers take for CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from wrinklefree_tpu_torch.kv import paged
from wrinklefree_tpu_torch.models.bitnet import fuse_projections
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
    """Per-request generators: a seeded sampling request draws the same
    tokens alone as beside other requests."""
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


@pytest.mark.parametrize("kw", [
    dict(kv_dtype="int8"), dict(speculative_k=2), dict(attn_window=16),
    dict(exact_head_k=64), dict(int8_logits=True), dict(use_native_runtime=True),
])
def test_out_of_slice_config_raises(weights, kw):
    cfg = BitNetConfig.tiny()
    params = params_from_numpy(weights, cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        Engine(params, cfg, EngineConfig(**ECFG, **kw), device="cpu")


@pytest.mark.parametrize("kw", [dict(logprobs_k=2), dict(json_mode=True), dict(mirostat=2)])
def test_out_of_slice_request_raises(weights, kw):
    cfg = BitNetConfig.tiny()
    eng = Engine(params_from_numpy(weights, cfg, device="cpu"), cfg, EngineConfig(**ECFG),
                 device="cpu")
    with pytest.raises(NotImplementedError):
        eng.submit([1, 2, 3], SamplingParams(**kw))


def test_mesh_and_exhausted_pool_raise(weights):
    cfg = BitNetConfig.tiny()
    params = params_from_numpy(weights, cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        Engine(params, cfg, EngineConfig(**ECFG), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        eng = Engine(params, cfg, EngineConfig(**ECFG), device="cpu")
        eng.snapshot()
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
