"""Preemption on a dry KV pool and SJF admission: the port's Engine vs the reference's.

The cases of ``tests/test_preemption.py`` on the port's ``Engine``
(``device="cpu"``, the plain versions of its kernels), on the reference's
tiny weights carried over with ``weights.params_from_numpy``. When a decode
burst needs a page and the pool is dry, the engine retracts a victim (frees
its slot and pages, requeues it) and re-prefills it later; every request
still finishes, with the tokens of an uncontended run. Greedy outputs and
the retraction count are held against the reference ``Engine`` on the same
configuration (its interpret-mode kernel path over the dual KV layout, as
``tests/test_torch_engine.py`` runs it, under that file's rule: a sequence
may part from the reference only at a near-tie of the reference's own
logits); a seeded sampling stream, whose
draws come from the request's own ``torch.Generator``, against the port's
own uncontended run.
"""

import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
from wrinklefree_tpu.engine import Engine as RefEngine
from wrinklefree_tpu.engine import SamplingParams as RefSampling
from wrinklefree_tpu.models.bitnet import KVCache as RefKVCache
from wrinklefree_tpu.models.bitnet import forward as ref_forward
from wrinklefree_tpu.models.bitnet import fuse_projections as ref_fuse
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu.ops.ternary_pallas import make_pallas_linear_fused
from wrinklefree_tpu.server.async_engine import AsyncEngine as RefAsyncEngine
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.engine import Engine, SamplingParams
from wrinklefree_tpu_torch.server.async_engine import AsyncEngine
from wrinklefree_tpu_torch.weights import params_from_numpy

# A greedy divergence from the reference is accepted only at a near-tie of
# the reference's own logits (tests/test_torch_engine.py's bar).
NEAR_TIE = 6e-2

# tests/test_preemption.py::test_page_oom_preempts_not_kills at page size 8
# (the dual KV layout's least): a budget of 6 + 26 tokens pre-allocates 4
# pages a request; the last burst (from seq_len 30, 8 steps) needs page 4,
# one top-up per request against the 17 - 16 = 1 usable page left free
CONTENDED = dict(max_batch_slots=4, page_size=8, num_pages=18, max_context=64,
                 prefill_buckets=(8, 16, 32), decode_burst=8)
ROOMY = dict(CONTENDED, num_pages=200)
PROMPTS = [[1 + i, 2, 3, 4, 5, 6] for i in range(4)]
# ROADMAP queue 3, F1: 4 usable pages; two 9-token prompts take 2 pages each
# at admission and the first decode burst needs a third page per slot
F1 = dict(max_batch_slots=4, page_size=8, num_pages=5, max_context=64,
          prefill_buckets=(8, 16, 32), enable_radix_cache=False)
F1_PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [3, 4, 5, 6, 7, 8, 9, 10, 11]]


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, ref_init(RefConfig.tiny(), seed=0))


def port_engine(weights, **ecfg):
    cfg = BitNetConfig.tiny()
    return Engine(params_from_numpy(weights, cfg, device="cpu"), cfg, EngineConfig(**ecfg),
                  device="cpu")


def ref_engine(weights, **ecfg):
    cfg = RefConfig.tiny()
    fused = ref_fuse(jax.tree.map(jnp.asarray, weights), cfg)
    return RefEngine(fused, cfg, RefEngineConfig(kv_layout="layer", **ecfg),
                     linear_fn=make_pallas_linear_fused(interpret=True))


def ref_top2_gap(weights, ids):
    """The reference's top-2 logit gap for the token after ``ids`` (its
    dense forward on the same weights)."""
    cfg = RefConfig.tiny()
    cache = RefKVCache.zeros(cfg, 1, -(-len(ids) // 8) * 8)
    logits, _ = ref_forward(jax.tree.map(jnp.asarray, weights), cfg,
                            jnp.asarray([ids], jnp.int32), cache, jnp.zeros((1,), jnp.int32),
                            logits_all=False)
    top2 = np.sort(np.asarray(logits)[0])[-2:]
    return float(top2[1] - top2[0])


def sp(cls, i, temperature):
    return cls(max_new_tokens=26, temperature=temperature, seed=1000 + i, ignore_eos=True)


def run(eng, sp_cls, temperature, stagger=0):
    """Submit PROMPTS (the last two after ``stagger`` steps) and step until
    all finish; returns the requests and the tokens each on_token saw."""
    streams = [[] for _ in PROMPTS]

    def submit(i):
        return eng.submit(PROMPTS[i], sp(sp_cls, i, temperature),
                          on_token=lambda t, fin, i=i: streams[i].append(t))

    reqs = [submit(i) for i in range(2 if stagger else 4)]
    for _ in range(stagger):
        eng.step()
    reqs += [submit(i) for i in range(len(reqs), 4)]
    for _ in range(20000):
        if all(r.finished for r in reqs):
            break
        if not eng.step():
            time.sleep(0.001)
    assert all(r.finished for r in reqs)
    return reqs, streams


@pytest.fixture(scope="module")
def roomy_outputs(weights):
    """Each prompt alone on an uncontended port engine, greedy and seeded."""
    out = {}
    for t in (0.0, 0.8):
        eng = port_engine(weights, **ROOMY)
        out[t] = [eng.generate(p, sp(SamplingParams, i, t)).output_ids
                  for i, p in enumerate(PROMPTS)]
        assert eng.stats.get("preemptions", 0) == 0
    return out


@pytest.mark.parametrize("stagger", [0, 3], ids=["together", "staggered"])
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "seeded"])
def test_page_oom_preempts_not_kills(weights, roomy_outputs, temperature, stagger):
    """An oversubscribed pool retracts victims instead of failing them: every
    request finishes by length with the tokens of its uncontended run, each
    token reaches on_token exactly once, and retraction really ran. Greedy:
    tokens and the retraction count equal the reference Engine's on the same
    schedule."""
    eng = port_engine(weights, **CONTENDED)
    reqs, streams = run(eng, SamplingParams, temperature, stagger)
    assert [r.finish_reason for r in reqs] == ["length"] * 4
    assert eng.stats.get("preemptions", 0) > 0
    assert streams == [r.output_ids for r in reqs]
    assert [r.output_ids for r in reqs] == roomy_outputs[temperature]
    assert eng.allocator.num_free + eng.radix.num_cached_pages == CONTENDED["num_pages"] - 1
    if temperature == 0.0:
        ref = ref_engine(weights, **CONTENDED)
        ref_reqs, _ = run(ref, RefSampling, temperature, stagger)
        assert eng.stats["preemptions"] == ref.stats["preemptions"]
        for prompt, r, w in zip(PROMPTS, reqs, ref_reqs):
            if r.output_ids != w.output_ids:
                step = next(i for i, (a, b) in enumerate(zip(r.output_ids, w.output_ids))
                            if a != b)
                gap = ref_top2_gap(weights, prompt + w.output_ids[:step])
                assert gap < NEAR_TIE, f"prompt {prompt}: parted at token {step}, gap {gap}"


def test_victim_is_the_request_with_most_budget_left(weights):
    """_pick_victim: the occupied slot with the most tokens still to make,
    ties to the youngest; the asking request only when it is alone."""
    eng = port_engine(weights, **ROOMY)
    a = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=10))
    b = eng.submit([4, 5, 6], SamplingParams(max_new_tokens=10))
    c = eng.submit([7, 8, 9], SamplingParams(max_new_tokens=5))
    assert eng._pick_victim() is None
    eng._admit()  # into the slots, nothing run
    assert eng._pick_victim(prefer_not=a) is b
    assert eng._pick_victim(prefer_not=b) is a
    assert eng._pick_victim() is b
    eng.cancel(b)
    eng.cancel(c)
    assert eng._pick_victim(prefer_not=a) is a


def test_async_engine_streams_end_on_a_dry_pool(weights):
    """ROADMAP F1's case through each package's AsyncEngine: both streams end
    with 4 tokens each, and the port retracts as often as the reference. The
    engine's lock is held until both requests are queued, so the scheduler
    thread admits them together (as the F1 report had it) whatever the
    host's timing."""
    async def both(ae, sp_cls):
        eng = ae.engine
        with eng._lock:  # step() waits: nothing is admitted yet
            tasks = [asyncio.ensure_future(ae.generate(p, sp_cls(max_new_tokens=4)))
                     for p in F1_PROMPTS]
            for _ in range(1000):
                await asyncio.sleep(0.001)
                if eng.waiting.qsize() == len(F1_PROMPTS):
                    break
        reqs = await asyncio.wait_for(asyncio.gather(*tasks), timeout=60)
        return [r.output_ids for r in reqs], [r.finish_reason for r in reqs]

    port = AsyncEngine(port_engine(weights, **F1))
    ref = RefAsyncEngine(ref_engine(weights, **F1))
    try:
        got, why = asyncio.run(both(port, SamplingParams))
        want, ref_why = asyncio.run(both(ref, RefSampling))
    finally:
        port.shutdown()
        ref.shutdown()
    assert why == ref_why == ["length", "length"]
    assert got == want and all(len(t) == 4 for t in got)
    assert port.engine.stats["preemptions"] == ref.engine.stats["preemptions"] >= 1


def test_sjf_admission_orders_by_prompt_len(weights):
    """With one slot, SJF finishes the short request first."""
    eng = port_engine(weights, max_batch_slots=1, page_size=8, num_pages=64, max_context=64,
                      prefill_buckets=(8, 16, 32), admission_policy="sjf")
    long_r = eng.submit(list(range(1, 30)), SamplingParams(max_new_tokens=2))
    short_r = eng.submit([7, 8], SamplingParams(max_new_tokens=2))
    while not (long_r.finished and short_r.finished):
        eng.step()
    assert short_r.finish_t < long_r.finish_t
