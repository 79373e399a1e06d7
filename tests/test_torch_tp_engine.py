"""The port's tensor-parallel engine (``Engine(mesh=...)`` on
``torch.distributed``) against the JAX package's TP engine, on the CPU.

Every case of ``tests/test_tp_engine.py``, mirrored: the same configurations
in f32 (the reference's ``init_params(seed=0)`` weights carried over with
``weights.params_from_numpy``), the same prompts, sampling and engine
settings. Sampled streams run on layer-free weights (o and down set to
ternary zeros, as ``tests/test_torch_engine.py`` does): the residual stream
is then the token embedding, so both packages compute the same logits up to
f32 rounding; on the full model a draw over near-equal candidates parts even
between the reference's own TP and single-device engines. The port runs on
gloo worlds of 1, 2, 4 and 5 spawned ranks
(``tests/_torch_dist.py``: each world once for the module, every case of its
size in it; model rank 0 leads, the others ``follow()``); the reference on
as many of the 8 virtual CPU devices (``make_mesh(1, tp)``). Greedy and
seeded f32 tokens must equal the reference TP engine's exactly, every rank
must end with the leader's stats (the ranks ran in lockstep), and the pools
must hold the local KV heads: all of them where tp does not divide them (the
20/5 geometry at tp 2 and 4), KV/tp where it does (tp 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests._torch_dist import run_worlds
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
from wrinklefree_tpu.engine import Engine as RefEngine
from wrinklefree_tpu.engine import SamplingParams as RefSampling
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu.parallel.sharding import make_mesh as ref_mesh

ECFG = dict(max_batch_slots=2, page_size=8, num_pages=64, max_context=64,
            prefill_buckets=(8, 16, 32))
TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=32, max_position=256)
MOE = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=32, max_position=256, num_experts=4, num_experts_per_tok=2)
MOE6 = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=1, num_heads=4,
            num_kv_heads=4, head_dim=32, max_position=256, num_experts=6, num_experts_per_tok=2)
# the flagship's 20 query / 5 KV heads at a reduced width
FLAGSHIP = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=20, num_kv_heads=5, head_dim=8, max_position=256)
FLAGSHIP5 = dict(FLAGSHIP, vocab_size=250, intermediate_size=160)
MODELS = {"tiny": TINY, "moe": MOE, "moe6": MOE6, "flagship": FLAGSHIP,
          "flagship5": FLAGSHIP5, "tiny_lf": TINY, "flagship_lf": FLAGSHIP}

GREEDY = [([1, 5, 9, 2, 7], dict(max_new_tokens=8)), ([3, 3, 4], dict(max_new_tokens=8))]
SEEDED = dict(max_new_tokens=6, temperature=0.9, seed=11)
RADIX = [([1, 5, 9, 2, 7, 3, 4, 8], dict(max_new_tokens=8)),
         ([1, 5, 9, 2, 7, 3, 4, 8, 6], dict(max_new_tokens=4))]
CASES = {
    "tp1": dict(model="tiny", tp=1, ecfg=ECFG, runs=GREEDY),  # a mesh of one rank
    "tp2": dict(model="tiny", tp=2, ecfg=ECFG, runs=GREEDY),
    "tp2_seeded": dict(model="tiny_lf", tp=2, ecfg=ECFG, runs=[([2, 4, 6], SEEDED)] * 2),
    "bad_head_split": dict(model="tiny", tp=5, ecfg=ECFG, runs=[]),  # 4 heads % 5
    "tp2_radix": dict(model="tiny", tp=2, ecfg=ECFG, runs=RADIX),
    "tp2_exact": dict(model="tiny", tp=2, ecfg=dict(ECFG, exact_head_k=8), runs=GREEDY),
    "tp2_exact_sampling": dict(model="tiny_lf", tp=2, ecfg=dict(ECFG, exact_head_k=8),
                               runs=[([2, 4, 6], SEEDED)]),
    "tp2_moe": dict(model="moe", tp=2, ecfg=ECFG, runs=GREEDY),
    "bad_expert_split": dict(model="moe6", tp=4, ecfg=ECFG, runs=[]),  # 6 experts % 4
    "tp2_int8_logits": dict(model="tiny", tp=2, ecfg=dict(ECFG, int8_logits=True), runs=GREEDY),
    "flagship_tp2": dict(model="flagship", tp=2, ecfg=ECFG, runs=GREEDY),
    "flagship_tp4": dict(model="flagship", tp=4, ecfg=ECFG, runs=GREEDY),
    "flagship_tp4_sampling": dict(
        model="flagship_lf", tp=4, ecfg=ECFG,
        runs=[(p, dict(max_new_tokens=8, temperature=0.9, seed=13)) for p, _ in GREEDY]),
    "flagship_tp4_exact": dict(model="flagship", tp=4, ecfg=dict(ECFG, exact_head_k=8),
                               runs=GREEDY),
    "flagship5_tp5": dict(model="flagship5", tp=5, ecfg=ECFG,
                          runs=[([1, 5, 9], dict(max_new_tokens=8))]),
}
RAISES = {"bad_head_split", "bad_expert_split"}
# long context on a TP engine (``tests/_torch_dist.py::tp_long_case``): the
# ring on the model group at tp 2 and 4, prompts of max_context (64) tokens or
# more, one that P divides and one it does not; the single-device ring route
# in the world of one
LONG = dict(model="tiny", ecfg=ECFG, new=6, short_new=40, worlds=(1, 2, 4),
            longs=[np.random.default_rng(0).integers(1, 256, 96).tolist(),
                   np.random.default_rng(1).integers(1, 256, 99).tolist()],
            shorts=[[1, 5, 9, 2, 7], [3, 3, 4]])
# a full queue and a failed step at tp 2 (``tests/_torch_dist.py::tp_faults``)
FAULTS = dict(model="tiny", tp=2, ecfg=dict(ECFG, max_queue=3), fail_decode=3,
              prompts=[[1, 5, 9, 2, 7], [3, 3, 4]])


def _ref_params(name):
    p = ref_init(RefConfig(**MODELS[name], dtype=jnp.float32), seed=0)
    if name.endswith("_lf"):  # layer-free: o and down ternary zeros (0x55)
        layers = dict(p["layers"])
        for k in ("o_qw", "down_qw"):
            layers[k] = jnp.full_like(layers[k], 0x55)
        p = {**p, "layers": layers}
    return p


@pytest.fixture(scope="module")
def ref_params():
    return {name: _ref_params(name) for name in MODELS}


@pytest.fixture(scope="module")
def port_out(ref_params):
    models = {name: (jax.tree.map(np.asarray, ref_params[name]), MODELS[name])
              for name in MODELS}
    return run_worlds((1, 2, 4, 5), "tp_engine_cases",
                      dict(models=models, cases=CASES, faults=FAULTS, long=LONG))


_REF_CACHE = {}


def _ref_outs(name, ref_params):
    """The reference TP engine's output ids for a case's runs (one engine
    per case, as the port's)."""
    if name not in _REF_CACHE:
        c = CASES[name]
        cfg = RefConfig(**MODELS[c["model"]], dtype=jnp.float32)
        eng = RefEngine(ref_params[c["model"]], cfg, RefEngineConfig(**c["ecfg"]),
                        mesh=ref_mesh(1, c["tp"]))
        _REF_CACHE[name] = (eng, [eng.generate(p, RefSampling(**sp)).output_ids
                                  for p, sp in c["runs"]])
    return _REF_CACHE[name]


def _case(port_out, name):
    ranks = port_out[CASES[name]["tp"]]
    got = [r[name] for r in ranks]
    if name in RAISES:
        return got
    leader = got[0]
    for r in got[1:]:  # the followers ran the same steps
        assert r["outs"] is None
        assert r["stats"] == leader["stats"], (r["stats"], leader["stats"])
        assert r["messages"] == leader["messages"] > 0
        assert (r["kv_heads"], r["tp_kv_rep"]) == (leader["kv_heads"], leader["tp_kv_rep"])
    return leader


@pytest.mark.parametrize("name", [n for n in CASES if n not in RAISES])
def test_tp_engine_matches_reference(port_out, ref_params, name):
    """Tolerance: none. The f32 greedy and seeded tokens of every run equal
    the reference TP engine's; the ranks agree step for step."""
    got = _case(port_out, name)
    ref_eng, want = _ref_outs(name, ref_params)
    assert got["outs"] == want, (name, got["outs"], want)
    assert got["tp_kv_rep"] == ref_eng._tp_kv_rep
    assert got["stats"]["radix_hit_tokens"] == ref_eng.stats["radix_hit_tokens"]


def test_tp2_seeded_sampling_reproducible(port_out):
    a, b = _case(port_out, "tp2_seeded")["outs"]
    assert a == b and len(a) == 6


def test_tp2_radix_reuse(port_out):
    assert _case(port_out, "tp2_radix")["stats"]["radix_hit_tokens"] >= 8


def test_tp2_exact_and_int8_heads_against_plain(port_out):
    """The exact head under TP (vocab-sharded int8 scan + pmax/pmin combine)
    gives the TP bf16 head's greedy tokens; the int8 head runs."""
    plain = _case(port_out, "tp2")["outs"]
    assert _case(port_out, "tp2_exact")["outs"] == plain
    assert all(len(o) == 8 for o in _case(port_out, "tp2_int8_logits")["outs"])


@pytest.mark.parametrize("name,kind,match", [
    ("bad_head_split", "ValueError", "num_heads 4 not divisible by tp=5"),
    ("bad_expert_split", "ValueError", "num_experts 6 not divisible by tp=4"),
])
def test_tp_rejects_bad_splits(port_out, name, kind, match):
    for r in _case(port_out, name):
        assert r[0] == "raises" and r[1] == kind and match in r[2], r


@pytest.mark.parametrize("name,tp,heads,rep", [
    ("flagship_tp2", 2, 5, True), ("flagship_tp4", 4, 5, True),
    ("flagship5_tp5", 5, 1, False), ("tp2", 2, 1, False), ("tp2_moe", 2, 1, False),
    ("tp1", 1, 2, False),
])
def test_tp_pool_heads(port_out, name, tp, heads, rep):
    """A rank's pools: every KV head where tp does not divide them
    (replicated, the reference's ``_tp_kv_rep``), KV/tp where it does."""
    got = _case(port_out, name)
    assert (got["kv_heads"], got["tp_kv_rep"]) == (heads, rep)


def test_tp_full_queue_refused_at_submit(port_out, ref_params):
    """With every slot busy and ``max_queue`` requests queued, the TP
    leader's next ``submit`` raises ``queue.Full`` after the single device's
    5 s wait, as the port's single-device engine does in the same state; the
    busy and queued requests are then all served to their lengths."""
    import queue
    import time

    from tests._torch_dist import _model
    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams

    got = port_out[2][0]["faults"]
    slots, cap = ECFG["max_batch_slots"], FAULTS["ecfg"]["max_queue"]
    assert got["busy"] == slots and got["refused"] == "queue.Full"
    assert 4.9 <= got["waited"] < 30
    assert [len(o) for o in got["outs"]] == [48] * slots + [4] * cap
    assert set(got["reasons"]) == {"length"}
    models = {"tiny": (jax.tree.map(np.asarray, ref_params["tiny"]), MODELS["tiny"])}
    params, cfg = _model(models, "tiny")
    eng = Engine(params, cfg, EngineConfig(**FAULTS["ecfg"]), device="cpu")
    sp = SamplingParams(max_new_tokens=4)
    ps = FAULTS["prompts"]
    for i in range(slots):
        eng.submit(ps[i % len(ps)], SamplingParams(max_new_tokens=48))
    eng.step()
    assert sum(s is not None for s in eng.slots) == slots
    for i in range(cap):
        eng.submit(ps[i % len(ps)], sp)
    t0 = time.monotonic()
    with pytest.raises(queue.Full):
        eng.submit(ps[0], sp)
    assert time.monotonic() - t0 >= 4.9


def test_tp_followers_survive_a_failed_step(port_out):
    """A step that raises on every rank (the third decode, planted) reaches
    the leader's caller once; the follower logs it and goes on following, so
    the ranks serve every request and end with the same stats."""
    leader, follower = (r["faults"] for r in port_out[2])
    assert leader["errors"] == ["planted step failure"]
    assert follower["decodes"] == leader["decodes"] > FAULTS["fail_decode"]
    assert follower["stats"] == leader["stats"]
    assert leader["stats"]["requests"] == ECFG["max_batch_slots"] + FAULTS["ecfg"]["max_queue"]


# -- long context on a tensor-parallel engine ---------------------------------


def _long(port_out, tp):
    ranks = [r["long"] for r in port_out[tp]]
    for r in ranks[1:]:  # the followers ran the leader's steps and rings
        assert r["stats"] == ranks[0]["stats"], (r["stats"], ranks[0]["stats"])
    return ranks


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_long_context_matches_reference(port_out, ref_params, tp):
    """Tolerance: none. The f32 greedy tokens of a TP engine whose ring group
    is its model group, on a 96-token prompt (P divides it) and a 99-token
    one (it does not; max_context 64), equal the reference's
    ``Engine(mesh=make_mesh(1, tp), long_context_mesh=<a seq mesh of tp
    devices>)`` and the port's single-device ring route."""
    from jax.sharding import Mesh

    cfg = RefConfig(**MODELS["tiny"], dtype=jnp.float32)
    eng = RefEngine(ref_params["tiny"], cfg, RefEngineConfig(**ECFG), mesh=ref_mesh(1, tp),
                    long_context_mesh=Mesh(np.asarray(jax.devices()[:tp]), ("seq",)))
    want = [eng.generate(p, RefSampling(max_new_tokens=LONG["new"], temperature=0.0)).output_ids
            for p in LONG["longs"]]
    got = _long(port_out, tp)[0]["longs"]
    assert got == want, (got, want)
    assert got == port_out[1][0]["long"]["single"]
    assert all(len(t) == LONG["new"] for t in got)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_long_context_leaves_short_requests_alone(port_out, tp):
    """A short request stepped before a long one (in flight when the ring
    runs) and one submitted after it finish with the tokens they have alone,
    and the long one with its own: the ring runs at the leader's step,
    between two paged steps, on every rank."""
    lead = _long(port_out, tp)[0]
    a, r, b = lead["together"]
    assert 0 < lead["a_before"] < LONG["short_new"]
    assert (a, b) == tuple(lead["alone"]) and r == lead["longs"][0]
    assert lead["reason"] == "length"


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_long_context_refusals_and_snapshot(port_out, tp):
    """A sampled long prompt raises ``ValueError`` on the leader and records
    nothing; a group that is not the mesh's model ranks raises
    ``ValueError`` on every rank; every rank with the group keeps the
    unsharded snapshot."""
    ranks = _long(port_out, tp)
    assert "greedy-only" in ranks[0]["sampled"] and ranks[0]["recorded"] is False
    for r in ranks:
        assert r["snapshot"] is True
        assert "must be the mesh's model ranks" in r["foreign"], r["foreign"]
