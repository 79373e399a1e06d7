"""The port's sharding (``wrinklefree_tpu_torch/parallel/sharding.py`` on
``torch.distributed``) against the JAX package's, on the CPU.

``tests/test_sharding.py``'s configurations in f32 on the reference's
``init_params(seed=0)`` weights: the repack bitwise against
``repack_params_for_tp``; every rank's shard of every leaf bitwise against
the reference's ``NamedSharding`` shard on the same device index of a
``(1, tp)`` mesh; the partition specs and the KV-replication decider equal
to the reference's; and ``make_tp_forward`` (a prefill with every position's
logits, then a decode step) at n_model 1, 2 and 4, and 2 x 2 with a data
axis, against the reference's ``make_tp_forward`` on as many of the 8
virtual CPU devices. The port runs on gloo worlds of 1, 2 and 4 spawned
ranks (``tests/_torch_dist.py``, each world once for the module).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests._torch_dist import run_worlds
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.models.bitnet import KVCache as RefKVCache
from wrinklefree_tpu.models.bitnet import forward as ref_forward
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu.parallel import sharding as rs
from wrinklefree_tpu_torch.config import BitNetConfig
from wrinklefree_tpu_torch.models.bitnet import tp_local_kv_heads
from wrinklefree_tpu_torch.parallel import sharding as ps

CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=8,
           num_kv_heads=4, head_dim=32, max_position=128)
FLAGSHIP = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=20, num_kv_heads=5, head_dim=8, max_position=128)
MODELS = {"cfg": CFG, "flagship": FLAGSHIP}
B, S = 2, 8


def _tokens(seed, model):
    rng = np.random.default_rng(seed)
    v = MODELS[model]["vocab_size"]
    return (rng.integers(0, v, size=(B, S)).astype(np.int32),
            rng.integers(0, v, size=(B, 1)).astype(np.int32))


# name: (model, n_data, n_model, seed of the tokens)
FORWARD = {"1x1": ("cfg", 1, 1, 0), "1x2": ("cfg", 1, 2, 0), "1x4": ("cfg", 1, 4, 0),
           "2x2": ("cfg", 2, 2, 1), "flagship_1x4": ("flagship", 1, 4, 3),
           "flagship_1x2": ("flagship", 1, 2, 3)}


@pytest.fixture(scope="module")
def ref_params():
    return {n: ref_init(RefConfig(**kw, dtype=jnp.float32), seed=0) for n, kw in MODELS.items()}


@pytest.fixture(scope="module")
def np_params(ref_params):
    return {n: jax.tree.map(np.asarray, p) for n, p in ref_params.items()}


@pytest.fixture(scope="module")
def port_out(np_params):
    fwd = {name: (m, nd, nm, *_tokens(seed, m)) for name, (m, nd, nm, seed) in FORWARD.items()}
    models = {n: (np_params[n], MODELS[n]) for n in MODELS}
    return run_worlds((1, 2, 4), "sharding_cases", dict(models=models, forward=fwd))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("tp", [2, 4, 5])
def test_repack_bitwise_equal_to_reference(np_params, tp):
    """Tolerance: none. Every leaf of the port's repack equals the
    reference's (o/down repacked per K/tp chunk, the rest untouched)."""
    cfg = dict(CFG, intermediate_size=640, num_heads=10, num_kv_heads=5) if tp == 5 else CFG
    p = jax.tree.map(np.asarray, ref_init(RefConfig(**cfg, dtype=jnp.float32), seed=0)) \
        if tp == 5 else np_params["cfg"]
    want = _flat(jax.tree.map(np.asarray, rs.repack_params_for_tp(p, tp)))
    got = _flat(ps.repack_params_for_tp(p, tp))
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), want[k]), k
    assert np.array_equal(got["layers/o_qw"], want["layers/o_qw"])
    assert not np.array_equal(got["layers/o_qw"], p["layers"]["o_qw"])


def test_repack_preserves_weights(np_params):
    """The repacked o/down unpack, chunk by chunk, to the original matrix."""
    from wrinklefree_tpu_torch.ops.ternary import unpack_ternary_np

    p2 = ps.repack_params_for_tp(np_params["cfg"], 4)
    for name in ("o", "down"):
        w0 = unpack_ternary_np(np_params["cfg"]["layers"][f"{name}_qw"][0])
        chunks = np.split(p2["layers"][f"{name}_qw"][0], 4, axis=0)
        assert np.array_equal(np.concatenate([unpack_ternary_np(c) for c in chunks]), w0)


@pytest.mark.parametrize("model,tp", [("cfg", 2), ("cfg", 4), ("flagship", 2),
                                      ("flagship", 4)])
def test_rank_shards_equal_reference_named_shards(port_out, ref_params, model, tp):
    """Tolerance: none. Rank r's shard of every leaf equals the reference's
    NamedSharding shard on device r of a (1, tp) mesh."""
    cfg = RefConfig(**MODELS[model], dtype=jnp.float32)
    rep = rs.tp_kv_replicated(cfg, tp)
    mesh = rs.make_mesh(1, tp)
    sharded = _flat(rs.shard_params(rs.repack_params_for_tp(ref_params[model], tp), mesh,
                                    kv_replicated=rep))
    devices = list(mesh.devices.reshape(-1))
    for rank_out in port_out[tp]:
        idx, got_rep, tree = rank_out["shards"][model]
        assert got_rep == rep
        got = _flat(tree)
        assert got.keys() == sharded.keys()
        for k, arr in sharded.items():
            (shard,) = [s.data for s in arr.addressable_shards if s.device == devices[idx]]
            assert np.array_equal(got[k], np.asarray(shard)), (k, idx)


@pytest.mark.parametrize("model,rep", [("cfg", False), ("cfg", True), ("flagship", True)])
def test_partition_specs_equal_reference(np_params, model, rep):
    want = rs.param_partition_specs(np_params[model], rep)
    got = ps.param_partition_specs(np_params[model], rep)
    flat_w, flat_g = _flat(want), _flat(got)
    assert flat_w.keys() == flat_g.keys()
    for k in flat_w:
        assert tuple(flat_w[k]) == flat_g[k], k


def test_kv_replicated_decider():
    """The decider's answers (and its refusal) equal the reference's."""
    from wrinklefree_tpu.config import BitNetConfig as RC

    cases = [(BitNetConfig.bitnet_2b(), RC.bitnet_2b()),
             (BitNetConfig.llama3_8b_ternary(), RC.llama3_8b_ternary()),
             (BitNetConfig.tiny(), RC.tiny())]
    for port_cfg, ref_cfg in cases:
        for tp in (1, 2, 4, 5, 8):
            try:
                want = rs.tp_kv_replicated(ref_cfg, tp)
            except ValueError:
                with pytest.raises(ValueError):
                    ps.tp_kv_replicated(port_cfg, tp)
                continue
            assert ps.tp_kv_replicated(port_cfg, tp) is want, (port_cfg, tp)
    flagship = BitNetConfig.bitnet_2b()
    assert ps.tp_kv_replicated(flagship, 2) and ps.tp_kv_replicated(flagship, 4)
    assert not ps.tp_kv_replicated(flagship, 5)
    llama = BitNetConfig.llama3_8b_ternary()
    for cfg, tp, heads in ((flagship, 4, 5), (llama, 2, 4), (llama, 4, 2)):
        axis = types.SimpleNamespace(size=tp)
        assert tp_local_kv_heads(cfg, axis, ps.tp_kv_replicated(cfg, tp)) == heads


def _ref_tp_logits(ref_params, model, nd, nm, toks, nxt):
    cfg = RefConfig(**MODELS[model], dtype=jnp.float32)
    rep = rs.tp_kv_replicated(cfg, nm)
    mesh = rs.make_mesh(nd, nm)
    params = rs.shard_params(rs.repack_params_for_tp(ref_params[model], nm), mesh,
                             kv_replicated=rep)
    cspec = rs.cache_partition_spec(rep)
    cache = RefKVCache.zeros(cfg, B, 32)
    cache = RefKVCache(jax.device_put(cache.k, NamedSharding(mesh, cspec)),
                       jax.device_put(cache.v, NamedSharding(mesh, cspec)))
    step = rs.make_tp_forward(cfg, mesh, logits_all=True)
    a, cache = step(params, jnp.asarray(toks), cache, jnp.zeros((B,), jnp.int32))
    step1 = rs.make_tp_forward(cfg, mesh)
    b, _ = step1(params, jnp.asarray(nxt), cache, jnp.full((B,), S, jnp.int32))
    ref_cache = RefKVCache.zeros(cfg, B, 32)
    single, ref_cache = ref_forward(ref_params[model], cfg, jnp.asarray(toks), ref_cache,
                                    jnp.zeros((B,), jnp.int32))
    single1, _ = ref_forward(ref_params[model], cfg, jnp.asarray(nxt), ref_cache,
                             jnp.full((B,), S, jnp.int32), logits_all=False)
    return np.asarray(a), np.asarray(b), np.asarray(single), np.asarray(single1)


@pytest.mark.parametrize("name", list(FORWARD))
def test_tp_forward_matches_reference(port_out, ref_params, name):
    """The prefill's every position and the decode step of the port's
    ``make_tp_forward`` against the reference's ``make_tp_forward`` at the
    same mesh and against its single-device forward, under the reference
    test's own bound: 0.05 absolute on f32 logits, greedy tokens agreeing at
    90% of the positions. (An int8 activation code at a rounding boundary
    flips with the order of a sum: the reference's own TP forward parts from
    its single-device one by 8e-3 here, and the port's from either by up to
    as much; where no code flips they agree to 1e-6.) Every rank returns the
    whole logits; the cache holds the rank's batch rows and local KV heads."""
    model, nd, nm, seed = FORWARD[name]
    toks, nxt = _tokens(seed, model)
    ra, rb, single, single1 = _ref_tp_logits(ref_params, model, nd, nm, toks, nxt)
    cfg = BitNetConfig(**MODELS[model])
    heads = cfg.num_kv_heads if ps.tp_kv_replicated(cfg, nm) else cfg.num_kv_heads // nm
    for rank_out in port_out[nd * nm]:
        a, b, cache_shape, calls = rank_out["forward"][name]
        assert a.shape == ra.shape == single.shape and b.shape == rb.shape == single1.shape
        for got, want in ((a, ra), (a, single), (b, rb), (b, single1)):
            np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
            assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
        assert cache_shape == (cfg.num_layers, B // nd, 32, heads, cfg.head_dim)
        # per layer: o and down (a MAX for the absmax, a SUM of the partials),
        # two sub-norm SUMs; the embedding SUM and the logits' gather per call
        L = cfg.num_layers
        assert calls == {"psum": 2 * (4 * L + 1), "pmax": 2 * 2 * L, "all_gather": 2}
