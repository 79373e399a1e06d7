"""The port's data-parallel replica router and global mesh
(``wrinklefree_tpu_torch/parallel/router.py``, ``multihost.py``): every case
of ``tests/test_router.py``, mirrored on the port's engines (the tiny model
in f32 on the reference's ``init_params(seed=0)`` weights; the replicas'
greedy tokens equal the reference ``Engine``'s, tolerance: none), and
``global_mesh`` on a gloo world of 4 spawned ranks laid out 2 x 2
(``tests/_torch_dist.py``)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests._torch_dist import run_worlds
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
from wrinklefree_tpu.engine import Engine as RefEngine
from wrinklefree_tpu.engine import SamplingParams as RefSampling
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.engine import Engine, SamplingParams
from wrinklefree_tpu_torch.parallel import ReplicaRouter, global_mesh, init_multihost
from wrinklefree_tpu_torch.weights import params_from_numpy

TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=32, max_position=256)
ECFG = dict(max_batch_slots=2, page_size=8, num_pages=64, max_context=64,
            prefill_buckets=(8, 16, 32))
CFG = BitNetConfig(**TINY, dtype=torch.float32)


@pytest.fixture(scope="module")
def ref_params():
    return ref_init(RefConfig(**TINY, dtype=jnp.float32), seed=0)


@pytest.fixture(scope="module")
def params(ref_params):
    return params_from_numpy(jax.tree.map(np.asarray, ref_params), CFG, device="cpu")


def _mk(params, **kw):
    return ReplicaRouter([Engine(params, CFG, EngineConfig(**ECFG), device="cpu")
                          for _ in range(2)], **kw)


@pytest.fixture(scope="module")
def router(params):
    return _mk(params)


class TestReplicaRouter:
    def test_replicas_agree(self, router, ref_params):
        outs = [router.generate([1, 2, 3], SamplingParams(max_new_tokens=6)).output_ids
                for _ in range(4)]
        assert all(o == outs[0] for o in outs), "replicas diverge"
        ref = RefEngine(ref_params, RefConfig(**TINY, dtype=jnp.float32),
                        RefEngineConfig(**ECFG))
        assert outs[0] == ref.generate([1, 2, 3], RefSampling(max_new_tokens=6)).output_ids

    def test_spreads_load(self, router):
        # saturate replica 0's slots, then the next pick must be replica 1
        e0 = router.engines[0]
        r = e0.submit([1, 2, 3], SamplingParams(max_new_tokens=2))
        assert router.pick() is not e0 or router._load(e0) == 0
        while not r.finished:
            e0.step()

    def test_concurrent_generate(self, router):
        results = [None] * 8

        def worker(i):
            results[i] = router.generate([1 + i, 2, 3], SamplingParams(max_new_tokens=4))

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert all(r is not None and len(r.output_ids) <= 4 for r in results)

    def test_aggregated_stats(self, router):
        s = router.stats
        assert s["replicas"] == 2 and s["requests"] >= 4


@pytest.fixture(scope="module")
def world_mesh():
    return run_worlds((4,), "mesh_cases", dict(local_world=2, port=None))[4]


class TestMultihost:
    def test_single_process_noop(self):
        assert init_multihost() == (0, 1)
        assert not torch.distributed.is_initialized()

    def test_global_mesh_shapes(self, world_mesh):
        """A world of 4 with 2 ranks per host: the default global mesh is
        2 x 2, the model axis innermost (consecutive ranks), the data axis
        across; psums over each axis and a tiled gather over the model axis
        in rank order; dp*tp != world and NCCL on the CPU raise."""
        for r, out in enumerate(world_mesh):
            shape, d, m, model_ranks, data_ranks, leader = out["default"]
            assert shape == {"data": 2, "model": 2}
            assert (d, m) == divmod(r, 2)
            assert model_ranks == (2 * d, 2 * d + 1) and data_ranks == (m, m + 2)
            assert leader == 2 * d
            assert out["model_psum"] == float(4 * d + 1)
            assert out["data_psum"] == float(2 * m + 2)
            assert out["gather"] == [[float(2 * d), float(2 * d + 1)]] * 2
            assert "3*4 != 4" in out["errors"]["bad_split"]
            assert "NCCL" in out["errors"]["nccl_on_cpu"]


class TestCacheAwareRouting:
    """A request whose prompt has a cached prefix on some replica routes
    there (within the load slack); fresh prompts still spread."""

    def test_routes_to_cached_replica(self, params):
        router = _mk(params)
        shared = list(range(1, 25))  # 24 tokens = 3 full pages
        e1 = router.engines[1]
        e1.generate(shared + [30], SamplingParams(max_new_tokens=4))
        assert e1.prefix_match_len(shared) >= 16
        for _ in range(3):
            assert router.pick(shared + [31]) is e1
        hits0 = e1.stats["radix_hit_tokens"]
        r = router.generate(shared + [31], SamplingParams(max_new_tokens=4))
        assert e1.stats["radix_hit_tokens"] > hits0
        assert len(r.output_ids) == 4

    def test_fresh_prompts_spread(self, params):
        router = _mk(params)
        picks = {id(router.pick([7, 7, 7])) for _ in range(4)}
        assert len(picks) == 2  # no cached prefix anywhere: round-robin

    def test_load_slack_bounds_hotspotting(self, params):
        router = _mk(params)
        router.load_slack = 0
        shared = list(range(1, 25))
        e1 = router.engines[1]
        e1.generate(shared + [30], SamplingParams(max_new_tokens=2))
        held = [e1.submit([40 + i], SamplingParams(max_new_tokens=2)) for i in range(3)]
        assert router.pick(shared + [31]) is router.engines[0]
        while not all(h.finished for h in held):
            e1.step()

    def test_cache_aware_off(self, params):
        router = _mk(params, cache_aware=False)
        shared = list(range(1, 25))
        router.engines[1].generate(shared + [30], SamplingParams(max_new_tokens=2))
        picks = {id(router.pick(shared + [31])) for _ in range(4)}
        assert len(picks) == 2  # pure least-loaded/round-robin


def test_global_mesh_single_process_default():
    """Without a process group the world is one rank: a mesh of more raises
    (before forming any group)."""
    with pytest.raises(ValueError, match="2\\*1 != 1 ranks"):
        global_mesh(dp=2, tp=1, device="cpu")
    assert not torch.distributed.is_initialized()
