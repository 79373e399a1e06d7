"""The port's pipeline parallelism (``wrinklefree_tpu_torch/parallel/
pipeline.py`` on ``torch.distributed``) against the JAX package's, on the
CPU.

``tests/test_pipeline.py``'s configuration (4 layers, bf16) on the
reference's ``init_params(seed=0)`` weights taken through numpy. The port
runs on gloo worlds of 2 and 4 spawned ranks as a stage axis
(``tests/_torch_dist.py::pipeline_cases``, each world once for the module)
and at one stage in this process (a stage axis of one, no process group).

Tolerances and their ground:

- against the port's own ``forward`` and against the reference's
  ``make_pp_forward`` (logits and every rank's cache shard beside the
  reference's shard on the same device index): the reference test's own
  2e-2 absolute (3e-2 for the decode step), the argmax equal. A pipeline
  stage runs the same exact integer dots; what moves is bf16 rounding of
  attention and norms computed on other shapes (XLA fuses its jitted body),
  an int8 code at a rounding boundary now and then;
- the port at 2 and 4 stages against itself at one stage, the same
  microbatches: none (bitwise). Each stage runs the same operations on the
  same shapes; the shift and the broadcast copy bits;
- the shards of ``shard_params_pp`` against the reference's
  ``NamedSharding`` shards, and ``stage_partition_specs``: none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests._torch_dist import axis_collectives_expected, pp_case, run_worlds
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.models.bitnet import KVCache as RefKVCache
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu.parallel import pipeline as rp
from wrinklefree_tpu_torch.config import BitNetConfig
from wrinklefree_tpu_torch.models.bitnet import KVCache, forward
from wrinklefree_tpu_torch.parallel import pipeline as pp
from wrinklefree_tpu_torch.parallel.sharding import Axis, NamedMesh
from wrinklefree_tpu_torch.weights import params_from_numpy

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4, num_heads=4,
           num_kv_heads=2, head_dim=16, max_position=64)
S_LEN, T = 8, 16


def _case(stages, microbatches, seed=0, decode=False):
    rng = np.random.default_rng(seed)
    B = 4 if decode else microbatches * 2
    return dict(stages=stages, microbatches=microbatches, T=T, decode=decode,
                tokens=rng.integers(0, CFG["vocab_size"], (B, S_LEN)).astype(np.int32))


# the reference test's four cases: (stages, microbatches) prefills, then a
# prefill and one decode step at 2 stages
CASES = {"2x2": _case(2, 2), "4x2": _case(4, 2), "2x4": _case(2, 4),
         "decode": _case(2, 2, seed=1, decode=True)}


@pytest.fixture(scope="module")
def ref_params():
    return ref_init(RefConfig(**CFG), seed=0)


@pytest.fixture(scope="module")
def np_params(ref_params):
    return jax.tree.map(np.asarray, ref_params)


@pytest.fixture(scope="module")
def port_params(np_params):
    return params_from_numpy(np_params, BitNetConfig(**CFG), device="cpu")


@pytest.fixture(scope="module")
def port_out(np_params):
    return run_worlds((2, 4), "pipeline_cases",
                      dict(params=np_params, cfg=CFG, cases=CASES))


@pytest.fixture(scope="module")
def one_stage(port_params):
    """Each case at one stage (the same microbatches) in this process."""
    mesh = NamedMesh({"stage": 1}, {"stage": Axis.local("stage")}, torch.device("cpu"), "gloo")
    sp = pp.shard_params_pp(port_params, mesh)
    return {name: pp_case(sp, BitNetConfig(**CFG), mesh, c) for name, c in CASES.items()}


def _ref_run(ref_params, case):
    cfg = RefConfig(**CFG)
    devs = jax.devices()[:case["stages"]]
    mesh = Mesh(np.asarray(devs), ("stage",))
    f = rp.make_pp_forward(cfg, mesh, num_microbatches=case["microbatches"])
    sparams = rp.shard_params_pp(ref_params, mesh)
    toks = jnp.asarray(case["tokens"])
    B = toks.shape[0]
    logits, cache = f(sparams, toks, RefKVCache.zeros(cfg, B, T), jnp.zeros((B,), jnp.int32))
    out = [np.asarray(logits)]
    if case["decode"]:
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        logits2, cache = f(sparams, nxt, cache, jnp.full((B,), S_LEN, jnp.int32))
        out.append(np.asarray(logits2))
    return out, cache, devs


def _port_forward(port_params, case):
    cfg = BitNetConfig(**CFG)
    toks = torch.from_numpy(case["tokens"])
    B = toks.shape[0]
    cache = KVCache.zeros(cfg, B, T, device="cpu")
    logits, cache = forward(port_params, cfg, toks, cache, torch.zeros(B, dtype=torch.int32),
                            logits_all=False)
    out = [logits.numpy()]
    if case["decode"]:
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        logits2, cache = forward(port_params, cfg, nxt, cache,
                                 torch.full((B,), S_LEN, dtype=torch.int32), logits_all=False)
        out.append(logits2.numpy())
    return out, cache


def _ranks(port_out, name):
    return port_out[CASES[name]["stages"]]


@pytest.mark.parametrize("name", list(CASES))
def test_pp_matches_port_forward(port_out, port_params, name):
    """Every stage's logits and cache shard against the port's single-device
    ``forward`` (the reference test's oracle), at 2e-2 (3e-2 after the
    decode step), the argmax equal."""
    want, cache = _port_forward(port_params, CASES[name])
    L = CFG["num_layers"]
    for r in _ranks(port_out, name):
        got = r["cases"][name]
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w, atol=2e-2 if i == 0 else 3e-2, rtol=0)
            assert np.array_equal(g.argmax(-1), w.argmax(-1))
        n = L // len(_ranks(port_out, name))
        rows = slice(r["stage"] * n, (r["stage"] + 1) * n)
        for key in ("k", "v"):
            full = getattr(cache, key)[rows].float().numpy()
            np.testing.assert_allclose(got[key], full, atol=2e-2, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_pp_matches_reference_pp(port_out, ref_params, name):
    """Every rank's logits and cache shard against the reference's
    ``make_pp_forward`` at the same stages and microbatches, the cache
    against the reference's shard on the same device index: 2e-2 (3e-2
    after the decode step), the argmax equal."""
    want, cache, devs = _ref_run(ref_params, CASES[name])
    for r in _ranks(port_out, name):
        got = r["cases"][name]
        assert len(got["logits"]) == len(want)
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=2e-2 if i == 0 else 3e-2, rtol=0)
            assert np.array_equal(g.argmax(-1), w.argmax(-1))
        for key in ("k", "v"):
            (shard,) = [s.data for s in getattr(cache, key).addressable_shards
                        if s.device == devs[r["stage"]]]
            shard = np.asarray(shard, np.float32)
            assert got[key].shape == shard.shape
            np.testing.assert_allclose(got[key], shard, atol=2e-2, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_pp_stages_bitwise_equal_one_stage(port_out, one_stage, name):
    """Tolerance: none. At 2 and 4 stages every rank's logits equal the
    one-stage run's with the same microbatches bit for bit, and its cache
    shard the one-stage cache's layers of that stage; a forward makes
    S+M-1 shifts and one broadcast on every rank."""
    ref = one_stage[name]
    ranks = _ranks(port_out, name)
    S, M = CASES[name]["stages"], CASES[name]["microbatches"]
    n = CFG["num_layers"] // S
    for r in ranks:
        got = r["cases"][name]
        for g, w in zip(got["logits"], ref["logits"]):
            assert np.array_equal(g, w)
        rows = slice(r["stage"] * n, (r["stage"] + 1) * n)
        for key in ("k", "v"):
            assert np.array_equal(got[key], ref[key][rows])
        calls = len(got["logits"])
        assert got["calls"] == {"ppermute": calls * (S + M - 1), "broadcast": calls}
    assert ref["calls"] == {"ppermute": len(ref["logits"]) * M, "broadcast": len(ref["logits"])}


def test_stage_partition_specs_equal_reference(np_params):
    want = rp.stage_partition_specs(np_params)
    got = pp.stage_partition_specs(np_params)
    assert want.keys() == got.keys() and want["layers"].keys() == got["layers"].keys()
    for k in ("embed", "final_norm"):
        assert tuple(want[k]) == got[k]
    for k in want["layers"]:
        assert tuple(want["layers"][k]) == got["layers"][k] == ("stage",)
    untied = {**np_params, "lm_head": np_params["embed"]}
    assert tuple(rp.stage_partition_specs(untied)["lm_head"]) == \
        pp.stage_partition_specs(untied)["lm_head"] == ()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("stages", [2, 4])
def test_shard_params_pp_equal_reference_shards(port_out, ref_params, stages):
    """Tolerance: none. Rank r's leaves equal the reference's NamedSharding
    shard on device r of a stage mesh of the same size: layers
    [r*L/S, (r+1)*L/S), the embedding and the final norm whole."""
    mesh = Mesh(np.asarray(jax.devices()[:stages]), ("stage",))
    sharded = _flat(rp.shard_params_pp(ref_params, mesh))
    devs = list(mesh.devices.reshape(-1))
    for r in port_out[stages]:
        got = _flat(r["shards"])
        assert got.keys() == sharded.keys()
        for k, arr in sharded.items():
            (shard,) = [s.data for s in arr.addressable_shards if s.device == devs[r["stage"]]]
            want = np.asarray(shard)
            if want.dtype == jnp.bfloat16:  # the port's tree holds bf16 as f32
                want = want.astype(np.float32)
            assert got[k].dtype == want.dtype and np.array_equal(got[k], want), (k, r["stage"])
        assert got["layers/o_qw"].shape[0] == CFG["num_layers"] // stages


@pytest.mark.parametrize("stages", [2, 4])
def test_pp_raises(port_out, stages):
    """S + 1 layers on S stages, and a batch of 3 rows in 2 microbatches,
    raise ``ValueError`` (the reference raises on the first; its reshape
    fails on the second)."""
    for r in port_out[stages]:
        assert f"num_layers {stages + 1} % stages {stages}" in (r["errors"]["layers"] or "")
        assert "not divisible by 2 microbatches" in (r["errors"]["batch"] or "")
    with pytest.raises(ValueError):
        rp.make_pp_forward(RefConfig(**dict(CFG, num_layers=stages + 1)),
                           Mesh(np.asarray(jax.devices()[:stages]), ("stage",)))


@pytest.mark.parametrize("world", [2, 4])
def test_axis_collectives(port_out, world):
    """Tolerance: none. ``Axis.ppermute`` (the pipeline's ring shift; a
    single pair, after which the ranks it does not send to hold zeros, as
    ``lax.ppermute`` leaves them), ``Axis.all_to_all`` (``lax.all_to_all``
    on axis 0) and ``Axis.broadcast`` move each rank's bits where the
    reference's collectives put them; each counted once."""
    for r in port_out[world]:
        got, calls = r["collectives"]
        want = axis_collectives_expected(r["stage"], world)
        assert got.keys() == want.keys()
        for k, (dev, v) in got.items():
            assert dev == "cpu" and v.dtype == np.float32 and np.array_equal(v, want[k]), k
        assert calls == {"ppermute": 2, "all_to_all": 1, "broadcast": 1}
