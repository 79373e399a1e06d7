"""The port's ring attention (``wrinklefree_tpu_torch/ops/ring_attention.py``)
against the JAX package's, on the CPU.

The port runs on gloo worlds of 1, 2 and 4 spawned ranks
(``tests/_torch_dist.py``: each world once for the whole module, every case
in it); the reference's ``make_ring_attention`` runs on as many virtual CPU
devices (``tests/conftest.py``), on the same inputs made from a seed with
numpy: the cases of ``tests/test_ring_attention.py`` (causal, non-causal,
MHA, bf16) and a q block at a global offset (``q_offset``, the chunked
prefill's). f32 outputs agree within 1e-5; bf16 outputs at their rounding
point (at most one bf16 step apart). ``_block_attend`` agrees within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests._torch_dist import run_worlds
from wrinklefree_tpu.ops import ring_attention as ref_ring
from wrinklefree_tpu_torch.ops import ring_attention as ring

WORLDS = (1, 2, 4)
F32_TOL = 1e-5


def _qkv(B=2, S=32, NH=4, KV=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, S, NH, D)).astype(np.float32),
            rng.normal(0, 1, (B, S, KV, D)).astype(np.float32),
            rng.normal(0, 1, (B, S, KV, D)).astype(np.float32))


def _case(seed, dtype="float32", causal=True, q_offset=None, **shape):
    q, k, v = _qkv(seed=seed, **shape)
    return dict(q=q, k=k, v=v, dtype=dtype, causal=causal, q_offset=q_offset)


CASES = {
    "causal": _case(0),
    "noncausal": _case(1, causal=False),
    "bf16": _case(2, dtype="bfloat16"),
    "mha": _case(3, NH=4, KV=4),
    "q_offset": _case(4, q_offset=np.array([0, 5], np.int64)),
}


@pytest.fixture(scope="module")
def port_out():
    return run_worlds(WORLDS, "ring_cases", CASES)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("seq",))


def _reference(n, c):
    dt = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(c[x], dt) for x in ("q", "k", "v"))
    mesh = _mesh(n)
    if c["q_offset"] is None:
        return ref_ring.make_ring_attention(mesh, causal=c["causal"])(q, k, v)
    spec = P(None, "seq")
    fn = shard_map(
        lambda q, k, v, off: ref_ring.ring_attention(q, k, v, "seq", causal=c["causal"],
                                                     q_offset=off),
        mesh=mesh, in_specs=(spec, spec, spec, P()), out_specs=spec, check_rep=False)
    return jax.jit(fn)(q, k, v, jnp.asarray(c["q_offset"], jnp.int32))


def _bf16_step(x):
    """One bf16 step (ulp) at the magnitude of each value."""
    mag = np.maximum(np.abs(x), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_ring_attention_matches_reference(port_out, world, name):
    c = CASES[name]
    ranks = port_out[world]
    got, dtype = ranks[0][name]
    for other in ranks[1:]:  # every rank returns the same gathered output
        np.testing.assert_array_equal(other[name][0], got)
    want = np.asarray(_reference(world, c), np.float32)
    assert got.shape == want.shape
    if c["dtype"] == "bfloat16":
        assert dtype == "torch.bfloat16"
        diff = np.abs(got - want)
        step = np.maximum(_bf16_step(got), _bf16_step(want))
        assert (diff <= step).all(), float((diff / step).max())
    else:
        assert dtype == "torch.float32"
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_attend_matches_reference(dtype):
    """One block's (m, l, acc), rows that see no key included (m = 0, l =
    0, acc = 0), in f32 from f32 or bf16 inputs."""
    rng = np.random.default_rng(7)
    q = rng.normal(0, 1, (2, 8, 4, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, 12, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, 12, 2, 16)).astype(np.float32)
    q_pos = np.array([np.arange(8) + 2, np.arange(8) + 9], np.int32)  # some see no key
    k_pos = np.arange(12, dtype=np.int32) + 4
    scale = 1.0 / np.sqrt(16)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    want = ref_ring._block_attend(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                  jnp.asarray(q_pos), jnp.asarray(k_pos), scale)
    got = ring._block_attend(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
                             torch.from_numpy(v).to(tdt), torch.from_numpy(q_pos).long(),
                             torch.from_numpy(k_pos).long(), scale)
    assert (np.asarray(want[1]) == 0).any()  # rows with no visible key
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL, atol=F32_TOL)


def test_make_ring_attention_rejects_ragged_shards(monkeypatch):
    """S must split evenly over the ranks, as shard_map requires."""
    monkeypatch.setattr(ring, "group_size_rank", lambda group: (3, 0))  # a world of 3
    with pytest.raises(ValueError, match="not a multiple"):
        ring.make_ring_attention()(*(torch.zeros(1, 4, 2, 8) for _ in range(3)))
