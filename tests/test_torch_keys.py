"""The port's counter-keyed draws and samplers vs ``jax.random`` and the reference's.

``ops/sampling.py`` computes the reference's per-request keys
``fold_in(PRNGKey(seed), counter)`` and ``jax.random.gumbel(key, (c,))`` with
the threefry-2x32 hash in torch integer ops. Its 32-bit words must equal
JAX's bit for bit over a grid of seeds (0, 1, 2**31 - 1, 2**32 - 1 and random
draws) and counters (0 up to about 2**20); the Gumbel floats may differ only
where ``log`` rounds differently, within 1e-6. On the same logits and keys,
``sample_token`` and ``sample_token_mirostat`` give the reference's tokens,
and mirostat's mu agrees within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.ops import sampling as ref_sampling
from wrinklefree_tpu_torch.ops import sampling

_rng = np.random.default_rng(18)
SEEDS = np.concatenate([[0, 1, 2**31 - 1, 2**32 - 1],
                        _rng.integers(0, 2**32, 60, dtype=np.uint64)]).astype(np.uint32)
COUNTERS = np.concatenate([[0, 1, 2**20 - 1, 2**20],
                           _rng.integers(0, 2**20, 60)]).astype(np.int32)


def _port_keys(seeds, counters):
    return sampling.per_request_keys(torch.from_numpy(seeds.astype(np.int64)),
                                     torch.from_numpy(counters.astype(np.int64)))


def _port_noise(seeds, counters, vocab):
    """The samplers' noise: the keys' Gumbel draws over the candidates."""
    return sampling.gumbel(_port_keys(seeds, counters), min(sampling.NUCLEUS_CANDIDATES, vocab))


def _ref_keys(seeds, counters):
    return ref_sampling.per_request_keys(jnp.asarray(seeds), jnp.asarray(counters))


@pytest.mark.parametrize("shift", [0, 17, 2**19])
def test_keys_bit_equal(shift):
    """Every (seed, counter) pair of the grid, the counters shifted."""
    ctr = (COUNTERS + shift).astype(np.int32)
    want = np.asarray(_ref_keys(SEEDS, ctr)).astype(np.int64)
    got = _port_keys(SEEDS, ctr).numpy()
    np.testing.assert_array_equal(got, want)


def test_keys_of_one_seed_over_counters():
    ctr = np.arange(0, 2**20 + 1, 4099, dtype=np.int32)
    seeds = np.full(ctr.shape, 2**32 - 1, np.uint32)
    np.testing.assert_array_equal(_port_keys(seeds, ctr).numpy(),
                                  np.asarray(_ref_keys(seeds, ctr)).astype(np.int64))


@pytest.mark.parametrize("c", [1, 7, 256, 1000])
def test_random_bits_and_gumbel(c):
    keys = np.asarray(_ref_keys(SEEDS, COUNTERS))
    want_bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (c,)))(jnp.asarray(keys)))
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (c,)))(jnp.asarray(keys)))
    pk = torch.from_numpy(keys.astype(np.int64))
    np.testing.assert_array_equal(sampling.random_bits(pk, c).numpy(),
                                  want_bits.astype(np.int64))
    got = sampling.gumbel(pk, c).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gumbel_leading_dims():
    """[K, B, 2] keys (a burst's draws at once) equal the per-step draws."""
    keys = _port_keys(SEEDS[:8], COUNTERS[:8])
    steps = torch.arange(3)[:, None]
    seeds = torch.from_numpy(SEEDS[:8].astype(np.int64))
    all_keys = sampling.per_request_keys(seeds[None, :],
                                         torch.from_numpy(COUNTERS[:8].astype(np.int64)) + steps)
    assert torch.equal(all_keys[0], keys)
    g = sampling.gumbel(all_keys, 64)
    for k in range(3):
        assert torch.equal(g[k], sampling.gumbel(all_keys[k], 64))


def test_split_key():
    for seed in (0, 123, 2**32 - 1):
        a, b = jax.random.split(jax.random.PRNGKey(np.uint32(seed)))
        pa, pb = sampling.split_key(torch.tensor([0, seed]))
        assert pa.tolist() == np.asarray(a).astype(np.int64).tolist()
        assert pb.tolist() == np.asarray(b).astype(np.int64).tolist()


def _logits(b, v, seed):
    return (np.random.default_rng(seed).standard_normal((b, v)) * 3).astype(np.float32)


SAMPLER_CASES = [
    dict(temperature=[0.8, 1.0, 0.0, 1.3]),
    dict(temperature=[0.8, 1.0, 0.5, 1.3], top_k=[0, 40, 5, 0], top_p=[1.0, 0.9, 1.0, 0.7]),
    dict(temperature=[1.0, 1.0, 1.0, 1.0], min_p=[0.0, 0.05, 0.2, 0.0]),
    dict(temperature=[0.9, 0.9, 0.9, 0.9], typical_p=[1.0, 0.95, 0.5, 1.0],
         tfs_z=[0.9, 1.0, 1.0, 0.5]),
]


@pytest.mark.parametrize("vocab", [300, 1000])
@pytest.mark.parametrize("case", range(len(SAMPLER_CASES)))
def test_sample_token_equal(vocab, case):
    kw = {k: np.asarray(v) for k, v in SAMPLER_CASES[case].items()}
    lg = _logits(4, vocab, seed=case)
    seeds, ctr = SEEDS[4:8], COUNTERS[4:8]
    want = np.asarray(ref_sampling.sample_token(
        jnp.asarray(lg), _ref_keys(seeds, ctr), **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = sampling.sample_token(torch.from_numpy(lg), _port_noise(seeds, ctr, vocab),
                                **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_token_greedy_needs_no_keys():
    lg = torch.from_numpy(_logits(3, 300, seed=5))
    assert torch.equal(sampling.sample_token(lg), torch.argmax(lg, -1).int())
    with pytest.raises(ValueError):
        sampling.sample_token(lg, None, temperature=0.5)


@pytest.mark.parametrize("mu0", [3.0, 10.0])
def test_sample_token_mirostat_equal(mu0):
    lg = _logits(4, 500, seed=7)
    seeds, ctr = SEEDS[8:12], COUNTERS[8:12]
    temps = np.asarray([0.8, 1.0, 0.0, 1.2], np.float32)
    miro = np.asarray([2, 0, 2, 2], np.int32)
    tau = np.asarray([5.0, 5.0, 3.0, 2.0], np.float32)
    eta = np.asarray([0.1, 0.1, 0.2, 0.3], np.float32)
    mu = np.full(4, mu0, np.float32)
    rt, rmu = ref_sampling.sample_token_mirostat(
        jnp.asarray(lg), _ref_keys(seeds, ctr), jnp.asarray(mu), jnp.asarray(temps), 0.95, 0,
        0.0, 1.0, 1.0, jnp.asarray(miro), jnp.asarray(tau), jnp.asarray(eta))
    pt, pmu = sampling.sample_token_mirostat(
        torch.from_numpy(lg), _port_noise(seeds, ctr, 500), torch.from_numpy(mu), temps, 0.95,
        0, 0.0, 1.0, 1.0, miro, tau, eta)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
    np.testing.assert_allclose(pmu.numpy(), np.asarray(rmu), rtol=0, atol=1e-6)
    assert pmu[1] == mu0 and pmu[2] == mu0  # rows off mirostat keep their mu


def test_token_logprobs_equal():
    lg = _logits(3, 700, seed=9)
    toks = np.asarray([5, 0, 699], np.int32)
    full = jax.nn.log_softmax(jnp.asarray(lg), axis=-1)
    want_top, want_ids = jax.lax.top_k(full, 8)
    chosen, ids, top = sampling.token_logprobs(torch.from_numpy(lg), torch.from_numpy(toks), 8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(top.numpy(), np.asarray(want_top), atol=1e-6)
    np.testing.assert_allclose(chosen.numpy(), np.asarray(full)[np.arange(3), toks], atol=1e-6)


@pytest.mark.parametrize("temperature,top_p", [(0.8, 1.0), (1.3, 0.9)])
def test_batch1_generate_sampled_matches_reference(temperature, top_p):
    """``models.bitnet.generate`` draws the reference's stream (the key split
    once per token): on the tiny weights with the o and down projections set
    to ternary zeros (so both packages compute the same logits up to f32
    rounding) the sampled tokens equal the reference's ``generate``'s."""
    from wrinklefree_tpu.config import BitNetConfig as RefConfig
    from wrinklefree_tpu.models import bitnet as ref_bitnet
    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.models import bitnet
    from wrinklefree_tpu_torch.weights import params_from_numpy

    w = jax.tree.map(np.asarray, ref_bitnet.init_params(RefConfig.tiny(), seed=0))
    for name in ("o_qw", "down_qw"):
        w["layers"][name] = np.full_like(w["layers"][name], 0x55)
    kw = dict(max_new_tokens=16, temperature=temperature, top_p=top_p, seed=3)
    want = ref_bitnet.generate(jax.tree.map(jnp.asarray, w), RefConfig.tiny(), [1, 5, 9, 2], **kw)
    cfg = BitNetConfig.tiny()
    got = bitnet.generate(params_from_numpy(w, cfg, device="cpu"), cfg, [1, 5, 9, 2],
                          device="cpu", **kw)
    assert [int(t) for t in want] == got
