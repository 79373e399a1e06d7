"""The port's causal flash prefill (K9) vs the JAX reference, on the CPU.

  flash_attention.flash_prefill (plain)  vs ops.flash_attention.flash_prefill (interpret)

Inputs are seeded numpy arrays handed to both. The port runs the plain
version, which the wrapper takes for CPU tensors; tests/test_torch_cuda.py
and chip_smoke.py hold the kernel against it on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrinklefree_tpu.ops.flash_attention import flash_prefill as ref_flash_prefill
from wrinklefree_tpu_torch.ops import flash_attention


def _case(b, s, t, nh, kv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, nh, d)), rng.normal(size=(b, t, kv, d)),
            rng.normal(size=(b, t, kv, d)))


def _both(q, k, v, off, dtype, **blocks):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = ref_flash_prefill(*(jnp.asarray(x, jdt) for x in (q, k, v)), off, interpret=True,
                            **blocks)
    got = flash_attention.flash_prefill(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), off,
                                        **blocks)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("b,s,t,nh,kv,off", [
    (1, 256, 256, 4, 2, 0),
    (2, 256, 512, 8, 8, 0),     # MHA
    (1, 256, 1024, 4, 1, 128),  # MQA + chunked-prefill offset
])
def test_f32_vs_reference(b, s, t, nh, kv, off):
    """The shapes of tests/test_pallas_kernels.py::TestFlashPrefill at its
    bar, 2e-5: the plain version takes the reference's blocks and rounding
    points, so only the order of f32 sums differs."""
    q, k, v = _case(b, s, t, nh, kv, 64, seed=s + t)
    ref, got = _both(q, k, v, off, "f32", block_q=128, block_k=128)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,s,t,off,blocks", [
    ("bf16", 256, 256, 0, (128, 128)),   # tests/test_pallas_kernels.py::test_bf16
    ("bf16", 256, 512, 256, (256, 512)),  # BitNet-2B heads, the default blocks
    ("f32", 256, 512, 256, (256, 512)),
])
def test_2b_heads_and_bf16_vs_reference(dtype, s, t, off, blocks):
    """bf16 at the reference test's shape (4/2 heads of 128), and BitNet-2B's
    20/5 heads of 128 with an offset. f32 at 2e-5; bf16 at 1e-2: p is
    rounded to bf16 against the same running max on both sides, so a bf16
    value of p or of the output moves only where an f32 sum in another order
    crosses a rounding boundary (measured: 0.1-0.15% of the bf16 outputs
    differ, by at most 2.0e-3, one bf16 ulp; f32 at most 4.2e-7)."""
    nh, kv = (4, 2) if blocks == (128, 128) else (20, 5)
    q, k, v = _case(1, s, t, nh, kv, 128, seed=t + off)
    ref, got = _both(q, k, v, off, dtype, block_q=blocks[0], block_k=blocks[1])
    tol = 2e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_tiling_is_checked():
    """S and T must tile by the blocks in both packages."""
    q, k, v = (torch.zeros(1, 96, 2, 64), torch.zeros(1, 128, 2, 64), torch.zeros(1, 128, 2, 64))
    with pytest.raises(ValueError, match="tile"):
        flash_attention.flash_prefill(q, k, v, 0, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="tile"):
        ref_flash_prefill(*(jnp.asarray(x.numpy()) for x in (q, k, v)), 0, block_q=64,
                          block_k=64, interpret=True)
    ok = flash_attention.flash_prefill(q[:, :64], k, v, 0, block_q=64, block_k=64)
    assert ok.shape == (1, 64, 2, 64)


def test_matches_dense_causal_softmax():
    """Blockwise online softmax in f32 equals one masked softmax over all
    keys in f64 to f32 precision (the blocks change only the order of sums)."""
    q, k, v = (x.astype(np.float32) for x in _case(1, 128, 256, 4, 2, 64, seed=1))
    got = flash_attention.flash_prefill(*(torch.from_numpy(x) for x in (q, k, v)), 64,
                                        block_q=64, block_k=64).numpy()
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    qg = q.reshape(1, 128, 2, 2, 64) / np.sqrt(64)
    s = np.einsum("bskgd,btkd->bkgst", qg, k)
    s = np.where(np.arange(256)[None, :] <= 64 + np.arange(128)[:, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    o = np.einsum("bkgst,btkd->bskgd", p / p.sum(-1, keepdims=True), v).reshape(got.shape)
    np.testing.assert_allclose(got, o, rtol=2e-5, atol=2e-5)
