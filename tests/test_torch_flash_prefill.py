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

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("g", list(range(1, 17)))
def test_block_rule(g, f32, d):
    """The kernel's block (query heads, query tokens, warps) for G 1-16: the
    KV head's heads in the fewest blocks of at most 8 (bf16) or 4 (f32),
    evenly; bf16 groups of 16 tokens of a head, two warps a group (each
    half of every key tile) up to 4 heads and 64 / heads tokens, one warp a
    group from 5 heads and 16 tokens, at most 8 warps; f32 one warp per 8
    tokens, the most tokens that keep the block at 32 query rows or fewer."""
    gb, bq, warps = flash_attention.causal_prefill_block(g, d, f32)
    cap = 4 if f32 else 8
    blocks = -(-g // cap)
    assert gb <= cap and blocks * gb >= g and (blocks - 1) * gb < g
    if f32:
        assert bq in (8, 16, 32) and gb * bq <= 32 and (bq == 32 or gb * 2 * bq > 32)
        assert warps == gb * bq // 8
    elif gb <= 4:
        assert bq == 16 * max(1, 4 // gb) and warps == 2 * gb * bq // 16 and warps in (6, 8)
    else:
        assert bq == 16 and warps == gb


def test_block_rule_at_2b_heads():
    """BitNet-2B's 4 query heads per KV head: one block per KV head and 16
    tokens in bf16 (8 warps, two a group of 16 rows), 8 tokens in f32 (4
    warps); its grid at a 512-token chunk has 5 x 32 and 5 x 64 blocks."""
    assert flash_attention.causal_prefill_block(4, 128, False) == (4, 16, 8)
    assert flash_attention.causal_prefill_block(4, 128, True) == (4, 8, 4)


@pytest.mark.parametrize("g,d", [(0, 128), (4, 96), (4, 256)])
def test_block_rule_refuses(g, d):
    with pytest.raises(ValueError):
        flash_attention.causal_prefill_block(g, d, False)


def _inputs(dtype=torch.bfloat16, d=128, s=64, t=128, nh=4, kv=2):
    return (torch.zeros(1, s, nh, d, dtype=dtype), torch.zeros(1, t, kv, d, dtype=dtype),
            torch.zeros(1, t, kv, d, dtype=dtype))


@pytest.mark.parametrize("what", ["f16", "f64", "mixed", "d96", "d256", "heads", "kv_shape",
                                  "tiles", "negative", "float_offset", "two_offsets"])
def test_kernel_input_checks(what):
    """What the kernel refuses raises ValueError before any launch: a dtype
    other than bf16 or f32 (or mixed), D other than 64 or 128, KV not
    dividing NH, k and v of other shapes, S or T not tiled by the blocks, a
    negative int offset, a float or multi-element offset tensor."""
    q, k, v = _inputs()
    off = 0
    if what in ("f16", "f64"):
        q, k, v = (x.to(torch.float16 if what == "f16" else torch.float64) for x in (q, k, v))
    elif what == "mixed":
        k = k.float()
    elif what in ("d96", "d256"):
        q, k, v = _inputs(d=int(what[1:]))
    elif what == "heads":
        q, k, v = _inputs(nh=5)
    elif what == "kv_shape":
        v = v[:, :64]
    elif what == "tiles":
        q, k, v = _inputs(s=96)
    elif what == "negative":
        off = -1
    elif what == "float_offset":
        off = torch.tensor([1.0])
    else:
        off = torch.tensor([1, 2])
    with pytest.raises(ValueError):
        flash_attention.flash_prefill_checks(q, k, v, off, block_q=64, block_k=64)


def test_kernel_input_checks_pass():
    """Shapes the kernel takes: its block and the offset (an int, or the
    tensor itself, never read here)."""
    q, k, v = _inputs(torch.float32, d=64)
    assert (flash_attention.flash_prefill_checks(q, k, v, 3, block_q=64, block_k=64)
            == (2, 16, 4, 3))
    off = torch.tensor([5], dtype=torch.int64)
    *block, got = flash_attention.flash_prefill_checks(q, k, v, off, block_q=64, block_k=64)
    assert block == [2, 16, 4] and got is off


@pytest.mark.parametrize("dtype,g,d,s,t,off", [
    ("bf16", 8, 64, 64, 192, 100),  # 8 heads a KV head, offset not a multiple of 64
    ("f32", 8, 64, 64, 192, 100),
    ("bf16", 1, 128, 40, 40, 0),    # S below 64, not a multiple of 16
    ("f32", 16, 64, 64, 128, 64),   # G 16: more than one block's heads
])
def test_64_key_blocks_vs_reference(dtype, g, d, s, t, off):
    """The plain version with 64-key blocks, which the kernel is held to on
    the card, against the reference with the same blocks at the card tests'
    new shapes: f32 within 2e-5, bf16 within 1e-2 (as above)."""
    kv = 2 if g < 8 else 1
    q, k, v = _case(1, s, t, kv * g, kv, d, seed=g + s + off)
    ref, got = _both(q, k, v, off, dtype, block_q=s, block_k=64)
    tol = 2e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_offset_tensor_equals_int():
    """On the CPU an offset tensor gives the int offset's result."""
    q, k, v = (torch.from_numpy(x).float() for x in _case(1, 64, 192, 4, 2, 64, seed=3))
    a = flash_attention.flash_prefill(q, k, v, torch.tensor([100]), block_q=64, block_k=64)
    b = flash_attention.flash_prefill(q, k, v, 100, block_q=64, block_k=64)
    assert torch.equal(a, b)


@pytest.mark.parametrize("s,t,off", [(512, 512, 0), (512, 1024, 128), (40, 40, 0), (64, 192, 100)])
def test_bench_counts_visible_pairs(s, t, off):
    """bench/causal_prefill.py's bound counts the (query, key) pairs the
    causal mask leaves visible, as a dense mask does."""
    from wrinklefree_tpu_torch.bench import causal_prefill

    mask = np.arange(t)[None, :] <= off + np.arange(s)[:, None]
    assert causal_prefill.pairs(s, t, off) == int(mask.sum())
    ms, by = causal_prefill.bound("bf16", s, t, off)
    assert ms > 0 and by in ("bytes", "operations")
