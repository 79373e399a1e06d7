"""The port's activation and attention sparsity vs the JAX reference, on the CPU.

  ops/activation_sparsity.py  vs wrinklefree_tpu/ops/activation_sparsity.py
  ops/sparse_attention.py     vs wrinklefree_tpu/ops/sparse_attention.py
  ops/attention.py            vs wrinklefree_tpu/ops/attention.py
  models/bitnet.forward(act_sparsity=, attn_sparsity=) vs the reference's

The policies are held bit for bit on seeded arrays (ties at the top-k
cutoff, 16-wide rows where the standard deviation's ddof matters, every
window geometry with and without stride), the renormalizing attention
policies bit for bit in the keys they keep and within two ulps in the kept
weights (``assert_renormalized``: the row sums add in another order); the
sparse forward on the tiny
model within the packages' 6e-2 logits bar (every policy on the f32 model,
``FORWARD_CASES`` says why), greedy tokens equal or parted at a near-tie of
the reference's own logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.models import bitnet as rb
from wrinklefree_tpu.ops import activation_sparsity as ras
from wrinklefree_tpu.ops import attention as ratt
from wrinklefree_tpu.ops import sparse_attention as rsa
from wrinklefree_tpu_torch.config import BitNetConfig
from wrinklefree_tpu_torch.models import bitnet as tb
from wrinklefree_tpu_torch.ops import activation_sparsity as tas
from wrinklefree_tpu_torch.ops import attention as tatt
from wrinklefree_tpu_torch.ops import sparse_attention as tsa
from wrinklefree_tpu_torch.ops.ternary_cuda import make_linear
from wrinklefree_tpu_torch.weights import params_from_numpy

NEAR_TIE = 6e-2  # the packages' logits bar (tests/test_torch_engine.py)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def both(x, dtype="f32"):
    """The same values as a reference array and a port tensor."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jnp.float32).astype(jd), torch.from_numpy(np.array(x, np.float32)).to(td)


def assert_bits(ref, got):
    """Equal bit for bit (dtype and every value's bits)."""
    r = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    g = got.float().numpy()
    assert r.shape == g.shape
    assert str(got.dtype).split(".")[-1] in (str(jnp.asarray(ref).dtype), "bool"), (
        got.dtype, jnp.asarray(ref).dtype)
    np.testing.assert_array_equal(r.view(np.uint32), g.view(np.uint32))


def assert_renormalized(ref, got):
    """A post-softmax policy's output: the same zeros (which keys are kept)
    bit for bit, and the kept weights within the f32 bound of an n-term row
    sum (n * 2^-23 relative; one ulp after rounding to bf16). Renormalizing
    divides by the row's sum, and the packages add in different orders:
    XLA's CPU reduction adds a row of up to 32 entries in sequence and
    vectorizes above that, torch's CPU sum is a cascade."""
    r = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    g = got.float().numpy()
    assert r.shape == g.shape and str(got.dtype).split(".")[-1] == str(jnp.asarray(ref).dtype)
    np.testing.assert_array_equal(r == 0, g == 0)
    if got.dtype == torch.bfloat16:
        dist = np.abs(r.view(np.int32).astype(np.int64) - g.view(np.int32)) >> 16
        assert dist.max() <= 1, dist.max()
    else:
        np.testing.assert_allclose(g, r, rtol=r.shape[-1] * 2.0**-23, atol=0)


def activations(seed, shape=(6, 64), ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    if ties:  # a coarse grid: many equal magnitudes, ties at every cutoff
        x = np.round(x * 2) / 2
    return x


# ---------------------------------------------------------------------------
# activation sparsity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("threshold", [0.1, 0.5, 1.0])
def test_threshold_sparsity_bitwise(dtype, threshold):
    # entries exactly at the threshold, and ties
    x = np.concatenate([activations(0, ties=True), np.full((1, 64), threshold, np.float32)])
    rx, tx = both(x, dtype)
    assert_bits(ras.apply_threshold_sparsity(rx, threshold),
                tas.apply_threshold_sparsity(tx, threshold))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ratio,min_keep", [(0.3, 8), (0.6, 8), (0.5, 1), (0.95, 2), (0.0, 1),
                                            (0.9, 40)])
@pytest.mark.parametrize("ties", [False, True])
def test_top_k_sparsity_bitwise(dtype, ratio, min_keep, ties):
    rx, tx = both(activations(1, (3, 5, 48), ties=ties), dtype)
    assert_bits(ras.apply_top_k_sparsity(rx, ratio, min_keep),
                tas.apply_top_k_sparsity(tx, ratio, min_keep))


def test_top_k_count_rounds_half_to_even():
    """n * (1 - ratio) = 2.5 keeps round(2.5) = 2 entries (Python's round),
    3.5 keeps 4: the reference's count."""
    x = np.asarray([[5.0, 4.0, 3.0, 2.0, 1.0]], np.float32)
    rx, tx = both(x)
    for ratio, kept in ((0.5, 2), (0.3, 4)):
        got = tas.apply_top_k_sparsity(tx, ratio, 1)
        assert int((got != 0).sum()) == kept
        assert_bits(ras.apply_top_k_sparsity(rx, ratio, 1), got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("alpha,min_keep", [(1.0, 1), (1.0, 8), (0.5, 1), (2.0, 4)])
def test_adaptive_sparsity_bitwise(dtype, alpha, min_keep):
    rx, tx = both(activations(2, (8, 16)), dtype)
    assert_bits(ras.apply_adaptive_sparsity(rx, alpha, min_keep),
                tas.apply_adaptive_sparsity(tx, alpha, min_keep))


def test_adaptive_std_is_ddof_zero():
    """On a 16-wide row ddof 0 and ddof 1 differ (0.8202 against 0.8471 on
    this seed); an entry between the two thresholds tells them apart."""
    row = activations(3, (1, 16))
    d0, d1 = row.std(ddof=0), row.std(ddof=1)
    assert abs(d0 - d1) > 0.02
    x = row.copy()
    x[0, 0] = (d0 + d1) / 2  # kept under ddof 0, dropped under ddof 1
    rx, tx = both(x)
    got = tas.apply_adaptive_sparsity(tx, 1.0, 1)
    assert float(got[0, 0]) != 0.0
    assert_bits(ras.apply_adaptive_sparsity(rx, 1.0, 1), got)


@pytest.mark.parametrize("mode", ["none", "threshold", "top_k", "adaptive"])
def test_apply_sparsity_dispatch_and_ratio(mode):
    rx, tx = both(activations(4, (4, 32)), "bf16")
    rcfg = ras.ActivationSparsityConfig(mode=ras.SparsityMode(mode), threshold=0.3,
                                        sparsity_ratio=0.4, adaptive_alpha=0.8, min_keep=3)
    tcfg = tas.ActivationSparsityConfig(mode=tas.SparsityMode(mode), threshold=0.3,
                                        sparsity_ratio=0.4, adaptive_alpha=0.8, min_keep=3)
    ry, ty = ras.apply_sparsity(rx, rcfg), tas.apply_sparsity(tx, tcfg)
    assert_bits(ry, ty)
    assert_bits(ras.sparsity_ratio(ry), tas.sparsity_ratio(ty))


def test_presets_and_linear_wrapper():
    for name in ("qsparse", "inference_safe"):
        r, t = getattr(ras.ActivationSparsityConfig, name)(), getattr(
            tas.ActivationSparsityConfig, name)()
        assert (r.mode.value, r.sparsity_ratio, r.min_keep) == (
            t.mode.value, t.sparsity_ratio, t.min_keep)

    def lin(x, qw, s, **kw):
        return x

    lin.stacked = True
    assert tas.make_sparse_linear_fn(lin, None) is lin
    assert tas.make_sparse_linear_fn(lin, tas.ActivationSparsityConfig()) is lin
    wrapped = tas.make_sparse_linear_fn(lin, tas.ActivationSparsityConfig.qsparse())
    assert not hasattr(wrapped, "stacked") and not hasattr(wrapped, "prologue")
    _, tx = both(activations(5, (2, 20)))
    np.testing.assert_array_equal(
        wrapped(tx, None, None).numpy(),
        tas.apply_top_k_sparsity(tx, 0.6, 8).numpy())


# ---------------------------------------------------------------------------
# attention sparsity
# ---------------------------------------------------------------------------


def probs(seed, shape=(2, 3, 5, 24), ties=False):
    rng = np.random.default_rng(seed)
    s = rng.normal(0, 2, shape).astype(np.float32)
    if ties:
        s = np.round(s)
    e = np.exp(s - s.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("window,global_tokens,stride", [
    (1, 0, 0), (4, 1, 0), (4, 1, 5), (8, 3, 0), (8, 3, 4), (16, 0, 7), (64, 1, 64), (3, 0, 1)])
def test_window_mask_bitwise(window, global_tokens, stride):
    q = np.asarray([[0, 3, 9, 17, 30], [5, 6, 7, 8, 31]], np.int32)
    r = rsa.create_window_mask(jnp.asarray(q), 32, window, global_tokens, stride)
    t = tsa.create_window_mask(torch.from_numpy(q), 32, window, global_tokens, stride)
    np.testing.assert_array_equal(np.asarray(r), t.numpy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 4, 23, 24, 30])
def test_top_k_attention_bitwise(dtype, ties, k):
    rp, tp = both(probs(6, ties=ties), dtype)
    assert_renormalized(rsa.apply_top_k_attention(rp, k), tsa.apply_top_k_attention(tp, k))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("threshold", [1e-3, 0.05, 0.2, 0.99])
def test_threshold_attention_bitwise(dtype, threshold):
    rp, tp = both(probs(7), dtype)
    assert_renormalized(rsa.apply_threshold_attention(rp, threshold),
                        tsa.apply_threshold_attention(tp, threshold))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("lo,hi", [(0.1, 0.5), (0.0, 1.0), (0.3, 0.3)])
def test_dynamic_attention_bitwise(dtype, ties, lo, hi):
    rp, tp = both(probs(8, ties=ties), dtype)
    assert_renormalized(rsa.apply_dynamic_attention(rp, lo, hi),
                        tsa.apply_dynamic_attention(tp, lo, hi))


def test_dynamic_rank_order_is_the_stable_descending_sort():
    """The reference ranks with jnp.argsort(descending=True): on [1,2,2,0,2]
    the order [1,2,4,0,3], the stable descending sort's."""
    x = np.asarray([1, 2, 2, 0, 2])
    ref = np.asarray(jnp.argsort(jnp.asarray(x), descending=True))
    got = torch.argsort(torch.from_numpy(x), descending=True, stable=True).numpy()
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_array_equal(got, [1, 2, 4, 0, 3])


@pytest.mark.parametrize("mode", ["none", "top_k", "threshold", "window", "dynamic"])
def test_attention_sparsity_dispatch_and_ratio(mode):
    rp, tp = both(probs(9), "bf16")
    kw = dict(top_k=5, threshold=0.02, min_keep_frac=0.2, max_keep_frac=0.6)
    ry = rsa.apply_attention_sparsity(
        rp, rsa.AttentionSparsityConfig(mode=rsa.AttentionSparsityMode(mode), **kw))
    ty = tsa.apply_attention_sparsity(
        tp, tsa.AttentionSparsityConfig(mode=tsa.AttentionSparsityMode(mode), **kw))
    assert_renormalized(ry, ty)
    assert_bits(rsa.attention_sparsity_ratio(ry), tsa.attention_sparsity_ratio(ty))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("q_offset,kv_len", [(0, None), (5, None), (3, (9, 12))])
def test_gqa_attention_reference(dtype, q_offset, kv_len):
    rng = np.random.default_rng(10)
    q, k, v = (rng.normal(0, 1, s).astype(np.float32)
               for s in ((2, 4, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)))
    (rq, tq), (rk, tk), (rv, tv) = both(q, dtype), both(k, dtype), both(v, dtype)
    rkl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tkl = None if kv_len is None else torch.tensor(kv_len)
    ref = ratt.gqa_attention_reference(rq, rk, rv, q_offset, kv_len=rkl)
    got = tatt.gqa_attention_reference(tq, tk, tv, q_offset, kv_len=tkl)
    assert got.dtype == DTYPES[dtype][1]
    tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the sparse forward on the tiny model
# ---------------------------------------------------------------------------

ATTN = {
    "none": dict(mode="none"),
    "top_k": dict(mode="top_k", top_k=6),
    "threshold": dict(mode="threshold", threshold=0.05),
    "window": dict(mode="window", window_size=8, global_tokens=1, stride=5),
    "dynamic": dict(mode="dynamic", min_keep_frac=0.1, max_keep_frac=0.5),
}


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, rb.init_params(RefConfig.tiny(), seed=0))


@pytest.fixture(scope="module")
def weights_f32():
    rcfg = dataclasses.replace(RefConfig.tiny(), dtype=jnp.float32)
    return jax.tree.map(np.asarray, rb.init_params(rcfg, seed=0))


def _policies(attn):
    kw = dict(ATTN[attn])
    mode = kw.pop("mode")
    r_attn = None if mode == "none" else rsa.AttentionSparsityConfig(
        mode=rsa.AttentionSparsityMode(mode), **kw)
    t_attn = None if mode == "none" else tsa.AttentionSparsityConfig(
        mode=tsa.AttentionSparsityMode(mode), **kw)
    return (ras.ActivationSparsityConfig.inference_safe(), r_attn,
            tas.ActivationSparsityConfig.inference_safe(), t_attn)


# the sparse forward: on the f32 tiny model (both packages in f32) every
# policy, with and without activation sparsity; on the bf16 model only the
# modes without a discrete choice after the softmax. In bf16 the packages'
# attention rounds apart by up to 0.02 in the logits (the dense bar), and a
# top-k, threshold or dynamic cutoff turns such an ulp into a whole weight
# kept or dropped: 0.07-0.14 on this model, 0.2 under qsparse.
FORWARD_CASES = ([("f32", attn, act, lin) for attn in sorted(ATTN) for act in (False, True)
                  for lin in ("default", "k7")]
                 + [("bf16", attn, False, "default") for attn in ("none", "window")])


@pytest.mark.parametrize("dtype,attn,act,linear", FORWARD_CASES)
def test_sparse_forward_matches_reference(weights_f32, weights, dtype, attn, act, linear):
    """A 20-token prefill (logits at every position) then 4 decode steps fed
    the reference's greedy tokens, under inference_safe activation sparsity
    (``act``) and an attention mode, on unfused params: the port's forward
    (the plain linear, or ``make_linear()``'s K7, whose CPU path is its plain
    version) against the reference's forward with its plain linear. Logits
    within the packages' 6e-2 bar; where the argmax parts, the reference's
    logits hold both tokens within it."""
    f32 = dtype == "f32"
    rcfg = dataclasses.replace(RefConfig.tiny(), dtype=jnp.float32) if f32 else RefConfig.tiny()
    cfg = (dataclasses.replace(BitNetConfig.tiny(), dtype=torch.float32) if f32
           else BitNetConfig.tiny())
    w = weights_f32 if f32 else weights
    r_act, r_attn, t_act, t_attn = _policies(attn)
    if not act:
        r_act = t_act = None
    rparams = jax.tree.map(jnp.asarray, w)
    tparams = params_from_numpy(w, cfg, device="cpu")
    lf = make_linear() if linear == "k7" else None
    prompt = np.random.default_rng(11).integers(1, cfg.vocab_size, 20)
    T = 32
    rcache = rb.KVCache.zeros(rcfg, 1, T)
    tcache = tb.KVCache.zeros(cfg, 1, T, device="cpu")
    feed = [(prompt, 0)]
    ref_logits, got_logits = [], []
    for step in range(5):
        toks, pos = feed[-1]
        rl, rcache = rb.forward(rparams, rcfg, jnp.asarray(toks, jnp.int32)[None], rcache,
                                jnp.asarray([pos], jnp.int32), act_sparsity=r_act,
                                attn_sparsity=r_attn)
        tl, tcache = tb.forward(tparams, cfg, torch.from_numpy(np.asarray(toks))[None], tcache,
                                torch.tensor([pos]), linear_fn=lf, act_sparsity=t_act,
                                attn_sparsity=t_attn)
        ref_logits.append(np.asarray(rl)[0])
        got_logits.append(tl[0].float().numpy())
        nxt = int(np.argmax(ref_logits[-1][-1]))
        feed.append((np.asarray([nxt]), pos + len(toks)))
    ref_all, got_all = np.concatenate(ref_logits), np.concatenate(got_logits)
    assert np.isfinite(got_all).all()
    np.testing.assert_allclose(got_all, ref_all, rtol=0, atol=NEAR_TIE)
    for r, g in zip(ref_all, got_all):
        if int(np.argmax(g)) != int(np.argmax(r)):  # a parting: a near-tie of the reference's
            assert r.max() - r[int(np.argmax(g))] < NEAR_TIE


def test_sparse_forward_changes_the_logits(weights):
    """The policies act: each sparse forward's logits differ from the dense
    forward's (the port's, plain linear)."""
    cfg = BitNetConfig.tiny()
    tparams = params_from_numpy(weights, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(12).integers(1, cfg.vocab_size, 24))[None]

    def run(**kw):
        cache = tb.KVCache.zeros(cfg, 1, 32, device="cpu")
        return tb.forward(tparams, cfg, toks, cache, torch.tensor([0]), **kw)[0]

    dense = run()
    for attn in ATTN:
        _, _, t_act, t_attn = _policies(attn)
        assert not torch.equal(run(act_sparsity=t_act, attn_sparsity=t_attn), dense)
        if t_attn is not None:
            assert not torch.equal(run(attn_sparsity=t_attn), dense)


def test_fused_params_under_sparsity_raise(weights):
    """Fused projections need a stacked linear; the sparse wrapper is not one,
    so both packages raise ValueError."""
    from wrinklefree_tpu.ops.ternary_pallas import make_pallas_linear_fused
    from wrinklefree_tpu_torch.ops.ternary_cuda import make_linear_fused

    rcfg, cfg = RefConfig.tiny(), BitNetConfig.tiny()
    rparams = rb.fuse_projections(jax.tree.map(jnp.asarray, weights), rcfg)
    tparams = tb.fuse_projections(params_from_numpy(weights, cfg, device="cpu"), cfg)
    with pytest.raises(ValueError):
        rb.forward(rparams, rcfg, jnp.ones((1, 4), jnp.int32), rb.KVCache.zeros(rcfg, 1, 8),
                   jnp.zeros((1,), jnp.int32), linear_fn=make_pallas_linear_fused(interpret=True),
                   act_sparsity=ras.ActivationSparsityConfig.inference_safe())
    with pytest.raises(ValueError):
        tb.forward(tparams, cfg, torch.ones((1, 4), dtype=torch.long),
                   tb.KVCache.zeros(cfg, 1, 8, device="cpu"), torch.zeros(1),
                   linear_fn=make_linear_fused(),
                   act_sparsity=tas.ActivationSparsityConfig.inference_safe())
