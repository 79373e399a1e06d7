"""The host rule and the arithmetic of the port's paged flash decode (K6,
``wrinklefree_tpu_torch/csrc/flash_decode.cu``), written in PyTorch, against
the JAX reference and the port's plain version on the CPU.

The kernel deals each slot's 64-token tiles (its committed tiles, then the
tail: the staging prefix and the current token) out in equal contiguous
shares over ``flash_decode_split`` blocks of one cluster. Each of a block's
four warps owns 16 rows of every tile and keeps its own online softmax,
rounding its probabilities to the pool's type against its own running max;
the block sums its warps' states in warp order, and rank 0 sums the ranks'
states in rank order. ``k6_model`` repeats that arithmetic; at every split
it must stay within the reference's bf16 bar (5e-2,
tests/test_torch_kernels.py) of ``flash_paged_decode(..., interpret=True)``
and within the card's bar (2e-2, chip_smoke.py) of the plain version. On
fp16 and f32 pools (the query still bf16) the plain version and
``k6_model`` are held against the reference in interpret mode
(``WIDE_BAR``) and ``k6_model`` against the plain version (the card's
``POOL_BARS``); on fp16 the kernel's scores are TF32 products, exact in
f32 as the model's are because TF32 holds every finite bf16 and fp16 value
(``exact_in_tf32``, checked over all of them). On f32 the kernel's scores
take each key in three TF32 pieces (``tf32_split``), exact against the bf16
query as well, and its PV product the probabilities and values in two
pieces each (3xTF32), which ``k6_model`` repeats; the same order in one
TF32 pass must fail the f32 bar. The kernel itself is held against the
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests import _subnormal_cases as sub
from wrinklefree_tpu.ops import flash_attention as ref_flash
from wrinklefree_tpu_torch.ops import flash_attention

H100_SMS = 132
NEG = -1e30
TILE, WARPS = 64, 4
WROWS = TILE // WARPS

# BitNet-2B's decode attention in the engine (KV 5, page size 16): the split
# at each batch and page-table bucket (max_context 2048: MP 8..128)
SPLITS_2B = [
    (1, 8, 1), (1, 16, 2), (1, 32, 4), (1, 64, 8), (1, 128, 8),
    (8, 8, 1), (8, 16, 2), (8, 32, 4), (8, 64, 4), (8, 128, 4),
    (16, 8, 1), (16, 16, 2), (16, 32, 2), (16, 64, 2), (16, 128, 2),
]


@pytest.mark.parametrize("b,mp,split", SPLITS_2B, ids=[f"B{b}-MP{m}" for b, m, _ in SPLITS_2B])
def test_split_at_2b_engine_shapes(b, mp, split):
    """A power of two <= 8 whose grid the card holds at once (two blocks per
    SM) and that leaves each block two tiles of the longest history; doubling
    it would not fit, pass 8 or leave a block fewer tiles."""
    got = flash_attention.flash_decode_split(b, 5, mp * 16, H100_SMS)
    assert got == split
    assert b * 5 * got <= 2 * H100_SMS and (got == 1 or 2 * got <= mp * 16 // TILE)
    assert 2 * b * 5 * got > 2 * H100_SMS or got == 8 or 4 * got > mp * 16 // TILE


def test_split_bounds():
    """A power of two in [1, 8] that leaves each block two of the page
    table's 64-token tiles, and the largest such whose grid fits two blocks
    per SM."""
    rng = np.random.default_rng(0)
    for _ in range(500):
        b, kv = int(rng.integers(1, 65)), int(rng.integers(1, 17))
        hist = int(rng.integers(1, 9000))
        sms = int(rng.integers(1, 200))
        s = flash_attention.flash_decode_split(b, kv, hist, sms)
        tiles = -(-hist // TILE)
        assert s in (1, 2, 4, 8) and (s == 1 or 2 * s <= tiles)
        assert s == 1 or b * kv * s <= 2 * sms
        assert 2 * b * kv * s > 2 * sms or s == 8 or 4 * s > tiles


def _combine(states):
    """States (m [KV, G], l [KV, G], acc [KV, G, D]) rescaled to their
    common max and summed in order."""
    m = torch.stack([s[0] for s in states]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(states[0][2])
    for m_r, l_r, acc_r in states:
        e = torch.exp(m_r - m)
        l = l + l_r * e
        acc = acc + acc_r * e[..., None]
    return m, l, acc


def k6_model(q, k_cur, v_cur, main, staging_b, layer, page_table, seq_lens, split,
             flush=False, tf32=False):
    """The kernel's arithmetic: per slot, rank and warp an online softmax over
    the warp's 16 rows of each tile of the rank's share (f32 scores and
    state, probabilities rounded to the pool's type before PV), warps then
    ranks combined in order, ``acc / max(l, 1e-30)``. The current token is
    rounded to the pool's type. Scores are exact f32 products: the kernel's
    bf16, TF32 (fp16 pools) and three-piece TF32 (f32 pools) products are
    exact too. PV on f32 pools is 3xTF32 (hi*hi + hi*lo + lo*hi of
    ``tf32_split``'s two pieces), as the kernel's. With ``flush`` the fp16
    probabilities below 2^-14 become zero, and with ``tf32`` the keys,
    probabilities and values of an f32 pool go through one TF32 pass
    (``tf32_round``): the arithmetic of kernels that lose fp16's subnormals
    or f32's low bits, for the bars' controls."""
    fa = flash_attention
    f32 = main.dtype == torch.float32
    B, NH, D = q.shape
    KV = k_cur.shape[1]
    G = NH // KV
    n_l, ps = main.shape[1] // 2, main.shape[2]
    MP = page_table.shape[1]
    qs = (q * torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype)).float().reshape(B, KV, G, D)
    out = torch.empty((B, KV, G, D))
    for b in range(B):
        n = int(seq_lens[b])
        full, off = min(n // ps * ps, MP * ps), n % ps
        pages = page_table[b, :full // ps].long()
        k_rows = [main[pages, layer].reshape(full, KV, D),
                  torch.cat([staging_b[b, :off, layer].reshape(off, KV, D),
                             k_cur[b][None].to(main.dtype)])]
        v_rows = [main[pages, n_l + layer].reshape(full, KV, D),
                  torch.cat([staging_b[b, :off, n_l + layer].reshape(off, KV, D),
                             v_cur[b][None].to(main.dtype)])]
        ntm = -(-full // TILE)
        tiles = [(k_rows[0][i * TILE:(i + 1) * TILE], v_rows[0][i * TILE:(i + 1) * TILE])
                 for i in range(ntm)] + [(k_rows[1], v_rows[1])]
        nt = len(tiles)
        ranks = []
        for rank in range(split):
            warps = []
            for w in range(WARPS):
                m = torch.full((KV, G), NEG)
                l = torch.zeros((KV, G))
                acc = torch.zeros((KV, G, D))
                for kt, vt in tiles[rank * nt // split:(rank + 1) * nt // split]:
                    kw, vw = kt[w * WROWS:(w + 1) * WROWS], vt[w * WROWS:(w + 1) * WROWS]
                    if kw.shape[0] == 0:
                        continue
                    kf = fa.tf32_round(kw) if tf32 else kw.float()
                    s = torch.einsum("kgd,tkd->kgt", qs[b], kf)
                    m_new = torch.maximum(m, s.amax(dim=-1))
                    p = torch.exp(s - m_new[..., None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(dim=-1)
                    pr = p.to(vw.dtype)
                    if flush:
                        pr = torch.where(pr < 2.0 ** -14, 0.0, pr)
                    if f32 and tf32:
                        pv = torch.einsum("kgt,tkd->kgd", fa.tf32_round(pr), fa.tf32_round(vw))
                    elif f32:  # 3xTF32
                        (ph, pl), (vh, vl) = fa.tf32_split(pr, 2), fa.tf32_split(vw, 2)
                        pv = (torch.einsum("kgt,tkd->kgd", ph, vh)
                              + (torch.einsum("kgt,tkd->kgd", pl, vh)
                                 + torch.einsum("kgt,tkd->kgd", ph, vl)))
                    else:
                        pv = torch.einsum("kgt,tkd->kgd", pr.float(), vw.float())
                    acc = acc * alpha[..., None] + pv
                    m = m_new
                warps.append((m, l, acc))
            ranks.append(_combine(warps))
        _, l, acc = _combine(ranks)
        out[b] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype).reshape(B, NH, D)


SEQ_LENS = [0, 64, 300, 639]  # no history, a full tile and no staging, mixed, MP*ps - 1


@pytest.fixture(scope="module")
def decode_case():
    """Seed-made bf16 inputs at head dim 128 (the kernel's), 2 KV heads of 4
    query heads, page size 16, 40 pages per slot (10 tiles and the tail at
    639 tokens: every rank of 8 gets a share), 2 layers; the reference's
    output for each layer."""
    rng = np.random.default_rng(8)
    B, KV, G, D, ps, MP, n_l = len(SEQ_LENS), 2, 4, 128, 16, 40, 2
    arrs = dict(
        main=rng.standard_normal((B * MP + 1, 2 * n_l, ps, KV * D)),
        staging=rng.standard_normal((B, ps, 2 * n_l, KV * D)),
        q=rng.standard_normal((B, KV * G, D)),
        k_cur=rng.standard_normal((B, KV, D)),
        v_cur=rng.standard_normal((B, KV, D)),
    )
    ref_in = {k: jnp.asarray(v, jnp.float32).astype(jnp.bfloat16) for k, v in arrs.items()}
    got = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16) for k, v in arrs.items()}
    pt = (rng.permutation(B * MP) + 1).astype(np.int32).reshape(B, MP)
    sl = np.asarray(SEQ_LENS, np.int32)
    refs = [np.asarray(ref_flash.flash_paged_decode(
        ref_in["q"], ref_in["k_cur"], ref_in["v_cur"], ref_in["main"], ref_in["staging"],
        jnp.int32(layer), jnp.asarray(pt), jnp.asarray(sl), interpret=True).astype(jnp.float32))
        for layer in range(n_l)]
    return got, torch.from_numpy(pt), torch.from_numpy(sl), refs


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_split_combine_vs_reference_and_plain(decode_case, split, layer):
    """The kernel's split and combine, at every split, against the reference
    in interpret mode (bf16 bar 5e-2: probabilities round to bf16 against
    another running max) and against the plain version (the card's bar,
    2e-2)."""
    x, pt, sl, refs = decode_case
    args = (x["q"], x["k_cur"], x["v_cur"], x["main"], x["staging"], layer, pt, sl)
    got = k6_model(*args, split).float().numpy()
    plain = flash_attention.flash_paged_decode_plain(*args).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, refs[layer], rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got, plain, rtol=2e-2, atol=2e-2)



@pytest.fixture(scope="module", params=["fp16", "f32"])
def wide_case(request):
    """The decode case's shapes and seed with the pool and staging pages in
    fp16 or f32 and the query and current token in bf16 (the model's type),
    as the engine hands them to K6; the reference's output for each layer
    (its tail promotes the bf16 current token beside the pool's rows, as the
    plain version's cast to the pool's type keeps its value: bf16 is exact in
    fp16 and f32 at these magnitudes)."""
    rng = np.random.default_rng(8)
    B, KV, G, D, ps, MP, n_l = len(SEQ_LENS), 2, 4, 128, 16, 40, 2
    arrs = dict(
        main=rng.standard_normal((B * MP + 1, 2 * n_l, ps, KV * D)),
        staging=rng.standard_normal((B, ps, 2 * n_l, KV * D)),
        q=rng.standard_normal((B, KV * G, D)),
        k_cur=rng.standard_normal((B, KV, D)),
        v_cur=rng.standard_normal((B, KV, D)),
    )
    jdt, tdt = {"fp16": (jnp.float16, torch.float16), "f32": (jnp.float32, torch.float32)}[
        request.param]
    pool = ("main", "staging")
    ref_in = {k: jnp.asarray(v, jnp.float32).astype(jdt if k in pool else jnp.bfloat16)
              for k, v in arrs.items()}
    got = {k: torch.from_numpy(v.astype(np.float32)).to(tdt if k in pool else torch.bfloat16)
           for k, v in arrs.items()}
    pt = (rng.permutation(B * MP) + 1).astype(np.int32).reshape(B, MP)
    sl = np.asarray(SEQ_LENS, np.int32)
    refs = [np.asarray(ref_flash.flash_paged_decode(
        ref_in["q"], ref_in["k_cur"], ref_in["v_cur"], ref_in["main"], ref_in["staging"],
        jnp.int32(layer), jnp.asarray(pt), jnp.asarray(sl), interpret=True).astype(jnp.float32))
        for layer in range(n_l)]
    return request.param, got, torch.from_numpy(pt), torch.from_numpy(sl), refs


# (atol, rtol) of the plain version against the reference on fp16 and f32
# pools; both return the bf16 query's type. fp16: probabilities round to
# fp16 (2^-11 relative) against another running max, and the output to bf16
# (2^-8 relative, of values up to a few units). f32: nothing rounds before
# the output; the f32 sums' order differs (2e-5), and the output's rounding
# to bf16 may land one step (at most 2^-7 of the value) apart, on few enough
# elements to tell an f32 read of the pool from a bf16 one (K6's
# ``meets_pool_bar``).
WIDE_BAR = {"fp16": (1e-2, 1e-2), "f32": (2e-5, 2.0 ** -7)}


@pytest.mark.parametrize("layer", [0, 1])
def test_wide_pools_plain_vs_reference(wide_case, layer):
    """The wrapper on CPU tensors (K6's plain version) over fp16 and f32
    pools with a bf16 query, against the reference in interpret mode on the
    same arrays, within ``WIDE_BAR``; a bf16 output."""
    dt, x, pt, sl, refs = wide_case
    got = flash_attention.flash_paged_decode(x["q"], x["k_cur"], x["v_cur"], x["main"],
                                             x["staging"], layer, pt, sl)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    atol, rtol = WIDE_BAR[dt]
    np.testing.assert_allclose(got.float().numpy(), refs[layer], rtol=rtol, atol=atol)
    if dt == "f32":
        ref = torch.from_numpy(refs[layer]).bfloat16()
        ok, err, share = flash_attention.meets_pool_bar(got, ref, "k6", "f32")
        assert ok, (err, share)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_split_combine_wide_vs_reference_and_plain(wide_case, split, layer):
    """The kernel's split and combine on fp16 and f32 pools with a bf16
    query (on fp16 the probabilities rounded to fp16 before PV), at every
    split, against the
    reference in interpret mode within ``WIDE_BAR`` and against the plain
    version within the card's bar (``meets_pool_bar``)."""
    dt, x, pt, sl, refs = wide_case
    args = (x["q"], x["k_cur"], x["v_cur"], x["main"], x["staging"], layer, pt, sl)
    got = k6_model(*args, split)
    plain = flash_attention.flash_paged_decode_plain(*args)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    atol, rtol = WIDE_BAR[dt]
    np.testing.assert_allclose(got.float().numpy(), refs[layer], rtol=rtol, atol=atol)
    ok, err, share = flash_attention.meets_pool_bar(got, plain, "k6", dt)
    assert ok, (err, share)


@pytest.mark.parametrize("dtype,finite", [(torch.float16, 63488), (torch.bfloat16, 65280)],
                         ids=["fp16", "bf16"])
def test_tf32_holds_every_fp16_and_bf16(dtype, finite):
    """What K6's fp16 scores rest on, over every finite bit pattern of the
    key's type (fp16: all 63,488, subnormals and both zeros included) and of
    the query's (bf16): each value's f32 form has its low 13 mantissa bits
    zero, so TF32 holds it exactly; and an f32 value that uses those bits is
    refused."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(dtype)
    x = x[torch.isfinite(x)]
    assert x.numel() == finite
    assert bool(flash_attention.exact_in_tf32(x).all())
    assert (x.float().view(torch.int32) & 0x1FFF).eq(0).all()
    f = torch.tensor([1.0 + 2.0 ** -23, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 2.0 ** -24])
    assert flash_attention.exact_in_tf32(f).tolist() == [False, False, True, True]


# (inputs, the model's variant, whether it meets the fp16 bar)
FP16_CONTROLS = [("random", "kernel", True), ("random", "keys-bf16", False),
                 ("planted", "kernel", True), ("planted", "keys-bf16", False),
                 ("planted", "flush", False)]


@pytest.mark.parametrize("inputs,variant,meets", FP16_CONTROLS,
                         ids=[f"{i}-{v}" for i, v, _ in FP16_CONTROLS])
def test_fp16_bar_refuses_inexact_orders(inputs, variant, meets):
    """What the fp16 bar (``meets_pool_bar``: 3e-2 and ``FP16_EQUAL_SHARE``
    of the output bitwise equal) tells apart, at G 4, four slots of 17-1000
    tokens, split 4: the kernel's arithmetic (``k6_model``) meets it on
    random inputs and on inputs whose output the subnormal probabilities
    carry (``tests/_subnormal_cases.py``); the same arithmetic over keys
    rounded to bf16 fails it on both, and the one that flushes the subnormal
    probabilities fails it on the second."""
    b, kv, g, ps, mp, n_l = 4, 2, 4, 16, 64, 1
    sl = torch.tensor([17, 300, 640, 1000], dtype=torch.int32)
    if inputs == "planted":
        q, kc, vc, main, stage, pt = sub.k6_case("cpu", 96, b=b, kv=kv, g=g, ps=ps, mp=mp,
                                                 n_l=n_l)
        qs = q[-1, :g] * torch.tensor(sub.D ** -0.5, dtype=q.dtype)
        k0 = main[pt[-1, :62].long(), 0].reshape(62 * ps, kv, sub.D)[:, 0]
        share_sub, spread = sub.subnormal_share(qs, k0, 62 * ps)
        assert share_sub > 0.9 and spread > 12, (share_sub, spread)
    else:
        gen = torch.Generator().manual_seed(97)
        main = torch.randn((b * mp + 1, 2 * n_l, ps, kv * 128), generator=gen).half()
        stage = torch.randn((b, ps, 2 * n_l, kv * 128), generator=gen).half()
        q, kc, vc = (torch.randn(shape, generator=gen).bfloat16()
                     for shape in ((b, kv * g, 128), (b, kv, 128), (b, kv, 128)))
        pt = (torch.randperm(b * mp, generator=gen) + 1).reshape(b, mp).to(torch.int32)
    plain = flash_attention.flash_paged_decode_plain(q, kc, vc, main, stage, 0, pt, sl)
    if variant == "keys-bf16":
        main, stage = sub.keys_at_bf16(main, n_l), sub.keys_at_bf16(stage, n_l, dim=2)
    got = k6_model(q, kc, vc, main, stage, 0, pt, sl, 4, flush=variant == "flush")
    ok, err, share = flash_attention.meets_pool_bar(got, plain, "k6", "fp16")
    assert ok == meets, (err, share)


@pytest.mark.parametrize("tf32,meets", [(False, True), (True, False)],
                         ids=["three-pieces", "one-tf32-pass"])
def test_f32_bar_refuses_one_tf32_pass(wide_case, tf32, meets):
    """What K6's f32 bar (``meets_pool_bar``: 2e-5 plus one bf16 step, and
    ``K6_F32_EQUAL_SHARE`` of the output bitwise the plain version's) tells
    apart on the wide case's f32 pool, split 4, both layers: the kernel's
    arithmetic (keys in three TF32 pieces, PV in 3xTF32) meets it; the same
    order with the keys, probabilities and values rounded once to TF32
    fails it. (The fp16 case of the fixture checks the model's fp16 order,
    which takes no TF32 pieces, against the same rule.)"""
    dt, x, pt, sl, _ = wide_case
    fp16 = dt == "fp16"
    for layer in (0, 1):
        args = (x["q"], x["k_cur"], x["v_cur"], x["main"], x["staging"], layer, pt, sl)
        got = k6_model(*args, 4, tf32=tf32 and not fp16)
        plain = flash_attention.flash_paged_decode_plain(*args)
        ok, err, share = flash_attention.meets_pool_bar(got, plain, "k6", dt)
        assert ok == (meets or fp16), (err, share)
        if dt == "f32" and meets:
            assert share >= flash_attention.K6_F32_EQUAL_SHARE


def _tf32_values(kind):
    """f32 test values: normals of every magnitude, values near 2^-126
    (normal and subnormal, of any low bits), and the largest finite ones."""
    gen = torch.Generator().manual_seed(99)
    if kind == "random":
        mant = 1 + torch.rand(20000, generator=gen)
        exps = torch.randint(-100, 100, (20000,), generator=gen).float()
        x = mant * torch.exp2(exps)
    elif kind == "near-2^-126":
        bits = torch.randint(0, 2 ** 24, (20000,), generator=gen, dtype=torch.int32)
        x = bits.view(torch.float32)  # 0 .. 2^-125: subnormals and the first binade
        x = torch.cat([x, torch.tensor([2.0 ** -126, 2.0 ** -126 * (1 + 2.0 ** -23),
                                        2.0 ** -113 * (1 + 2.0 ** -23)])])
    else:
        bits = 0x7F7FFFFF - torch.randint(0, 2 ** 20, (20000,), generator=gen, dtype=torch.int32)
        x = torch.cat([bits.view(torch.float32), torch.tensor([torch.finfo(torch.float32).max])])
    sign = torch.where(torch.rand(x.shape, generator=gen) < 0.5, -1.0, 1.0)
    return (x * sign).float()


@pytest.mark.parametrize("kind", ["random", "near-2^-126", "largest"])
@pytest.mark.parametrize("pieces", [2, 3])
def test_tf32_split_gives_back_each_value(pieces, kind):
    """The TF32 pieces of the f32 kernels (``tf32_split``, bit for bit
    ``csrc/sm90.cuh::split2``/``split3``), summed in f64: three pieces give
    back every f32 value that is a multiple of TF32's least subnormal
    2^-136 exactly (every |x| >= 2^-113, and the largest finite values: hi
    does not round up), and any other within 2^-136 (the tensor core's
    truncation of the last piece drops its bits below 2^-136); two pieces
    within 2^-22 of |x| (the lo
    piece rounded to nearest) and, near 2^-126, within 2^-137. Every piece
    is a TF32 value (low 13 mantissa bits zero), but the three-piece lo of
    a value below 2^-113 (at most two significant bits, possibly below
    2^-136), which the tensor core takes as its TF32 truncation."""
    x = _tf32_values(kind)
    ps = flash_attention.tf32_split(x, pieces)
    assert all(torch.isfinite(p).all() for p in ps)
    exact = x.abs() >= 2.0 ** -113
    if pieces == 3:
        got = sum(flash_attention.tf32_trunc(p).double() for p in ps)
        err = (got - x.double()).abs()
        assert bool((err[exact] == 0).all())
        assert bool((err < 2.0 ** -136).all())
        assert all(bool(flash_attention.exact_in_tf32(p).all()) for p in ps[:2])
        assert bool(flash_attention.exact_in_tf32(ps[2][exact]).all())
    else:
        assert all(bool(flash_attention.exact_in_tf32(p).all()) for p in ps)
        err = (ps[0].double() + ps[1].double() - x.double()).abs()
        assert bool((err <= 2.0 ** -22 * x.double().abs() + 2.0 ** -137).all())
        assert bool((err[exact] <= 2.0 ** -22 * x[exact].double().abs()).all())
    if kind == "random":  # the bound is met, not exceeded by far: 2^-23 or more is hit
        assert pieces == 3 or float((err / x.double().abs()).max()) > 2.0 ** -23


@pytest.mark.parametrize("pool", ["bf16", "fp16", "f32"])
def test_split_rule_holds_two_blocks_per_sm(pool):
    """``flash_decode_split`` sizes the grid for ``DECODE_BLOCKS_PER_SM``
    blocks an SM; on every pool type the kernel's shared memory
    (``DECODE_SMEM_BYTES``, ``csrc/flash_decode.cu::SMEM``: the f32 kernel
    keeps one K and one V stage of rows twice as wide, the 16-bit kernels'
    ring in bytes) fits that many times in an H100 SM, each block reserving
    1 KB, and not once more; so every split the rule picks at 2B's decode
    shapes keeps the whole grid resident. The card reads the CUDA runtime's count
    back (tests/test_torch_cuda.py, chip_smoke.py)."""
    smem = flash_attention.DECODE_SMEM_BYTES[pool] + 1024
    blocks = flash_attention.DECODE_BLOCKS_PER_SM
    assert blocks * smem <= flash_attention.SM_SMEM_BYTES < (blocks + 1) * smem
    for b, mp, _ in SPLITS_2B:
        split = flash_attention.flash_decode_split(b, 5, mp * 16, H100_SMS)
        assert b * 5 * split <= blocks * H100_SMS or split == 1
