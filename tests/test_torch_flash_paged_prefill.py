"""The host rule and the arithmetic of the port's paged flash prefill (K4,
``wrinklefree_tpu_torch/csrc/flash_paged_prefill.cu``), written in PyTorch,
and its pool path's plain version, against the JAX reference on the CPU.

The kernel runs one block per ``flash_prefill_bq`` query tokens, KV head and
batch row; each warp owns 16 tokens of one query head and walks 64-key
tiles: the row's valid history (from the pool), then the chunk's keys up to
the block's last token, skipping the chunk tiles above its rows' diagonal,
with its own online softmax (f32 scores and state, probabilities rounded to
the pool's type against the running max before PV). bf16 and fp16 pools
run it on 64-key tiles and 16-bit ``mma``; f32 pools on 32-key tiles and
TF32 ``mma`` in three products of TF32 pieces (3xTF32: hi*hi + hi*lo +
lo*hi, ``flash_attention.tf32_split``) for the scores and for PV, the
probabilities kept in f32. ``k4_model`` repeats each kernel's order; in
bf16 it must stay within the reference's bf16 bar (3e-2,
tests/test_torch_kernels.py) of ``flash_paged_prefill(..., interpret=True)``,
in fp16 within the fp16 plain version's bar against it (3e-3,
``test_pool_plain_vs_reference``), in f32 within the reference's f32 bar
(2e-5), and within the card's bar (``flash_attention.POOL_BARS``) of the
plain version; on f32 the same order in one TF32 pass must fail that bar.
The kernel itself is held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests import _subnormal_cases as sub
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.ops import flash_attention as ref_flash
from wrinklefree_tpu_torch.ops import flash_attention

NEG = -1e30
TILE, TILE_F32, WROWS = 64, 32, 16

# BitNet-2B's prefill attention in the engine (G 4, KV 5): batch and chunk
# buckets
SHAPES_2B = [(1, 128), (1, 512), (2, 128), (2, 512), (4, 128), (4, 512)]


@pytest.mark.parametrize("b,s", SHAPES_2B, ids=[f"B{b}-S{s}" for b, s in SHAPES_2B])
def test_bq_at_2b_engine_shapes(b, s):
    """16 tokens per block at G 4: 4 warps, and the grid with the most
    blocks that any 4-8-warp block gives (40-640 blocks here)."""
    bq = flash_attention.flash_prefill_bq(4)
    assert bq == 16 and 4 * bq // 16 == 4
    fits = [x for x in flash_attention.PREFILL_BQ if 4 <= 4 * x // 16 <= 8]
    assert b * 5 * -(-s // bq) == max(b * 5 * -(-s // x) for x in fits)


@pytest.mark.parametrize("g,bq", [(1, 64), (2, 32), (3, 32), (4, 16), (5, 16), (6, 16),
                                  (7, 16), (8, 16)])
def test_bq_gives_four_to_eight_warps(g, bq):
    """At every G of 1-8, the smallest candidate with 4-8 warps."""
    got = flash_attention.flash_prefill_bq(g)
    assert got == bq and 4 <= g * got // 16 <= 8
    assert all(g * x // 16 < 4 for x in flash_attention.PREFILL_BQ if x < got)


@pytest.mark.parametrize("g", [0, 9])
def test_bq_refuses_wide_groups(g):
    with pytest.raises(ValueError):
        flash_attention.flash_prefill_bq(g)


@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("dtype", ["bf16", "fp16", "f32"])
def test_bq_by_pool_type(dtype, g):
    """The wrapper's block for each pool type: every type's kernel keeps
    ``flash_prefill_bq``'s blocks of 16-token warps (4-8 warps a block), f32
    on its 32-key tiles as bf16 and fp16 on their 64-key ones."""
    tdt = {"bf16": torch.bfloat16, "fp16": torch.float16, "f32": torch.float32}[dtype]
    got = flash_attention._prefill_bq(flash_attention.POOL_ELEM[tdt], g)
    assert got == flash_attention.flash_prefill_bq(g) and 4 <= g * got // 16 <= 8


def _dot(a, b, products):
    """a @ b in f32 as a kernel's products take them: "exact" (bf16 and fp16
    operands, exact products), "3xtf32" (each f32 operand split into TF32
    hi + lo, hi*hi + hi*lo + lo*hi) or "tf32" (one pass of operands rounded
    to TF32, for the controls)."""
    if products == "exact":
        return a @ b
    if products == "tf32":
        return flash_attention.tf32_round(a) @ flash_attention.tf32_round(b)
    ah, al = flash_attention.tf32_split(a, 2)
    bh, bl = flash_attention.tf32_split(b, 2)
    return ah @ bh + (ah @ bl + al @ bh)


def k4_model(q, k_cur, v_cur, main, layer, page_table, seq_lens, new_lens, bq, flush=False,
             products=None):
    """The kernel's order: per batch row, KV head, block of ``bq`` tokens and
    warp (16 tokens of one query head), an online softmax over the key tiles
    (64 keys; 32 on f32) of the row's valid history, then of the chunk up to
    the block's last token (tiles above the warp's diagonal skipped), f32
    scores and state, probabilities rounded to q's type (bf16 or fp16, the
    pool's; f32 as they are) against the running max before PV; ``acc /
    max(l, 1e-30)``. Products (``_dot``): exact on 16-bit pools, 3xTF32 on
    f32 unless ``products`` names another. With ``flush`` the fp16
    probabilities below 2^-14 become zero: the order of a kernel that loses
    fp16's subnormals, for the bar's controls."""
    f32 = q.dtype == torch.float32
    products = products or ("3xtf32" if f32 else "exact")
    tile = TILE_F32 if f32 else TILE
    B, S, NH, D = q.shape
    KV = k_cur.shape[2]
    G = NH // KV
    n_l, ps = main.shape[1] // 2, main.shape[2]
    MP = page_table.shape[1]
    qs = (q * torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype)).float()
    out = torch.zeros((B, S, NH, D))
    for b in range(B):
        n_h = min(max(int(seq_lens[b]), 0), MP * ps)
        nl = min(max(int(new_lens[b]), 0), S)
        pages = page_table[b, :-(-n_h // ps)].long()
        hk = main[pages, layer].reshape(-1, KV, D)[:n_h].float()
        hv = main[pages, n_l + layer].reshape(-1, KV, D)[:n_h].float()
        for kvh in range(KV):
            for s0 in range(0, S, bq):
                n_c = min(nl, s0 + bq)
                tiles = [(True, c0, hk[c0:c0 + tile, kvh], hv[c0:c0 + tile, kvh], n_h)
                         for c0 in range(0, n_h, tile)]
                tiles += [(False, c0, k_cur[b, c0:min(c0 + tile, n_c), kvh].float(),
                           v_cur[b, c0:min(c0 + tile, n_c), kvh].float(), nl)
                          for c0 in range(0, n_c, tile)]
                for h in range(kvh * G, (kvh + 1) * G):
                    for sw in range(s0, min(s0 + bq, S), WROWS):
                        rows = torch.arange(sw, min(sw + WROWS, S))
                        m = torch.full((len(rows),), NEG)
                        l = torch.zeros(len(rows))
                        acc = torch.zeros((len(rows), D))
                        for hist, c0, kt, vt, lim in tiles:
                            if not hist and c0 > sw + WROWS - 1:
                                continue  # above every row's diagonal
                            sc = _dot(qs[b, rows, h], kt.T, products)
                            col = c0 + torch.arange(kt.shape[0])
                            ok = (col[None, :] < lim) & (hist | (col[None, :] <= rows[:, None]))
                            sc = torch.where(ok, sc, torch.tensor(NEG))
                            m_new = torch.maximum(m, sc.amax(dim=1))
                            p = torch.exp(sc - m_new[:, None])
                            alpha = torch.exp(m - m_new)
                            l = l * alpha + p.sum(dim=1)
                            pr = p.to(q.dtype)
                            if flush:
                                pr = torch.where(pr < 2.0 ** -14, 0.0, pr)
                            acc = acc * alpha[:, None] + _dot(pr.float(), vt, products)
                            m = m_new
                        out[b, rows, h] = acc / torch.clamp_min(l, 1e-30)[:, None]
    return out.to(q.dtype)


def _pool_case(dtype, seed=0):
    """The tiny config's heads (4 query / 2 KV of 32), 2 layers, page size 8,
    12 pages per row, a 64-token chunk; seq_lens 0 and three pages, new_lens
    below S. The port's inputs and the reference's k_full/v_full, built as
    ``wrinklefree_tpu/kv/paged.py``'s flash prefill builds them (the pool's
    rows l and n_l + l are the reference's rows for lp = n_l)."""
    cfg = RefConfig.tiny()
    NH, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, S, ps, MP, n_l = 2, 64, 8, 12, 2
    rng = np.random.default_rng(seed)
    arrs = dict(q=rng.normal(0, 1, (B, S, NH, D)), k_cur=rng.normal(0, 1, (B, S, KV, D)),
                v_cur=rng.normal(0, 1, (B, S, KV, D)),
                main=rng.normal(0, 1, (B * MP + 1, 2 * n_l, ps, KV * D)))
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp16": (jnp.float16, torch.float16),
                "f32": (jnp.float32, torch.float32)}[dtype]
    ref = {k: jnp.asarray(v, jnp.float32).astype(jdt) for k, v in arrs.items()}
    got = {k: torch.from_numpy(v.astype(np.float32)).to(tdt) for k, v in arrs.items()}
    pt = (rng.permutation(B * MP) + 1).astype(np.int32).reshape(B, MP)
    sl = np.asarray([0, 3 * ps], np.int32)
    nl = np.asarray([S - 3, 5], np.int32)
    T = MP * ps

    def reference(layer):
        k_hist = ref["main"][jnp.asarray(pt), layer].reshape(B, T, KV, D)
        v_hist = ref["main"][jnp.asarray(pt), n_l + layer].reshape(B, T, KV, D)
        k_full = jnp.concatenate([k_hist, ref["k_cur"].astype(k_hist.dtype)], axis=1)
        v_full = jnp.concatenate([v_hist, ref["v_cur"].astype(v_hist.dtype)], axis=1)
        out = ref_flash.flash_paged_prefill(
            ref["q"].astype(k_full.dtype), k_full, v_full, jnp.asarray(sl), jnp.asarray(nl),
            hist_len=T, interpret=True)
        return np.asarray(out.astype(jnp.float32))

    return got, torch.from_numpy(pt), torch.from_numpy(sl), torch.from_numpy(nl), reference


def _assert_real_rows(got, want, new_lens, tol):
    assert np.isfinite(got).all()
    for b, n in enumerate(new_lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=tol, atol=tol)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("dtype,tol", [("f32", 2e-5), ("fp16", 3e-3), ("bf16", 3e-2)])
def test_pool_plain_vs_reference(dtype, tol, layer):
    """The pool wrapper on CPU tensors (its plain version: the history
    gathered from the table's pages, then the chunk) against the reference
    kernel in interpret mode over the k_full it builds from the same pool, on
    each unquantized pool type: f32 within 2e-5 (the reference at HIGHEST
    precision; only the f32 sums' order differs); bf16 within 3e-2 and fp16
    within 3e-3 (the reference rounds unnormalized probabilities to the
    pool's type before PV, the plain softmax normalized ones: a relative
    2^-8 in bf16, 2^-11 in fp16, on values of a few units). Real rows only."""
    x, pt, sl, nl, reference = _pool_case(dtype)
    got = flash_attention.flash_paged_prefill_pool(
        x["q"], x["k_cur"], x["v_cur"], x["main"], layer, pt, sl, nl)
    _assert_real_rows(got.float().numpy(), reference(layer), nl.tolist(), tol)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("bq", [32, 64])
def test_kernel_order_vs_reference_and_plain(bq, layer):
    """The kernel's order (k4_model) at the query tokens per block that the
    wrapper picks for G 2 (32: 4 warps) and at 64 (8 warps, which the kernel
    also takes) against the reference in interpret mode and the pool
    wrapper's plain version, bf16, within 3e-2 on the real rows."""
    x, pt, sl, nl, reference = _pool_case("bf16", seed=1)
    NH, KV = x["q"].shape[2], x["k_cur"].shape[2]
    assert flash_attention.flash_prefill_bq(NH // KV) == 32
    args = (x["q"], x["k_cur"], x["v_cur"], x["main"], layer, pt, sl, nl)
    got = k4_model(*args, bq).float().numpy()
    plain = flash_attention.flash_paged_prefill_pool_plain(*args).float().numpy()
    _assert_real_rows(got, reference(layer), nl.tolist(), 3e-2)
    _assert_real_rows(got, plain, nl.tolist(), 3e-2)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("bq", [32, 64])
def test_kernel_order_fp16_vs_reference_and_plain(bq, layer):
    """The kernel's order on an fp16 pool (q, the chunk, the pool and the
    output fp16; probabilities rounded to fp16, subnormals kept, against the
    running max; 16-token warps at ``flash_prefill_bq``'s blocks, as in bf16)
    against the reference in interpret mode within 3e-3 (the fp16 plain
    version's bar against it: probabilities round to fp16 against another
    running max, 2^-11 relative) and against the plain version within the
    card's bar (``POOL_BARS``, 3e-2), on the real rows."""
    x, pt, sl, nl, reference = _pool_case("fp16", seed=1)
    NH, KV = x["q"].shape[2], x["k_cur"].shape[2]
    assert flash_attention._prefill_bq(flash_attention.POOL_ELEM[torch.float16], NH // KV) == 32
    args = (x["q"], x["k_cur"], x["v_cur"], x["main"], layer, pt, sl, nl)
    got = k4_model(*args, bq)
    assert got.dtype == torch.float16
    plain = flash_attention.flash_paged_prefill_pool_plain(*args)
    _assert_real_rows(got.float().numpy(), reference(layer), nl.tolist(), 3e-3)
    for b, n in enumerate(nl.tolist()):
        ok, err, _ = flash_attention.meets_pool_bar(got[b, :n], plain[b, :n], "k4", "fp16")
        assert ok, err


# (inputs, the model's variant, whether it meets the fp16 bar)
FP16_CONTROLS = [("random", "kernel", True), ("random", "keys-bf16", False),
                 ("planted", "kernel", True), ("planted", "keys-bf16", False),
                 ("planted", "flush", False)]


@pytest.mark.parametrize("inputs,variant,meets", FP16_CONTROLS,
                         ids=[f"{i}-{v}" for i, v, _ in FP16_CONTROLS])
def test_fp16_bar_refuses_inexact_orders(inputs, variant, meets):
    """What the fp16 bar (``meets_pool_bar``: 3e-2 and ``FP16_EQUAL_SHARE``
    of each real row bitwise equal) tells apart, at G 4, two rows of 64 and
    40 chunk tokens after 256 and 80: the kernel's order (``k4_model``)
    meets it on random inputs and on inputs whose output the subnormal
    probabilities carry (``tests/_subnormal_cases.py``); the same order over
    keys rounded to bf16 fails it on both, and the order that flushes the
    subnormal probabilities fails it on the second."""
    b, s, kv, g, ps, mp, n_l = 2, 64, 2, 4, 16, 16, 1
    sl, nl = torch.tensor([256, 80], dtype=torch.int32), torch.tensor([64, 40],
                                                                     dtype=torch.int32)
    if inputs == "planted":
        q, kc, vc, main, pt = sub.k4_case("cpu", 95, b=b, s=s, kv=kv, g=g, ps=ps, mp=mp,
                                          n_l=n_l)
        qs = q[0, :, :g].reshape(-1, sub.D) * torch.tensor(sub.D ** -0.5, dtype=q.dtype)
        k0 = main[pt[0].long(), 0].reshape(mp * ps, kv, sub.D)[:, 0]
        share_sub, spread = sub.subnormal_share(qs, k0, 256)
        assert share_sub > 0.9 and spread > 12, (share_sub, spread)
    else:
        gen = torch.Generator().manual_seed(94)
        q, kc, vc = (torch.randn(shape, generator=gen).half()
                     for shape in ((b, s, kv * g, 128), (b, s, kv, 128), (b, s, kv, 128)))
        main = torch.randn((b * mp + 1, 2 * n_l, ps, kv * 128), generator=gen).half()
        pt = (torch.randperm(b * mp, generator=gen) + 1).reshape(b, mp).to(torch.int32)
    plain = flash_attention.flash_paged_prefill_pool_plain(q, kc, vc, main, 0, pt, sl, nl)
    if variant == "keys-bf16":
        kc, main = kc.bfloat16().half(), sub.keys_at_bf16(main, n_l)
    got = k4_model(q, kc, vc, main, 0, pt, sl, nl, flash_attention.flash_prefill_bq(g),
                   flush=variant == "flush")
    oks = [flash_attention.meets_pool_bar(got[i, :n], plain[i, :n], "k4", "fp16")
           for i, n in enumerate(nl.tolist())]
    assert all(ok for ok, _, _ in oks) == meets, oks


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("bq", [32, 64])
def test_kernel_order_f32_vs_reference_and_plain(bq, layer):
    """The f32 kernel's order (q, the chunk, the pool and the output f32;
    32-key tiles, scores and PV in 3xTF32, the probabilities f32; 16-token
    warps at ``flash_prefill_bq``'s blocks) against the reference in
    interpret mode (HIGHEST precision) within its f32 bar, 2e-5, and against
    the plain version within the card's (``POOL_BARS``, 2e-5), on the real
    rows."""
    x, pt, sl, nl, reference = _pool_case("f32", seed=1)
    NH, KV = x["q"].shape[2], x["k_cur"].shape[2]
    assert flash_attention._prefill_bq(flash_attention.POOL_ELEM[torch.float32], NH // KV) == 32
    args = (x["q"], x["k_cur"], x["v_cur"], x["main"], layer, pt, sl, nl)
    got = k4_model(*args, bq)
    assert got.dtype == torch.float32
    plain = flash_attention.flash_paged_prefill_pool_plain(*args)
    _assert_real_rows(got.numpy(), reference(layer), nl.tolist(), 2e-5)
    for b, n in enumerate(nl.tolist()):
        ok, err, _ = flash_attention.meets_pool_bar(got[b, :n], plain[b, :n], "k4", "f32")
        assert ok, err


# (the scale of q and k, the products, whether the order meets the f32 bar)
F32_CONTROLS = [(1.0, "3xtf32", True), (1.0, "tf32", False), (2.0, "3xtf32", True),
                (2.0, "tf32", False)]


@pytest.mark.parametrize("scale,products,meets", F32_CONTROLS,
                         ids=[f"x{s:g}-{p}" for s, p, _ in F32_CONTROLS])
def test_f32_bar_refuses_one_tf32_pass(scale, products, meets):
    """What K4's f32 bar (2e-5 on each real row) tells apart, at G 4, D 128,
    two rows of 64 and 40 chunk tokens after 256 and 80, q and keys of
    ``scale`` units a dim: the kernel's order in 3xTF32 meets it, the same
    order with each operand rounded once to TF32 (10 mantissa bits) fails
    it (max errors about 1e-6 and 5e-4 at 1 unit, 1.6e-5 and 4e-3 at 2).
    At 3 units the bar no longer holds even exact f32 products in the
    kernel's order (2.0e-5: q scaled before the product, the plain version
    scales the scores), so the scales stop at 2."""
    b, s, kv, g, ps, mp, n_l = 2, 64, 2, 4, 16, 16, 1
    sl, nl = torch.tensor([256, 80], dtype=torch.int32), torch.tensor([64, 40],
                                                                     dtype=torch.int32)
    gen = torch.Generator().manual_seed(98)
    q = torch.randn((b, s, kv * g, 128), generator=gen) * scale
    kc = torch.randn((b, s, kv, 128), generator=gen) * scale
    vc = torch.randn((b, s, kv, 128), generator=gen)
    main = torch.randn((b * mp + 1, 2 * n_l, ps, kv * 128), generator=gen)
    main[:, :n_l] *= scale  # the key rows
    pt = (torch.randperm(b * mp, generator=gen) + 1).reshape(b, mp).to(torch.int32)
    plain = flash_attention.flash_paged_prefill_pool_plain(q, kc, vc, main, 0, pt, sl, nl)
    got = k4_model(q, kc, vc, main, 0, pt, sl, nl, flash_attention.flash_prefill_bq(g),
                   products=products)
    oks = [flash_attention.meets_pool_bar(got[i, :n], plain[i, :n], "k4", "f32")
           for i, n in enumerate(nl.tolist())]
    assert all(ok for ok, _, _ in oks) == meets, oks
