"""The host rule and the arithmetic of the port's paged flash decode (K6,
``wrinklefree_tpu_torch/csrc/flash_decode.cu``), written in PyTorch, against
the JAX reference and the port's plain version on the CPU.

The kernel deals each slot's 64-token tiles (its committed tiles, then the
tail: the staging prefix and the current token) out in equal contiguous
shares over ``flash_decode_split`` blocks of one cluster. Each of a block's
four warps owns 16 rows of every tile and keeps its own online softmax,
rounding its probabilities to bf16 against its own running max; the block
sums its warps' states in warp order, and rank 0 sums the ranks' states in
rank order. ``k6_model`` repeats that arithmetic; at every split it must stay
within the reference's bf16 bar (5e-2, tests/test_torch_kernels.py) of
``flash_paged_decode(..., interpret=True)`` and within the card's bar (2e-2,
chip_smoke.py) of the plain version. The kernel itself is held against the
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
On fp16 and f32 pools (the kernel's FMA instantiation, the query still
bf16) the plain version is held against the reference in interpret mode
(``test_wide_pools_plain_vs_reference``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
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


def k6_model(q, k_cur, v_cur, main, staging_b, layer, page_table, seq_lens, split):
    """The kernel's arithmetic: per slot, rank and warp an online softmax over
    the warp's 16 rows of each tile of the rank's share (f32 scores and
    state, probabilities rounded to bf16 before PV), warps then ranks
    combined in order, ``acc / max(l, 1e-30)``."""
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
                  torch.cat([staging_b[b, :off, layer].reshape(off, KV, D), k_cur[b][None]])]
        v_rows = [main[pages, n_l + layer].reshape(full, KV, D),
                  torch.cat([staging_b[b, :off, n_l + layer].reshape(off, KV, D),
                             v_cur[b][None]])]
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
                    s = torch.einsum("kgd,tkd->kgt", qs[b], kw.float())
                    m_new = torch.maximum(m, s.amax(dim=-1))
                    p = torch.exp(s - m_new[..., None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(dim=-1)
                    pv = torch.einsum("kgt,tkd->kgd", p.to(torch.bfloat16).float(), vw.float())
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
