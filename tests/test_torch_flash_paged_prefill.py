"""The host rule and the arithmetic of the port's paged flash prefill (K4,
``wrinklefree_tpu_torch/csrc/flash_paged_prefill.cu``), written in PyTorch,
and its pool path's plain version, against the JAX reference on the CPU.

The kernel runs one block per ``flash_prefill_bq`` query tokens, KV head and
batch row; each warp owns 16 tokens of one query head and walks 64-key
tiles: the row's valid history (from the pool), then the chunk's keys up to
the block's last token, skipping the chunk tiles above its rows' diagonal,
with its own online softmax (f32 scores and state, probabilities rounded to
bf16 against the running max before PV). ``k4_model`` repeats that order; it
must stay within the reference's bf16 bar (3e-2, tests/test_torch_kernels.py)
of ``flash_paged_prefill(..., interpret=True)`` and within the card's bar
(3e-2, chip_smoke.py) of the plain version. The kernel itself is held
against the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.ops import flash_attention as ref_flash
from wrinklefree_tpu_torch.ops import flash_attention

NEG = -1e30
TILE, WROWS = 64, 16

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


def k4_model(q, k_cur, v_cur, main, layer, page_table, seq_lens, new_lens, bq):
    """The kernel's order: per batch row, KV head, block of ``bq`` tokens and
    warp (16 tokens of one query head), an online softmax over the 64-key
    tiles of the row's valid history, then of the chunk up to the block's
    last token (tiles above the warp's diagonal skipped), f32 scores and
    state, probabilities rounded to bf16 against the running max before PV;
    ``acc / max(l, 1e-30)``."""
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
                tiles = [(True, c0, hk[c0:c0 + TILE, kvh], hv[c0:c0 + TILE, kvh], n_h)
                         for c0 in range(0, n_h, TILE)]
                tiles += [(False, c0, k_cur[b, c0:min(c0 + TILE, n_c), kvh].float(),
                           v_cur[b, c0:min(c0 + TILE, n_c), kvh].float(), nl)
                          for c0 in range(0, n_c, TILE)]
                for h in range(kvh * G, (kvh + 1) * G):
                    for sw in range(s0, min(s0 + bq, S), WROWS):
                        rows = torch.arange(sw, min(sw + WROWS, S))
                        m = torch.full((len(rows),), NEG)
                        l = torch.zeros(len(rows))
                        acc = torch.zeros((len(rows), D))
                        for hist, c0, kt, vt, lim in tiles:
                            if not hist and c0 > sw + WROWS - 1:
                                continue  # above every row's diagonal
                            sc = qs[b, rows, h] @ kt.T
                            col = c0 + torch.arange(kt.shape[0])
                            ok = (col[None, :] < lim) & (hist | (col[None, :] <= rows[:, None]))
                            sc = torch.where(ok, sc, torch.tensor(NEG))
                            m_new = torch.maximum(m, sc.amax(dim=1))
                            p = torch.exp(sc - m_new[:, None])
                            alpha = torch.exp(m - m_new)
                            l = l * alpha + p.sum(dim=1)
                            acc = acc * alpha[:, None] + p.to(torch.bfloat16).float() @ vt
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
