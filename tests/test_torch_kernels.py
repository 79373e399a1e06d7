"""The port's kernels of the serving path — plain PyTorch versions on the
CPU — vs the JAX reference (Pallas kernels in interpret mode, or the
reference's plain path where the Pallas kernel has no interpret mode). The
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py. K5 is held in
tests/test_torch_batch1.py.

  K1 ternary_matmul_stacked_fused  vs ternary_pallas.ternary_matmul_stacked_fused
  K2 mlp_block_megakernel          vs ternary_pallas.mlp_block_megakernel
  K3 kv_write (via _dual_write)    vs kv.paged._dual_write(use_pallas=False)
  K4 flash_paged_prefill           vs flash_attention.flash_paged_prefill
  K6 flash_paged_decode            vs flash_attention.flash_paged_decode
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.kv import paged as ref_paged
from wrinklefree_tpu.ops import flash_attention as ref_flash
from wrinklefree_tpu.ops import ternary_pallas as ref_tp
from wrinklefree_tpu_torch.kv import paged
from wrinklefree_tpu_torch.ops import flash_attention, kv_update_cuda, ternary_cuda

L, LAYER = 3, 1


def ulp_bf16(x):
    ax = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(ax)) - 7)


def bf16(x):
    return (jnp.asarray(x, jnp.float32).astype(jnp.bfloat16),
            torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16))


def linear_case(k, n, rows, act, seed):
    """Packed weights, per-column scales and random N(1, 0.1) norm weights
    (bf16 values) for an L-layer stack, in both packages' layouts."""
    rng = np.random.default_rng(seed)
    qw = rng.integers(0, 256, (L, k // 4, n)).astype(np.uint8)
    sw = rng.uniform(10, 90, (L, n)).astype(np.float32)
    nw = np.asarray(jnp.asarray(rng.normal(1, 0.1, (L, k)), jnp.bfloat16).astype(jnp.float32))
    kin = 2 * k if act != "none" else k
    h = rng.normal(0, 1, (rows, kin)).astype(np.float32)
    return qw, sw, nw, h


@pytest.mark.parametrize("rows", [1, 5, 40])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("act", ["none", "relu2", "silu"])
def test_k1_plain_vs_reference(act, norm, rows):
    """K1: without a prologue (act none, no norm) the codes, accumulators and
    rescale meet the reference bit for bit. With a prologue the reference,
    run in interpret mode on the CPU, is compiled by XLA with excess
    precision allowed (xla_allow_excess_precision, on by default): the
    x*norm_weight product and the relu^2/silu products stay f32 where the
    port rounds each to bf16 as the kernel does (checked: an f32 variant of
    the norm product matches the reference bit for bit). Some int8 codes then
    move by one, which moves a row's outputs by up to 2.1% of its largest
    value over these cases (measured); the bound is 3%."""
    k, n = 256, 128
    qw, sw, nw, h = linear_case(k, n, rows, act, seed=rows * 7 + len(act))
    jh, th = bf16(h)
    ref = ref_tp.ternary_matmul_stacked_fused(
        jh, jnp.asarray(qw), LAYER,
        jnp.asarray(np.broadcast_to(sw[:, None, :], (L, 8, n))),
        jnp.asarray(np.broadcast_to(nw[:, None, :], (L, 8, k))),
        act=act, norm=norm, interpret=True)
    got = ternary_cuda.ternary_matmul_stacked_fused(
        th, torch.from_numpy(qw), LAYER, torch.from_numpy(sw),
        torch.from_numpy(nw.copy()).to(torch.bfloat16), act=act, norm=norm)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    if act == "none" and not norm:
        assert np.array_equal(ref, got)
        return
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert np.all(np.abs(ref - got) <= 0.03 * scale)


def test_k1_scalar_scale_matches_rows():
    """A per-layer scalar scale [L] equals the same value as [L, N] rows."""
    qw, sw, nw, h = linear_case(128, 64, 4, "none", seed=5)
    th = torch.from_numpy(h).to(torch.bfloat16)
    s = torch.full((L,), 42.0)
    a = ternary_cuda.ternary_matmul_stacked_fused(th, torch.from_numpy(qw), 2, s)
    b = ternary_cuda.ternary_matmul_stacked_fused(
        th, torch.from_numpy(qw), 2, s[:, None].expand(L, 64).contiguous())
    assert torch.equal(a, b)


def mlp_case(seed, rows=5, hd=256, inter=384):
    rng = np.random.default_rng(seed)
    gw = rng.integers(0, 256, (L, hd // 4, 2 * inter)).astype(np.uint8)
    dw = rng.integers(0, 256, (L, inter // 4, hd)).astype(np.uint8)
    gsc = rng.uniform(10, 90, (L, 2 * inter)).astype(np.float32)
    dsc = rng.uniform(10, 90, (L, hd)).astype(np.float32)
    pln = np.asarray(jnp.asarray(rng.normal(1, 0.1, (L, hd)), jnp.bfloat16).astype(jnp.float32))
    fsn = np.asarray(jnp.asarray(rng.normal(1, 0.1, (L, inter)), jnp.bfloat16).astype(jnp.float32))
    h = rng.normal(0, 1, (rows, hd)).astype(np.float32)
    return gw, dw, gsc, dsc, pln, fsn, h


@pytest.mark.parametrize("act,norm2", [("relu2", True), ("silu", False)])
def test_k2_plain_vs_reference(act, norm2):
    """K2: the port's plain megakernel is bitwise the composition of two
    plain K1 calls and a bf16 residual (the contract the TPU megakernel
    holds, tests/test_pallas_kernels.py); against the reference megakernel
    the bound is K1's (XLA's excess precision in the prologues), over two
    stages: 4% of the largest output."""
    gw, dw, gsc, dsc, pln, fsn, h = mlp_case(7)
    jh, th = bf16(h)
    ref = ref_tp.mlp_block_megakernel(
        jh, jnp.asarray(gw), jnp.asarray(dw), LAYER,
        jnp.asarray(np.broadcast_to(gsc[:, None], (L, 8, gsc.shape[1]))),
        jnp.asarray(np.broadcast_to(dsc[:, None], (L, 8, dsc.shape[1]))),
        jnp.asarray(np.broadcast_to(pln[:, None], (L, 8, pln.shape[1]))),
        jnp.asarray(np.broadcast_to(fsn[:, None], (L, 8, fsn.shape[1]))) if norm2 else None,
        act=act, norm2=norm2, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in dict(gw=gw, dw=dw, gsc=gsc, dsc=dsc).items()}
    tp_ln = torch.from_numpy(pln.copy()).to(torch.bfloat16)
    tf_sn = torch.from_numpy(fsn.copy()).to(torch.bfloat16)
    got = ternary_cuda.mlp_block_megakernel(
        th, t["gw"], t["dw"], LAYER, t["gsc"], t["dsc"], tp_ln, tf_sn if norm2 else None,
        act=act, norm2=norm2)
    gu = ternary_cuda.ternary_matmul_stacked_fused_plain(
        th, t["gw"], LAYER, t["gsc"], tp_ln, act="none", norm=True)
    want = th + ternary_cuda.ternary_matmul_stacked_fused_plain(
        gu, t["dw"], LAYER, t["dsc"], tf_sn if norm2 else None, act=act, norm=norm2)
    assert torch.equal(got, want)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    assert np.all(np.abs(ref - got) <= 0.04 * np.abs(ref).max())


def _to_ref_pools(main, staging, lp):
    """Port pools ([P,2L,ps,KVD], [NS+1,ps,2L,KVD]) -> reference layout with
    layers padded to lp (the padding rows stay zero)."""
    P, two_l, ps, kvd = main.shape
    n_l = two_l // 2
    rm = np.zeros((P, 2 * lp, ps, kvd), np.float32)
    rm[:, :n_l], rm[:, lp:lp + n_l] = main[:, :n_l], main[:, n_l:]
    rs = np.zeros((staging.shape[0], ps, 2 * lp, kvd), np.float32)
    rs[:, :, :n_l], rs[:, :, lp:lp + n_l] = staging[:, :, :n_l], staging[:, :, n_l:]
    return rm, rs


@pytest.mark.parametrize("case", ["decode_mid_page", "decode_completes_page",
                                  "prefill_with_remainder"])
def test_k3_dual_write_vs_reference(case):
    """K3 through _dual_write: the port's plain writer vs the reference's
    scatter path (kv_write_pallas has no interpret mode). Pools must be
    bitwise equal outside the trash page and the trash staging slot."""
    rng = np.random.default_rng(11)
    n_l, lp, ps, kvd, P, MP, B = 2, 4, 8, 64, 12, 4, 2
    NS = 3
    main = rng.normal(size=(P, 2 * n_l, ps, kvd)).astype(np.float32)
    staging = rng.normal(size=(NS + 1, ps, 2 * n_l, kvd)).astype(np.float32)
    pt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    slots = np.asarray([2, 0], np.int32)
    if case == "decode_mid_page":
        S, sl, nl = 1, np.asarray([3, 9], np.int32), np.asarray([1, 1], np.int32)
    elif case == "decode_completes_page":
        S, sl, nl = 1, np.asarray([7, 15], np.int32), np.asarray([1, 1], np.int32)
    else:
        S, sl, nl = 16, np.asarray([0, 8], np.int32), np.asarray([13, 16], np.int32)
    vals = rng.normal(size=(B, S, 2 * n_l, kvd)).astype(np.float32)

    rm, rs = _to_ref_pools(main, staging, lp)
    rvals = np.zeros((B, S, 2 * lp, kvd), np.float32)
    rvals[:, :, :n_l], rvals[:, :, lp:lp + n_l] = vals[:, :, :n_l], vals[:, :, n_l:]
    ref = ref_paged._dual_write(
        ref_paged.PagedKV(jnp.asarray(rm), None, jnp.asarray(rs)), jnp.asarray(rvals),
        jnp.asarray(pt), jnp.asarray(sl), jnp.asarray(nl), jnp.asarray(slots), False)
    got = paged._dual_write(
        paged.PagedKV(torch.from_numpy(main.copy()), torch.from_numpy(staging.copy())),
        torch.from_numpy(vals), torch.from_numpy(pt), torch.from_numpy(sl),
        torch.from_numpy(nl), torch.from_numpy(slots), kv_update_cuda.kv_write_plain)
    want_m, want_s = _to_ref_pools(got.kv.numpy(), got.staging.numpy(), lp)
    ref_m, ref_s = np.asarray(ref.kv), np.asarray(ref.staging)
    assert np.array_equal(ref_m[1:], want_m[1:])
    assert np.array_equal(ref_s[:NS], want_s[:NS])


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5), ("bf16", 3e-2)])
def test_k4_plain_vs_reference(dtype, tol):
    """K4: plain flash prefill (the _gqa_core softmax) vs the reference
    kernel in interpret mode, with garbage history beyond kv_valid and padded
    query rows beyond new_len; real rows only are compared. f32 within 2e-5;
    bf16 within 3e-2 because the kernel rounds unnormalized probabilities to
    bf16 before PV where the plain softmax rounds normalized ones."""
    cfg = RefConfig.tiny()
    KV, D, NH = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    B, S, T = 2, 128, 128
    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (B, S, NH, D)).astype(np.float32)
    k_full = rng.normal(0, 1, (B, T + S, KV, D)).astype(np.float32)
    v_full = rng.normal(0, 1, (B, T + S, KV, D)).astype(np.float32)
    kv_valid = np.asarray([50, 128], np.int32)
    new_len = np.asarray([100, 77], np.int32)
    if dtype == "bf16":
        jq, tq = bf16(q)
        jk, tk = bf16(k_full)
        jv, tv = bf16(v_full)
    else:
        jq, jk, jv = map(jnp.asarray, (q, k_full, v_full))
        tq, tk, tv = map(torch.from_numpy, (q, k_full, v_full))
    ref = ref_flash.flash_paged_prefill(
        jq, jk, jv, jnp.asarray(kv_valid), jnp.asarray(new_len), hist_len=T,
        block_q=128, block_k=128, interpret=True)
    got = flash_attention.flash_paged_prefill(
        tq, tk, tv, torch.from_numpy(kv_valid), torch.from_numpy(new_len), hist_len=T)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    assert np.isfinite(got).all()
    for b in range(B):
        np.testing.assert_allclose(got[b, :new_len[b]], ref[b, :new_len[b]],
                                   rtol=tol, atol=tol)


def _decode_case(seq_lens, dtype, ps=8, mp=4, kv=2, g=2, d=32, n_l=4):
    """tests/test_dual_kv.py::TestFlashPagedDecode's inputs: distinct pages
    per slot, random pools and queries. The port's pool rows l and n_l + l
    are the reference's rows for lp = n_l."""
    rng = np.random.default_rng(0)
    b = len(seq_lens)
    p, kvd, nh = b * mp + 2, kv * d, kv * g
    arrs = dict(
        main=rng.standard_normal((p, 2 * n_l, ps, kvd)),
        staging=rng.standard_normal((b, ps, 2 * n_l, kvd)),
        q=rng.standard_normal((b, nh, d)),
        k_cur=rng.standard_normal((b, kv, d)),
        v_cur=rng.standard_normal((b, kv, d)),
    )
    pt = np.arange(1, b * mp + 1, dtype=np.int32).reshape(b, mp)
    sl = np.asarray(seq_lens, np.int32)
    if dtype == "bf16":
        pair = {k: bf16(v) for k, v in arrs.items()}
    else:
        pair = {k: (jnp.asarray(v, jnp.float32), torch.from_numpy(v.astype(np.float32)))
                for k, v in arrs.items()}
    ref = {k: v[0] for k, v in pair.items()}
    got = {k: v[1] for k, v in pair.items()}
    return ref, got, pt, sl


def _k6_pair(seq_lens, layer, dtype, pages_per_step=4):
    ref_in, got_in, pt, sl = _decode_case(seq_lens, dtype)
    ref = ref_flash.flash_paged_decode(
        ref_in["q"], ref_in["k_cur"], ref_in["v_cur"], ref_in["main"], ref_in["staging"],
        jnp.int32(layer), jnp.asarray(pt), jnp.asarray(sl), pages_per_step=pages_per_step,
        interpret=True)
    got = flash_attention.flash_paged_decode(
        got_in["q"], got_in["k_cur"], got_in["v_cur"], got_in["main"], got_in["staging"],
        layer, torch.from_numpy(pt), torch.from_numpy(sl))
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("seq_lens", [[0, 5, 27], [8, 16, 32], [31, 1, 7]],
                         ids=["empty_staging_pages", "page_boundaries", "near_full_single"])
def test_k6_plain_vs_reference(seq_lens, layer):
    """K6: the plain decode (all committed pages as one online-softmax
    update, then staging + current token) vs the reference kernel in
    interpret mode, in f32: within 2e-5 (tests/test_dual_kv.py's bar; only
    the f32 summation order differs)."""
    ref, got = _k6_pair(seq_lens, layer, "f32")
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("pages_per_step", [1, 2, 4])
def test_k6_plain_vs_reference_pages_per_step(pages_per_step):
    """The reference's page grouping does not change its result beyond f32
    order: the plain version meets every grouping within 2e-5."""
    ref, got = _k6_pair([13, 29, 24], 1, "f32", pages_per_step)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_k6_plain_vs_reference_bf16():
    """bf16 within 5e-2 (tests/test_dual_kv.py's bar): probabilities are
    rounded to bf16 relative to each update's running max, which differs
    between one update of all pages and the reference's page groups."""
    ref, got = _k6_pair([0, 5, 27], 0, "bf16")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=5e-2)
