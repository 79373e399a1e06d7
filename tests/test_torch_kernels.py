"""The port's four kernels — plain PyTorch versions on the CPU — vs the JAX
reference (Pallas kernels in interpret mode, or the reference's plain
path where the Pallas kernel has no interpret mode). The kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

  K1 ternary_matmul_stacked_fused  vs ternary_pallas.ternary_matmul_stacked_fused
  K2 mlp_block_megakernel          vs ternary_pallas.mlp_block_megakernel
  K3 kv_write (via _dual_write)    vs kv.paged._dual_write(use_pallas=False)
  K4 flash_paged_prefill           vs flash_attention.flash_paged_prefill
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
