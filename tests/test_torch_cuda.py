"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda`` and skipped on hosts without a GPU. Imports torch and the
port only (no jax), so it runs on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: the suite's conftest configures jax, which the GPU
machine does not have). chip_smoke.py repeats these checks at BitNet-2B
shapes.
"""

import pytest
import torch

# by its own name: pytest puts this directory on the path, while ``tests.``
# would find any other installed package of that name first
import _subnormal_cases as sub
from wrinklefree_tpu_torch.ops import flash_attention, kv_update_cuda, ternary_cuda

L, LAYER = 3, 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4", "k5", "k6", "k7"])
def test_kernel_matches_plain_on_card(kernel):
    """Each CUDA kernel against its plain version on the card, at a small
    size (chip_smoke.py holds them at BitNet-2B shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    if kernel in ("k1", "k2"):
        g = torch.Generator(device=dev).manual_seed(3)
        hd, inter = 256, 384
        t = [
            torch.randint(0, 256, (L, hd // 4, 2 * inter), generator=g, device=dev,
                          dtype=torch.uint8),
            torch.randint(0, 256, (L, inter // 4, hd), generator=g, device=dev,
                          dtype=torch.uint8),
            torch.rand((L, 2 * inter), generator=g, device=dev) * 80 + 10,
            torch.rand((L, hd), generator=g, device=dev) * 80 + 10,
        ]
        ln = (1 + 0.1 * torch.randn((L, hd), generator=g, device=dev)).to(torch.bfloat16)
        sn = (1 + 0.1 * torch.randn((L, inter), generator=g, device=dev)).to(torch.bfloat16)
        th = torch.randn((5, hd), generator=g, device=dev).to(torch.bfloat16)
        if kernel == "k1":
            for rows in (1, 5, 40):
                x = th[:1].expand(rows, -1).contiguous()
                a = ternary_cuda.ternary_matmul_stacked_fused(x, t[0], LAYER, t[2], ln)
                b = ternary_cuda.ternary_matmul_stacked_fused_plain(x, t[0], LAYER, t[2], ln)
                # the prologue's variance sums in another order than torch's:
                # an int8 code may move by one (see chip_smoke.py)
                assert ((a.float() - b.float()).abs()
                        <= 0.03 * b.float().abs().amax(dim=1, keepdim=True)).all()
        else:
            a = ternary_cuda.mlp_block_megakernel(th, t[0], t[1], LAYER, t[2], t[3], ln, sn)
            b = ternary_cuda.mlp_block_megakernel_plain(th, t[0], t[1], LAYER, t[2], t[3], ln, sn)
            assert ((a.float() - b.float()).abs()
                    <= 0.05 * b.float().abs().amax(dim=1, keepdim=True)).all()
    elif kernel == "k3":
        pool = torch.randn(6, 8, 4, 64, device=dev, dtype=torch.bfloat16)
        vals = torch.randn(5, 4, 64, device=dev, dtype=torch.bfloat16)
        ids = torch.tensor([1, 2, 3, 4, 5], device=dev, dtype=torch.int32)
        offs = torch.tensor([0, 7, 3, 3, 1], device=dev, dtype=torch.int32)
        a = kv_update_cuda.kv_write(pool.clone(), vals, ids, offs)
        b = kv_update_cuda.kv_write_plain(pool.clone(), vals, ids, offs)
        assert torch.equal(a, b)
    elif kernel == "k5":
        g = torch.Generator(device=dev).manual_seed(5)
        hd, nh, kvh, T = 512, 4, 2, 40
        nq = nh * 128 + 2 * kvh * 128
        qkv_qw = torch.randint(0, 256, (L, hd // 4, nq), generator=g, device=dev,
                               dtype=torch.uint8)
        o_qw = torch.randint(0, 256, (L, nh * 32, hd), generator=g, device=dev,
                             dtype=torch.uint8)
        qs = torch.rand((L, nq), generator=g, device=dev) * 80 + 10
        osc = torch.rand((L, hd), generator=g, device=dev) * 80 + 10
        ln = (1 + 0.1 * torch.randn((L, hd), generator=g, device=dev)).to(torch.bfloat16)
        sn = (1 + 0.1 * torch.randn((L, nh * 128), generator=g, device=dev)).to(torch.bfloat16)
        h = torch.randn((1, hd), generator=g, device=dev).to(torch.bfloat16)
        ck = torch.randn((L, 1, T, kvh, 128), generator=g, device=dev).to(torch.bfloat16)
        cv = torch.randn((L, 1, T, kvh, 128), generator=g, device=dev).to(torch.bfloat16)
        cos = torch.rand(128, generator=g, device=dev).to(torch.bfloat16)
        sin = torch.rand(128, generator=g, device=dev).to(torch.bfloat16)
        kw = dict(q_dim=nh * 128, n_kv=kvh, n_heads=nh, head_dim=128)
        for pos in (0, 17, T - 1):
            ka, va, kb, vb = ck.clone(), cv.clone(), ck.clone(), cv.clone()
            p = torch.tensor([pos], dtype=torch.int32, device=dev)
            a, ka, va = ternary_cuda.attn_block_megakernel(
                h, ka, va, qkv_qw, o_qw, LAYER, p, qs, osc, ln, sn, cos, sin, **kw)
            b, kb, vb = ternary_cuda.attn_block_megakernel_plain(
                h, kb, vb, qkv_qw, o_qw, LAYER, p, qs, osc, ln, sn, cos, sin, **kw)
            # the prologues' reductions run in another order than torch's
            # (an int8 code may move by one), as for K1/K2
            assert ((a.float() - b.float()).abs() <= 0.05 * b.float().abs().max()).all()
            keep = torch.ones(L, T, dtype=torch.bool, device=dev)
            keep[LAYER, pos] = False
            assert torch.equal(ka[:, 0][keep], ck[:, 0][keep])
            assert torch.equal(va[:, 0][keep], cv[:, 0][keep])
            for x, y in ((ka, kb), (va, vb)):
                r, s = x[LAYER, 0, pos].float(), y[LAYER, 0, pos].float()
                assert ((r - s).abs() <= 0.03 * s.abs().max()).all()
    elif kernel == "k7":
        # one stacked shape (per-layer and per-column scales, 1 / 8 / 40 rows)
        # and one expert-shaped matrix (bf16, f32 and the int32 mode): the
        # dot is exact integer math and the rescale the same IEEE operations,
        # so bit for bit
        g = torch.Generator(device=dev).manual_seed(7)
        qw = torch.randint(0, 256, (L, 64, 384), generator=g, device=dev, dtype=torch.uint8)
        sw_l = torch.rand((L,), generator=g, device=dev) * 80 + 10
        sw_n = torch.rand((L, 384), generator=g, device=dev) * 80 + 10
        ew = torch.randint(0, 256, (2, 3, 96, 256), generator=g, device=dev, dtype=torch.uint8)
        esw = torch.rand((2, 3), generator=g, device=dev) * 80 + 10
        for rows in (1, 8, 40):
            xq = torch.randint(-128, 128, (rows, 256), generator=g, device=dev, dtype=torch.int8)
            sx = torch.rand((rows, 1), generator=g, device=dev) * 60 + 0.5
            for sw in (sw_l, sw_n):
                a = ternary_cuda.ternary_matmul_stacked(xq, qw, LAYER, sx, sw)
                b = ternary_cuda.ternary_matmul_stacked_plain(xq, qw, LAYER, sx, sw)
                assert torch.equal(a, b)
            xe = torch.randint(-128, 128, (rows, 384), generator=g, device=dev, dtype=torch.int8)
            for dt in (torch.bfloat16, torch.float32):
                a = ternary_cuda.ternary_matmul(xe, ew[1, 2], sx, esw[1, 2], out_dtype=dt)
                b = ternary_cuda.ternary_matmul_plain(xe, ew[1, 2], sx, esw[1, 2], out_dtype=dt)
                assert a.dtype == dt and torch.equal(a, b)
            assert torch.equal(ternary_cuda.ternary_matmul(xe, ew[1, 2]),
                               ternary_cuda.ternary_matmul_plain(xe, ew[1, 2]))
    elif kernel == "k6":
        g = torch.Generator(device=dev).manual_seed(6)
        B, kvh, nh, ps, mp, n_l = 3, 2, 8, 16, 8, 2
        main = torch.randn((B * mp + 1, 2 * n_l, ps, kvh * 128), generator=g,
                           device=dev).to(torch.bfloat16)
        stage = torch.randn((B, ps, 2 * n_l, kvh * 128), generator=g,
                            device=dev).to(torch.bfloat16)
        q = torch.randn((B, nh, 128), generator=g, device=dev).to(torch.bfloat16)
        kc = torch.randn((B, kvh, 128), generator=g, device=dev).to(torch.bfloat16)
        vc = torch.randn((B, kvh, 128), generator=g, device=dev).to(torch.bfloat16)
        pt = (torch.randperm(B * mp, generator=g, device=dev) + 1).reshape(B, mp).to(torch.int32)
        sl = torch.tensor([0, 37, 127], dtype=torch.int32, device=dev)
        for layer in (0, 1):
            a = flash_attention.flash_paged_decode(q, kc, vc, main, stage, layer, pt, sl)
            b = flash_attention.flash_paged_decode_plain(q, kc, vc, main, stage, layer, pt, sl)
            # probabilities round to bf16 against each tile's running max
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)
    else:
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(1, 96, 4, 128, device=dev, generator=g).to(torch.bfloat16)
        kf = torch.randn(1, 160, 2, 128, device=dev, generator=g).to(torch.bfloat16)
        vf = torch.randn(1, 160, 2, 128, device=dev, generator=g).to(torch.bfloat16)
        kvv = torch.tensor([40], device=dev, dtype=torch.int32)
        nl = torch.tensor([90], device=dev, dtype=torch.int32)
        a = flash_attention.flash_paged_prefill(q, kf, vf, kvv, nl, hist_len=64)
        b = flash_attention.flash_paged_prefill_plain(q, kf, vf, kvv, nl, hist_len=64)
        torch.testing.assert_close(a[:, :90].float(), b[:, :90].float(), rtol=3e-2, atol=3e-2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [9, 40, 64, 65, 130, 512])
@pytest.mark.parametrize("kernel", ["k1", "k7"])
def test_gemm_rows_match_on_card(kernel, rows):
    """Above 8 rows K1 and K7 run the tensor-core GEMM (csrc/ternary_gemm.cu),
    here at a ragged K/4 (84, not a multiple of its 32-row stage) and N (272,
    not a multiple of its 128-column tile), and at an even shape. K7 bit for
    bit against its plain version in bf16, f32 and int32 (exact integer dot,
    the same IEEE rescale). K1 bit for bit against itself over its 8-row
    slices (the same per-row prologue, exact dot and epilogue formula, through
    the GEMV of csrc/ternary_gemv.cu), and within K1's 3% of its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11 + rows)
    counter = (ternary_cuda.ternary_matmul_stacked_fused if kernel == "k1"
               else ternary_cuda.ternary_matmul_stacked)
    for k, n, act in ((336, 272, "relu2"), (256, 384, "none")):
        qw = torch.randint(0, 256, (L, k // 4, n), generator=g, device=dev, dtype=torch.uint8)
        sw_l = torch.rand((L,), generator=g, device=dev) * 80 + 10
        sw_n = torch.rand((L, n), generator=g, device=dev) * 80 + 10
        n0 = counter.tiled_launches
        if kernel == "k7":
            xq = torch.randint(-128, 128, (rows, k), generator=g, device=dev, dtype=torch.int8)
            sx = torch.rand((rows, 1), generator=g, device=dev) * 60 + 0.5
            for dt in (torch.bfloat16, torch.float32):
                for sw in (sw_l, sw_n):
                    a = ternary_cuda.ternary_matmul_stacked(xq, qw, LAYER, sx, sw, out_dtype=dt)
                    b = ternary_cuda.ternary_matmul_stacked_plain(xq, qw, LAYER, sx, sw,
                                                                  out_dtype=dt)
                    assert a.dtype == dt and torch.equal(a, b)
            a = ternary_cuda.ternary_matmul(xq, qw[LAYER])
            assert a.dtype == torch.int32
            assert torch.equal(a, ternary_cuda.ternary_matmul_plain(xq, qw[LAYER]))
            assert counter.tiled_launches - n0 == 5
        else:
            ln = (1 + 0.1 * torch.randn((L, k), generator=g, device=dev)).to(torch.bfloat16)
            kin = 2 * k if act == "relu2" else k
            x = torch.randn((rows, kin), generator=g, device=dev).to(torch.bfloat16)
            a = ternary_cuda.ternary_matmul_stacked_fused(x, qw, LAYER, sw_n, ln, act=act)
            assert counter.tiled_launches - n0 == 1
            slices = torch.cat([ternary_cuda.ternary_matmul_stacked_fused(
                x[r:r + 8], qw, LAYER, sw_n, ln, act=act) for r in range(0, rows, 8)])
            assert torch.equal(a, slices)
            b = ternary_cuda.ternary_matmul_stacked_fused_plain(x, qw, LAYER, sw_n, ln, act=act)
            assert ((a.float() - b.float()).abs()
                    <= 0.03 * b.float().abs().amax(dim=1, keepdim=True)).all()
    torch.cuda.synchronize()


# (K, N, K1's activation): BitNet-2B's qkv, expert (and K1's relu^2) down and
# k; ragged: K/4 = 84 and 100 (not multiples of the GEMV's 8-row k-step or of
# its split), N = 272 and 144 (not multiples of its 128-column tile)
GEMV_SHAPES = [(2560, 3840, "none"), (6912, 2560, "relu2"), (2560, 640, "none"),
               (336, 272, "relu2"), (400, 144, "none")]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("kernel", ["k1", "k7"])
def test_gemv_rows_match_on_card(kernel, rows):
    """At 8 rows or fewer K1 and K7 run the packed-ternary GEMV
    (csrc/ternary_gemv.cu), here at 2B shapes and ragged ones. K7 bit for bit
    against its plain version in bf16, f32 (per-layer and per-column scales)
    and int32 (exact integer dot, the same IEEE rescale). K1 bit for bit
    against the tensor-core GEMM's rows (its first `rows` rows of a 16-row
    call: the same per-row prologue, exact dot and epilogue), and within K1's
    3% of its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23 + rows)
    counter = (ternary_cuda.ternary_matmul_stacked_fused if kernel == "k1"
               else ternary_cuda.ternary_matmul_stacked)
    for k, n, act in GEMV_SHAPES:
        qw = torch.randint(0, 256, (L, k // 4, n), generator=g, device=dev, dtype=torch.uint8)
        sw_l = torch.rand((L,), generator=g, device=dev) * 80 + 10
        sw_n = torch.rand((L, n), generator=g, device=dev) * 80 + 10
        n0, t0 = counter.launches, counter.tiled_launches
        if kernel == "k7":
            xq = torch.randint(-128, 128, (rows, k), generator=g, device=dev, dtype=torch.int8)
            sx = torch.rand((rows, 1), generator=g, device=dev) * 60 + 0.5
            for dt in (torch.bfloat16, torch.float32):
                for sw in (sw_l, sw_n):
                    a = ternary_cuda.ternary_matmul_stacked(xq, qw, LAYER, sx, sw, out_dtype=dt)
                    b = ternary_cuda.ternary_matmul_stacked_plain(xq, qw, LAYER, sx, sw,
                                                                  out_dtype=dt)
                    assert a.dtype == dt and torch.equal(a, b), (k, n, dt)
            a = ternary_cuda.ternary_matmul(xq, qw[LAYER])
            assert a.dtype == torch.int32
            assert torch.equal(a, ternary_cuda.ternary_matmul_plain(xq, qw[LAYER])), (k, n)
            assert counter.launches - n0 == 5
        else:
            ln = (1 + 0.1 * torch.randn((L, k), generator=g, device=dev)).to(torch.bfloat16)
            kin = 2 * k if act == "relu2" else k
            x = torch.randn((16, kin), generator=g, device=dev).to(torch.bfloat16)
            a = ternary_cuda.ternary_matmul_stacked_fused(x[:rows], qw, LAYER, sw_n, ln, act=act)
            assert counter.launches - n0 == 1 and counter.tiled_launches == t0
            gemm = ternary_cuda.ternary_matmul_stacked_fused(x, qw, LAYER, sw_n, ln, act=act)
            assert counter.tiled_launches - t0 == 1
            assert torch.equal(a, gemm[:rows]), (k, n)
            b = ternary_cuda.ternary_matmul_stacked_fused_plain(x[:rows], qw, LAYER, sw_n, ln,
                                                                act=act)
            assert ((a.float() - b.float()).abs()
                    <= 0.03 * b.float().abs().amax(dim=1, keepdim=True)).all(), (k, n)
    torch.cuda.synchronize()


# (H, I): a small MLP (6 gateup and 2 down tiles of the streamed dot), and
# BitNet-2B's (108 and 20 tiles; K/4 = 640 and 1728)
K2_SHAPES = [(256, 384), (2560, 6912)]


@pytest.mark.cuda
@pytest.mark.parametrize("act,norm2", [("relu2", True), ("silu", False)])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8])
def test_k2_equals_k1_composition_on_card(rows, act, norm2):
    """K2's dots are exact int32 sums in any order, and its prologues and
    epilogues are K1's arithmetic: so K2 is bit for bit h + K1(K1(h, gateup,
    post_ln), down, act, ffn_sub) through the port's own K1, and two calls
    are bitwise equal (the streamed dots' int32 merge order does not show)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(41 + rows)
    for hd, inter in K2_SHAPES:
        gw = torch.randint(0, 256, (L, hd // 4, 2 * inter), generator=g, device=dev,
                           dtype=torch.uint8)
        dw = torch.randint(0, 256, (L, inter // 4, hd), generator=g, device=dev,
                           dtype=torch.uint8)
        gs = torch.rand((L, 2 * inter), generator=g, device=dev) * 80 + 10
        ds = torch.rand((L,), generator=g, device=dev) * 80 + 10
        ln = (1 + 0.1 * torch.randn((L, hd), generator=g, device=dev)).to(torch.bfloat16)
        sn = (1 + 0.1 * torch.randn((L, inter), generator=g, device=dev)).to(torch.bfloat16)
        h = torch.randn((rows, hd), generator=g, device=dev).to(torch.bfloat16)
        sub = sn if norm2 else None
        n0 = ternary_cuda.mlp_block_megakernel.launches
        a = ternary_cuda.mlp_block_megakernel(h, gw, dw, LAYER, gs, ds, ln, sub, act=act,
                                              norm2=norm2)
        b = ternary_cuda.mlp_block_megakernel(h, gw, dw, LAYER, gs, ds, ln, sub, act=act,
                                              norm2=norm2)
        assert ternary_cuda.mlp_block_megakernel.launches - n0 == 2
        gu = ternary_cuda.ternary_matmul_stacked_fused(h, gw, LAYER, gs, ln)
        want = h + ternary_cuda.ternary_matmul_stacked_fused(gu, dw, LAYER, ds, sub, act=act,
                                                             norm=norm2)
        torch.cuda.synchronize()
        assert torch.isfinite(a).all()
        assert torch.equal(a, want), (hd, inter, (a.float() - want.float()).abs().max().item())
        assert torch.equal(a, b), (hd, inter)


# (H, query heads, KV heads) of 128: a small block (4 qkv and 4 o tiles of
# the streamed dot) and BitNet-2B's (30 and 20 tiles; K/4 = 640 for both)
K5_SHAPES = [(512, 4, 2), (2560, 20, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [328, 2048])
@pytest.mark.parametrize("norm2", [True, False])
@pytest.mark.parametrize("hd,nh,kvh", K5_SHAPES)
def test_k5_equals_k1_composition_on_card(hd, nh, kvh, norm2, T):
    """K5's qkv and o dots are exact int32 sums in any order, and its
    prologues and epilogues are K1's arithmetic: so its bf16 qkv row is bit
    for bit K1(h, qkv, input_ln), its output bit for bit h + K1(its attention
    row, o, attn_sub) through the port's own K1, and two calls are bitwise
    equal (the streamed dots' int32 merge order does not show), at pos 0, 47
    and T - 1 and the first and last layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(51 + T + hd)
    nq = nh * 128 + 2 * kvh * 128
    qkv_qw = torch.randint(0, 256, (L, hd // 4, nq), generator=g, device=dev, dtype=torch.uint8)
    o_qw = torch.randint(0, 256, (L, nh * 32, hd), generator=g, device=dev, dtype=torch.uint8)
    qs = torch.rand((L, nq), generator=g, device=dev) * 80 + 10
    osc = torch.rand((L,), generator=g, device=dev) * 80 + 10
    ln = (1 + 0.1 * torch.randn((L, hd), generator=g, device=dev)).to(torch.bfloat16)
    sn = (1 + 0.1 * torch.randn((L, nh * 128), generator=g, device=dev)).to(torch.bfloat16)
    sub = sn if norm2 else None
    h = torch.randn((1, hd), generator=g, device=dev).to(torch.bfloat16)
    ck = torch.randn((L, 1, T, kvh, 128), generator=g, device=dev).to(torch.bfloat16)
    cv = torch.randn((L, 1, T, kvh, 128), generator=g, device=dev).to(torch.bfloat16)
    cos = torch.rand(128, generator=g, device=dev).to(torch.bfloat16)
    sin = torch.rand(128, generator=g, device=dev).to(torch.bfloat16)
    kw = dict(q_dim=nh * 128, n_kv=kvh, n_heads=nh, head_dim=128, norm2=norm2)
    for pos in (0, 47, T - 1):
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        for layer in (0, L - 1):
            outs, scr = [], []
            n0 = ternary_cuda.attn_block_megakernel.launches
            for _ in range(2):
                s = {}
                a, _, _ = ternary_cuda.attn_block_megakernel(
                    h, ck.clone(), cv.clone(), qkv_qw, o_qw, layer, p, qs, osc, ln, sub, cos, sin,
                    scratch=s, **kw)
                outs.append(a)
                scr.append(s)
            assert ternary_cuda.attn_block_megakernel.launches - n0 == 2
            want_qkv = ternary_cuda.ternary_matmul_stacked_fused(h, qkv_qw, layer, qs, ln)
            want = h + ternary_cuda.ternary_matmul_stacked_fused(
                scr[0]["attn"], o_qw, layer, osc, sub, norm=norm2)
            torch.cuda.synchronize()
            assert torch.isfinite(outs[0]).all()
            assert torch.equal(scr[0]["qkv"], want_qkv), (pos, layer)
            assert torch.equal(outs[0], want), (pos, layer, (outs[0].float() - want.float())
                                                .abs().max().item())
            assert torch.equal(outs[0], outs[1]) and torch.equal(scr[0]["qkv"], scr[1]["qkv"])
            assert torch.equal(scr[0]["attn"], scr[1]["attn"]), (pos, layer)


@pytest.mark.cuda
def test_fake_moe_oracle_on_card():
    """Two layers at a small width on the card: the dense model through
    paged_forward with the stacked K7 linear, and the fake-MoE model built
    from the same weights (4 identical experts, a zero router, experts
    through K7): logits equal bit for bit (top-2 weights of exactly 0.5,
    and 0.5*o + 0.5*o is exact in f32). chip_smoke.py repeats it at
    BitNet-2B width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.kv import paged
    from wrinklefree_tpu_torch.models import bitnet, moe

    dev = torch.device("cuda")
    cfg = BitNetConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                       num_heads=4, num_kv_heads=2, head_dim=64, max_position=256)
    dense = bitnet.init_params(cfg, seed=0, device=dev)
    mcfg, fake = moe.fake_moe_model(dense, cfg, 4)
    lf = ternary_cuda.make_linear_stacked()
    toks = torch.arange(1, 17, device=dev)[None]
    out = []
    for p, c in ((dense, cfg), (fake, mcfg)):
        pools = paged.PagedKV.zeros_dual(c, 8, 8, 1, device=dev)
        pt = torch.arange(1, 5, dtype=torch.int32, device=dev)[None]
        lo, pools = paged.paged_forward(p, c, toks, pools, pt, torch.tensor([0], device=dev),
                                        torch.tensor([16], device=dev), linear_fn=lf)
        lo2, _ = paged.paged_forward(p, c, lo.argmax(-1)[:, None], pools, pt,
                                     torch.tensor([16], device=dev),
                                     torch.tensor([1], device=dev), linear_fn=lf)
        out.append((lo, lo2))
    torch.cuda.synchronize()
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def _block_weights(dev, seed, hd=512, nh=4, kvh=2, inter=384):
    """Small stacked weights of one decode layer (head dim 128), as K5/K2 take them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nq = nh * 128 + 2 * kvh * 128

    def packed(*shape):
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)

    def scales(n):
        return torch.rand((L, n), generator=g, device=dev) * 80 + 10

    def norm(n):
        return (1 + 0.1 * torch.randn((L, n), generator=g, device=dev)).to(torch.bfloat16)

    return dict(
        qkv_qw=packed(L, hd // 4, nq), o_qw=packed(L, nh * 32, hd),
        gateup_qw=packed(L, hd // 4, 2 * inter), down_qw=packed(L, inter // 4, hd),
        qkv_scale=scales(nq), o_scale=torch.rand((L,), generator=g, device=dev) * 80 + 10,
        gateup_scale=scales(2 * inter), down_scale=scales(hd),
        input_ln=norm(hd), attn_sub=norm(nh * 128), post_ln=norm(hd), ffn_sub=norm(inter),
        heads=dict(q_dim=nh * 128, n_kv=kvh, n_heads=nh, head_dim=128),
        h=torch.randn((12, hd), generator=g, device=dev).to(torch.bfloat16),
        cos=torch.rand(128, generator=g, device=dev).to(torch.bfloat16),
        sin=torch.rand(128, generator=g, device=dev).to(torch.bfloat16),
        cache=torch.randn((2, L, 1, 40, kvh, 128), generator=g, device=dev).to(torch.bfloat16),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k8", "attn_static", "mlp_static", "k9", "k10"])
def test_batch1_variant_kernels_match_plain_on_card(kernel):
    """The whole-layer kernel (K8), the static wrappers over K5/K2, the causal
    flash prefill (K9) and the stream touch (K10) against their plain
    versions on the card, at small sizes (chip_smoke.py holds them at
    BitNet-2B shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    if kernel in ("k8", "attn_static", "mlp_static"):
        w = _block_weights(dev, 8)
        h1, ck, cv = w["h"][:1], w["cache"][0], w["cache"][1]
        T = ck.shape[2]
        for pos in (0, 17, T - 1):
            p = torch.tensor([pos], dtype=torch.int32, device=dev)
            keep = torch.ones(L, T, dtype=torch.bool, device=dev)
            keep[LAYER, pos] = False
            ka, va, kb, vb = ck.clone(), cv.clone(), ck.clone(), cv.clone()
            if kernel == "k8":
                args = [w[n] for n in ("qkv_qw", "o_qw", "gateup_qw", "down_qw")] + [LAYER, p] + [
                    w[n] for n in ("qkv_scale", "o_scale", "gateup_scale", "down_scale",
                                   "input_ln", "attn_sub", "post_ln", "ffn_sub")]
                a, _, _ = ternary_cuda.layer_block_megakernel(h1, ka, va, *args, w["cos"],
                                                              w["sin"], **w["heads"])
                b, _, _ = ternary_cuda.layer_block_megakernel_plain(h1, kb, vb, *args, w["cos"],
                                                                    w["sin"], **w["heads"])
                # K5's and K2's bars: their prologues' reductions run in
                # another order than torch's (an int8 code may move by one)
                assert ((a.float() - b.float()).abs()
                        <= 0.05 * b.float().abs().amax(dim=1, keepdim=True)).all()
                assert torch.equal(ka[:, 0][keep], ck[:, 0][keep])
                assert torch.equal(va[:, 0][keep], cv[:, 0][keep])
                for x, y in ((ka, kb), (va, vb)):
                    r, s = x[LAYER, 0, pos].float(), y[LAYER, 0, pos].float()
                    assert ((r - s).abs() <= 0.03 * s.abs().max()).all()
            elif kernel == "attn_static":
                # the same kernel on the layer's views: bitwise equal to K5
                a, _, _ = ternary_cuda.attn_block_megakernel_static(
                    h1, ka[LAYER], va[LAYER], w["qkv_qw"][LAYER], w["o_qw"][LAYER], p,
                    w["qkv_scale"][LAYER], w["o_scale"][LAYER], w["input_ln"][LAYER],
                    w["attn_sub"][LAYER], w["cos"], w["sin"], **w["heads"])
                b, _, _ = ternary_cuda.attn_block_megakernel(
                    h1, kb, vb, w["qkv_qw"], w["o_qw"], LAYER, p, w["qkv_scale"], w["o_scale"],
                    w["input_ln"], w["attn_sub"], w["cos"], w["sin"], **w["heads"])
                assert torch.equal(a, b) and torch.equal(ka, kb) and torch.equal(va, vb)
            else:
                for rows in (1, 5, 12):
                    x = w["h"][:rows]
                    a = ternary_cuda.mlp_block_megakernel_static(
                        x, w["gateup_qw"][LAYER], w["down_qw"][LAYER], w["gateup_scale"][LAYER],
                        w["down_scale"][LAYER], w["post_ln"][LAYER], w["ffn_sub"][LAYER])
                    b = torch.cat([ternary_cuda.mlp_block_megakernel(
                        x[r:r + 8], w["gateup_qw"], w["down_qw"], LAYER, w["gateup_scale"],
                        w["down_scale"], w["post_ln"], w["ffn_sub"]) for r in range(0, rows, 8)])
                    assert torch.equal(a, b)
                break
    elif kernel == "k9":
        g = torch.Generator(device=dev).manual_seed(9)
        for dt, d, nh, kvh, s, t, off in ((torch.bfloat16, 128, 4, 2, 128, 128, 0),
                                          (torch.float32, 128, 4, 1, 128, 256, 128),
                                          (torch.bfloat16, 64, 2, 2, 64, 192, 64),
                                          (torch.float32, 64, 4, 2, 128, 128, 0)):
            q = torch.randn((1, s, nh, d), generator=g, device=dev).to(dt)
            k = torch.randn((1, t, kvh, d), generator=g, device=dev).to(dt)
            v = torch.randn((1, t, kvh, d), generator=g, device=dev).to(dt)
            a = flash_attention.flash_prefill(q, k, v, off, block_q=64, block_k=64)
            b = flash_attention.flash_prefill_plain(q, k, v, off, block_q=64, block_k=64)
            # f32: FMA sums in another order; bf16: p rounds to bf16 against
            # the same running max (64-key tiles on both sides)
            tol = 2e-5 if dt == torch.float32 else 2e-2
            torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    else:
        from wrinklefree_tpu_torch.bench import calibrate

        g = torch.Generator(device=dev).manual_seed(10)
        gw = torch.randint(-127, 127, (3, 16, 512), generator=g, device=dev, dtype=torch.int8)
        dw = torch.randint(-127, 127, (3, 24, 256), generator=g, device=dev, dtype=torch.int8)
        h = torch.randn((8, 128), generator=g, device=dev)
        ca, cb = (torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(2))
        for layer in (0, 2):
            a = calibrate.touch(h, gw, dw, layer, ca, tn_gu=256, tn_d=128)
            b = calibrate.touch_plain(h, gw, dw, layer, cb, tn_gu=256, tn_d=128)
            assert torch.equal(a, b) and torch.equal(ca, cb)
    torch.cuda.synchronize()


def _k6_mp_for_split(b, kv, ps, split, sms):
    """The largest page-table width (<= 128 pages) at which the wrapper picks
    `split` (from the shape alone), or None."""
    mps = [mp for mp in range(1, 129)
           if flash_attention.flash_decode_split(b, kv, mp * ps, sms) == split]
    return max(mps) if mps else None


# the pool types K4 and K6 take (their bars: flash_attention.POOL_BARS)
POOL_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "f32": torch.float32}


def _assert_pool_bar(a, ref, kernel, pool):
    ok, err, share = flash_attention.meets_pool_bar(a, ref, kernel, pool)
    assert ok, (f"{kernel} on {pool}: max abs error {err}, {share} bitwise equal "
                f"(bar {flash_attention.POOL_BARS[pool][kernel]})")


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("pool", list(POOL_DTYPES))
def test_k6_split_matches_plain_on_card(pool, g, b, split):
    """K6 split over 1, 2, 4 and 8 blocks per slot (the page-table width
    picks the split, as in the engine) against its plain version within
    ``POOL_BARS`` (probabilities round to the pool's type against each warp's
    running max, and the states combine in warp and rank order), on bf16,
    fp16 and f32 pools (the query and current token bf16), at seq_lens 0, 1,
    ps-1, ps, ps+1, 63, 64, 65 and MP*ps-1, G query heads per KV head, B
    slots, the first and the last layer. Two calls give the same bits. With
    the pool pages past each slot's committed span and the staging rows from
    its offset on set to NaN, the output is finite and bitwise equal to the
    run with those rows zero (the kernel never reads them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    kv, ps, n_l = 2, 16, 3
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mp = _k6_mp_for_split(b, kv, ps, split, sms)
    if mp is None:
        pytest.skip(f"no page-table width gives split {split} at B={b} on {sms} SMs")
    gen = torch.Generator(device=dev).manual_seed(60 + 8 * g + b + split)
    lens = [n for n in (0, 1, ps - 1, ps, ps + 1, 63, 64, 65, mp * ps - 1) if n < mp * ps]
    rows = [lens[i % len(lens)] for i in range(max(b, len(lens)))]

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for c in range(0, len(rows), b):
        sl = torch.tensor((rows[c:] + rows)[:b], dtype=torch.int32, device=dev)
        main = rnd(b * mp + 1, 2 * n_l, ps, kv * 128, dtype=POOL_DTYPES[pool])
        stage = rnd(b, ps, 2 * n_l, kv * 128, dtype=POOL_DTYPES[pool])
        q, kc, vc = rnd(b, kv * g, 128), rnd(b, kv, 128), rnd(b, kv, 128)
        pt = (torch.randperm(b * mp, generator=gen, device=dev) + 1).reshape(b, mp).to(torch.int32)
        zero_m, nan_m, zero_s, nan_s = main.clone(), main.clone(), stage.clone(), stage.clone()
        for i, n in enumerate(sl.tolist()):
            past = pt[i, n // ps:].long()
            zero_m[past], nan_m[past] = 0, float("nan")
            zero_s[i, n % ps:], nan_s[i, n % ps:] = 0, float("nan")
        for layer in (0, n_l - 1):
            n0 = flash_attention.flash_paged_decode.launches
            a = flash_attention.flash_paged_decode(q, kc, vc, main, stage, layer, pt, sl)
            again = flash_attention.flash_paged_decode(q, kc, vc, main, stage, layer, pt, sl)
            ref = flash_attention.flash_paged_decode_plain(q, kc, vc, main, stage, layer, pt, sl)
            z = flash_attention.flash_paged_decode(q, kc, vc, zero_m, zero_s, layer, pt, sl)
            p = flash_attention.flash_paged_decode(q, kc, vc, nan_m, nan_s, layer, pt, sl)
            assert flash_attention.flash_paged_decode.launches - n0 == 4
            assert a.dtype == torch.bfloat16
            _assert_pool_bar(a, ref, "k6", pool)
            assert torch.equal(a, again)
            assert torch.isfinite(p).all() and torch.equal(p, z)
            assert torch.equal(a, z)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [8, 12, 32, 64])
@pytest.mark.parametrize("pool", list(POOL_DTYPES))
def test_k6_page_sizes_on_card(pool, ps):
    """K6 at page sizes other than the engine's 16: committed rows row by row
    where a page does not hold whole 16-row boxes (8, 12), by box at an
    offset inside the page (32, 64; bf16 and fp16); against its plain version within
    ``POOL_BARS``, at seq_lens around the page and the 64-token tile, both
    layers, a split above 1, on each pool type; on f32 the kernel over the
    pool rounded to bf16 (what a bf16 read of it gives), and on fp16 over
    its keys rounded to bf16 (what a bf16 product with the query would
    take), fails that bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(70 + ps)
    b, kv, g, n_l = 6, 2, 4, 2
    mp = -(-512 // ps)
    lens = [0, ps - 1, ps + 1, 63, 65, mp * ps - 1]

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    main = rnd(b * mp + 1, 2 * n_l, ps, kv * 128, dtype=POOL_DTYPES[pool])
    stage = rnd(b, ps, 2 * n_l, kv * 128, dtype=POOL_DTYPES[pool])
    q, kc, vc = rnd(b, kv * g, 128), rnd(b, kv, 128), rnd(b, kv, 128)
    pt = (torch.randperm(b * mp, generator=gen, device=dev) + 1).reshape(b, mp).to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert flash_attention.flash_decode_split(b, kv, mp * ps, sms) > 1
    for layer in (0, n_l - 1):
        a = flash_attention.flash_paged_decode(q, kc, vc, main, stage, layer, pt, sl)
        ref = flash_attention.flash_paged_decode_plain(q, kc, vc, main, stage, layer, pt, sl)
        _assert_pool_bar(a, ref, "k6", pool)
        if pool == "f32":  # the bar tells a bf16 read of the pool from an f32 one
            r16 = flash_attention.flash_paged_decode(q, kc, vc, main.bfloat16().float(),
                                                     stage.bfloat16().float(), layer, pt, sl)
            assert not flash_attention.meets_pool_bar(r16, ref, "k6", pool)[0]
        if pool == "fp16":  # and a bf16 read of the keys from an fp16 one
            r16 = flash_attention.flash_paged_decode(
                q, kc, vc, sub.keys_at_bf16(main, n_l), sub.keys_at_bf16(stage, n_l, dim=2),
                layer, pt, sl)
            assert not flash_attention.meets_pool_bar(r16, ref, "k6", pool)[0]
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(POOL_DTYPES))
def test_k6_blocks_per_sm_on_card(pool):
    """The CUDA runtime's count of K6 blocks an SM holds, for the kernel of each
    pool type at its shared memory: ``flash_decode_split``'s
    ``DECODE_BLOCKS_PER_SM`` (2), with the ``DECODE_SMEM_BYTES`` that the
    CPU tests check it against."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    smem, blocks = flash_attention.decode_occupancy(POOL_DTYPES[pool], torch.device("cuda"))
    assert smem == flash_attention.DECODE_SMEM_BYTES[pool]
    assert blocks == flash_attention.DECODE_BLOCKS_PER_SM


def _k4_fails_bar(a, ref, real_rows, pool):
    """Whether K4's output ``a`` fails the bar on some real row."""
    return not all(flash_attention.meets_pool_bar(a[b, :n], ref[b, :n], "k4", pool)[0]
                   for b, n in enumerate(real_rows))


def _k4_check(run, plain, real_rows, poison_runs, pool, control=None):
    """K4 against its plain version within ``POOL_BARS`` on the real query
    rows; two calls bitwise equal; with NaN in every row the kernel may not
    read, the real rows finite and bitwise equal to the run with zeros
    there. On fp16 and f32, returns whether the run ``control`` (fp16: over
    the keys rounded to bf16; f32: over the keys and values rounded to TF32)
    fails the bar on some row."""
    a, again, ref = run(), run(), plain()
    assert a.dtype == ref.dtype
    for b, n in enumerate(real_rows):
        _assert_pool_bar(a[b, :n], ref[b, :n], "k4", pool)
    refused = _k4_fails_bar(control(), ref, real_rows, pool) if pool != "bf16" else None
    assert torch.equal(a, again)
    z, p = (r() for r in poison_runs)
    for b, n in enumerate(real_rows):
        assert torch.isfinite(p[b, :n]).all() and torch.equal(p[b, :n], z[b, :n])
        assert torch.equal(a[b, :n], z[b, :n])
    return refused


def _k4_control(pool, t):
    """What K4's control reads instead of ``t`` (a key or value array): on
    fp16 the keys at bf16 (``t`` unchanged for values, whose caller passes
    them as they are), on f32 each value rounded to TF32 (one pass of the
    tensor cores, without the lo pieces), on bf16 ``t``."""
    if pool == "fp16":
        return t.bfloat16().to(t.dtype)
    if pool == "f32":
        return flash_attention.tf32_round(t)
    return t


def _one_key_each(history, new_lens):
    """Whether every row's real queries see one key only (no history, one
    new token), where any read of the keys gives the same output."""
    return all(h == 0 and n == 1 for h, n in zip(history, new_lens))


# (query heads per KV head, page size, chunk, batch)
K4_POOL_CASES = [(1, 16, 512, 1), (4, 16, 512, 1), (8, 16, 512, 1), (4, 16, 128, 4),
                 (1, 16, 128, 4), (8, 16, 128, 4), (4, 8, 128, 4), (4, 64, 128, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("g,ps,s,b", K4_POOL_CASES,
                         ids=[f"G{g}-ps{ps}-S{s}-B{b}" for g, ps, s, b in K4_POOL_CASES])
@pytest.mark.parametrize("pool", list(POOL_DTYPES))
def test_k4_pool_matches_plain_on_card(pool, g, ps, s, b):
    """K4 reading its history from the pool (``flash_paged_prefill_pool``)
    against its plain version (the gathered history, as the paged forward
    had it) within ``POOL_BARS``, on bf16, fp16 and f32 pools, at seq_lens 0,
    ps, 5 ps and the full table (256 tokens), new_lens 1, 63, 64, 65 and S,
    different per row, the first and the last layer; boxes of 16 rows (ps
    16, 64) and rows one by one (ps 8). Deterministic, and blind to NaN in
    the pool pages from each row's seq_lens on and in the chunk's rows from
    its new_lens on. On fp16 the kernel over the keys rounded to bf16 fails
    the bar, but where each row sees one key only; on f32 the kernel over
    the keys and values rounded to TF32 (no lo pieces) fails it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(80 + g + ps + s + b)
    kv, n_l, mp = 2, 3, 256 // ps
    sls, nls = [0, ps, 5 * ps, mp * ps], [1, 63, 64, 65, s]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(POOL_DTYPES[pool])

    main = rnd(b * mp + 1, 2 * n_l, ps, kv * 128)
    pt = (torch.randperm(b * mp, generator=gen, device=dev) + 1).reshape(b, mp).to(torch.int32)
    fa = flash_attention
    for c in range(5):
        sl = [sls[(c + i) % len(sls)] for i in range(b)]
        nl = [nls[(c + 2 * i) % len(nls)] for i in range(b)]
        q, kc, vc = rnd(b, s, kv * g, 128), rnd(b, s, kv, 128), rnd(b, s, kv, 128)
        slt, nlt = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (sl, nl))
        pools, curs = [], []
        for fill in (0.0, float("nan")):
            m, k2, v2 = main.clone(), kc.clone(), vc.clone()
            for i in range(b):
                m[pt[i, sl[i] // ps:].long()] = fill
                k2[i, nl[i]:], v2[i, nl[i]:] = fill, fill
            pools.append(m)
            curs.append((k2, v2))
        for layer in (0, n_l - 1):
            n0 = fa.flash_paged_prefill.launches
            refused = _k4_check(
                lambda: fa.flash_paged_prefill_pool(q, kc, vc, main, layer, pt, slt, nlt),
                lambda: fa.flash_paged_prefill_pool_plain(q, kc, vc, main, layer, pt, slt, nlt),
                nl,
                [lambda m=m, kv_=kv_: fa.flash_paged_prefill_pool(q, *kv_, m, layer, pt, slt, nlt)
                 for m, kv_ in zip(pools, curs)], pool,
                lambda: fa.flash_paged_prefill_pool(
                    q, _k4_control(pool, kc),
                    _k4_control(pool, vc) if pool == "f32" else vc,
                    sub.keys_at_bf16(main, n_l) if pool == "fp16" else _k4_control(pool, main),
                    layer, pt, slt, nlt))
            assert fa.flash_paged_prefill.launches - n0 == (4 if pool == "bf16" else 5)
            assert pool == "bf16" or refused or (pool == "fp16" and _one_key_each(sl, nl))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("s,b", [(128, 4), (512, 1)])
@pytest.mark.parametrize("pool", list(POOL_DTYPES))
def test_k4_contiguous_matches_plain_on_card(pool, g, s, b):
    """K4 over contiguous keys (``flash_paged_prefill``, the reference's
    signature) against its plain version within ``POOL_BARS``, in bf16, fp16
    and f32, at kv_valid 0, 16, 80 and the whole history (hist_len 256),
    new_len 1, 63, 64, 65 and S; deterministic, and blind to NaN in the
    history columns from kv_valid on and in the chunk's columns from new_len
    on. On fp16 the kernel over the keys rounded to bf16 fails the bar, but
    where each row sees one key only; on f32 the kernel over the keys and
    values rounded to TF32 fails it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(90 + g + s + b)
    kv, T = 2, 256
    kvs, nls = [0, 16, 80, T], [1, 63, 64, 65, s]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(POOL_DTYPES[pool])

    fa = flash_attention
    for c in range(5):
        kvv = [kvs[(c + i) % len(kvs)] for i in range(b)]
        nl = [nls[(c + 2 * i) % len(nls)] for i in range(b)]
        q, kf, vf = rnd(b, s, kv * g, 128), rnd(b, T + s, kv, 128), rnd(b, T + s, kv, 128)
        kvt, nlt = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (kvv, nl))
        fills = []
        for fill in (0.0, float("nan")):
            k2, v2 = kf.clone(), vf.clone()
            for i in range(b):
                k2[i, kvv[i]:T], v2[i, kvv[i]:T] = fill, fill
                k2[i, T + nl[i]:], v2[i, T + nl[i]:] = fill, fill
            fills.append((k2, v2))
        refused = _k4_check(
            lambda: fa.flash_paged_prefill(q, kf, vf, kvt, nlt, hist_len=T),
            lambda: fa.flash_paged_prefill_plain(q, kf, vf, kvt, nlt, hist_len=T),
            nl,
            [lambda f=f: fa.flash_paged_prefill(q, *f, kvt, nlt, hist_len=T) for f in fills],
            pool,
            lambda: fa.flash_paged_prefill(q, _k4_control(pool, kf),
                                           _k4_control(pool, vf) if pool == "f32" else vf,
                                           kvt, nlt, hist_len=T))
        assert pool == "bf16" or refused or (pool == "fp16" and _one_key_each(kvv, nl))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["random", "planted"])
@pytest.mark.parametrize("form", ["pool", "contiguous"])
def test_k4_fp16_subnormal_probabilities_on_card(form, inputs):
    """K4 on fp16 with scores that spread over a row's history by well over
    12 units, so that a large share of its probabilities fall below 2^-14,
    where fp16 holds them only as subnormals, which the tensor cores must
    take as they are: random queries of 6 units a dim, and planted inputs
    (``tests/_subnormal_cases.py``) whose output those probabilities alone
    carry, so that a kernel that flushed them would return zeros. Both
    forms against the plain version within the unchanged ``POOL_BARS`` (fp16
    3e-2) and ``FP16_EQUAL_SHARE`` on the real rows at G 4, the first and
    the last layer; the kernel over the keys rounded to bf16 fails that bar.
    The shares of outputs bitwise equal to the plain twin are printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    kv, g, ps, n_l, b, s = 2, 4, 16, 3, 2, 128
    mp, T = 16, 256
    sl, nl = [T, 80], [s, 65]
    if inputs == "planted":
        q, kc, vc, main, pt = sub.k4_case(dev, 95, b=b, s=s, kv=kv, g=g, ps=ps, mp=mp, n_l=n_l)
    else:
        gen = torch.Generator(device=dev).manual_seed(95)

        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev) * scale).half()

        q, kc, vc = rnd(b, s, kv * g, 128, scale=6.0), rnd(b, s, kv, 128), rnd(b, s, kv, 128)
        main = rnd(b * mp + 1, 2 * n_l, ps, kv * 128)
        pt = (torch.randperm(b * mp, generator=gen, device=dev) + 1).reshape(b, mp)
        pt = pt.to(torch.int32)
    slt, nlt = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (sl, nl))
    fa = flash_attention
    k0 = main[pt[0].long(), 0].reshape(T, kv, 128)[:, 0]
    if form == "pool":
        r_main, r_kc = sub.keys_at_bf16(main, n_l), kc.bfloat16().half()
        runs = [(lambda layer=layer: fa.flash_paged_prefill_pool(
                     q, kc, vc, main, layer, pt, slt, nlt),
                 lambda layer=layer: fa.flash_paged_prefill_pool(
                     q, r_kc, vc, r_main, layer, pt, slt, nlt),
                 lambda layer=layer: fa.flash_paged_prefill_pool_plain(
                     q, kc, vc, main, layer, pt, slt, nlt)) for layer in (0, n_l - 1)]
    else:  # each row's history of layer 0 in page-table order, then its chunk
        kf = torch.cat([main[pt.long(), 0].reshape(b, T, kv, 128), kc], dim=1)
        vf = torch.cat([main[pt.long(), n_l].reshape(b, T, kv, 128), vc], dim=1)
        runs = [(lambda: fa.flash_paged_prefill(q, kf, vf, slt, nlt, hist_len=T),
                 lambda: fa.flash_paged_prefill(q, kf.bfloat16().half(), vf, slt, nlt,
                                                hist_len=T),
                 lambda: fa.flash_paged_prefill_plain(q, kf, vf, slt, nlt, hist_len=T))]
    qs = q[0, :, :g].reshape(-1, 128) * torch.tensor(128 ** -0.5, dtype=torch.float16,
                                                         device=dev)
    share_sub, spread = sub.subnormal_share(qs, k0, T)
    assert share_sub > 0.2 and spread > 12, (share_sub, spread)
    shares, controls = [], []
    for run, keys_bf16, plain in runs:
        a, ref = run(), plain()
        for i, n in enumerate(nl):
            _assert_pool_bar(a[i, :n], ref[i, :n], "k4", "fp16")
            shares.append(float((a[i, :n] == ref[i, :n]).float().mean()))
        r16 = keys_bf16()
        assert _k4_fails_bar(r16, ref, nl, "fp16")
        controls.append(max(float((r16[i, :n] == ref[i, :n]).float().mean())
                            for i, n in enumerate(nl)))
    torch.cuda.synchronize()
    print(f"k4 fp16 {form} {inputs}: {share_sub:.3f} of the probabilities subnormal in fp16; "
          f"bitwise equal share {min(shares):.4f}-{max(shares):.4f}, "
          f"keys at bf16 {max(controls):.4f}")


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["random", "planted"])
def test_k6_fp16_subnormal_probabilities_on_card(inputs):
    """K6 on an fp16 pool with scores that spread over a slot's history by
    well over 12 units, so that a large share of its probabilities fall
    below 2^-14 (fp16 subnormals) before PV: bf16 queries of 4 units a dim,
    and planted inputs (``tests/_subnormal_cases.py``) whose output those
    probabilities alone carry. Against the plain version within the
    unchanged ``POOL_BARS`` (fp16 3e-2) and ``FP16_EQUAL_SHARE`` at
    histories of 17-1000 tokens, split above 1, the first and the last
    layer; the kernel over the keys rounded to bf16 fails that bar. The
    shares of outputs bitwise equal to the plain twin are printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    b, kv, g, ps, n_l, mp = 4, 2, 4, 16, 3, 64
    lens = [17, 300, 640, 1000]
    if inputs == "planted":
        q, kc, vc, main, stage, pt = sub.k6_case(dev, 96, b=b, kv=kv, g=g, ps=ps, mp=mp,
                                                 n_l=n_l)
    else:
        gen = torch.Generator(device=dev).manual_seed(96)

        def rnd(*shape, dtype=torch.float16, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

        main = rnd(b * mp + 1, 2 * n_l, ps, kv * 128)
        stage = rnd(b, ps, 2 * n_l, kv * 128)
        q = rnd(b, kv * g, 128, dtype=torch.bfloat16, scale=4.0)
        kc, vc = rnd(b, kv, 128, dtype=torch.bfloat16), rnd(b, kv, 128, dtype=torch.bfloat16)
        pt = (torch.randperm(b * mp, generator=gen, device=dev) + 1).reshape(b, mp)
        pt = pt.to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert flash_attention.flash_decode_split(b, kv, mp * ps, sms) > 1
    full = lens[-1] // ps * ps
    k0 = main[pt[-1, :full // ps].long(), 0].reshape(full, kv, 128)[:, 0]
    qs = q[-1, :g] * torch.tensor(128 ** -0.5, dtype=torch.bfloat16, device=dev)
    share_sub, spread = sub.subnormal_share(qs, k0, full)
    assert share_sub > 0.2 and spread > 12, (share_sub, spread)
    rounded = sub.keys_at_bf16(main, n_l), sub.keys_at_bf16(stage, n_l, dim=2)
    shares, controls = [], []
    for layer in (0, n_l - 1):
        a = flash_attention.flash_paged_decode(q, kc, vc, main, stage, layer, pt, sl)
        ref = flash_attention.flash_paged_decode_plain(q, kc, vc, main, stage, layer, pt, sl)
        _assert_pool_bar(a, ref, "k6", "fp16")
        shares.append(float((a == ref).float().mean()))
        r16 = flash_attention.flash_paged_decode(q, kc, vc, *rounded, layer, pt, sl)
        ok16, _, share16 = flash_attention.meets_pool_bar(r16, ref, "k6", "fp16")
        assert not ok16
        controls.append(share16)
    torch.cuda.synchronize()
    print(f"k6 fp16 {inputs}: {share_sub:.3f} of the probabilities subnormal in fp16; "
          f"bitwise equal share {min(shares):.4f}-{max(shares):.4f}, "
          f"keys at bf16 {max(controls):.4f}")


# (query heads per KV head, batch, query tokens, keys, q_offset, offset on the device)
K9_CASES = [(1, 1, 128, 128, 0, False), (4, 2, 128, 256, 128, False),
            (8, 1, 64, 192, 100, False), (4, 2, 40, 40, 0, False), (2, 2, 24, 64, 40, True),
            (3, 1, 96, 128, 32, False), (16, 1, 64, 128, 64, True), (4, 1, 128, 128, 100, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_k4_f32_long_history_on_card(scale):
    """K4 on an f32 pool over one row's 8192-token history and a 64-token
    chunk, 2B's heads (20 query / 5 KV), q and keys of ``scale`` units a
    dim: within ``POOL_BARS["f32"]`` (2e-5) of the plain version. The
    output's tensor-core sums must not run over the whole history: one that
    did drifted to 9.4e-5 here at 2 units."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(41 * scale))
    kv, g, ps, n_l, hist, s = 5, 4, 16, 1, 8192, 64
    mp = hist // ps + 1
    q = torch.randn((1, s, kv * g, 128), generator=gen, device=dev) * scale
    kc = torch.randn((1, s, kv, 128), generator=gen, device=dev) * scale
    vc = torch.randn((1, s, kv, 128), generator=gen, device=dev)
    main = torch.randn((mp + 1, 2 * n_l, ps, kv * 128), generator=gen, device=dev)
    main[:, :n_l] *= scale
    pt = (torch.randperm(mp, generator=gen, device=dev) + 1).reshape(1, mp).int()
    sl, nl = (torch.tensor([x], dtype=torch.int32, device=dev) for x in (hist, s))
    a = flash_attention.flash_paged_prefill_pool(q, kc, vc, main, 0, pt, sl, nl)
    ref = flash_attention.flash_paged_prefill_pool_plain(q, kc, vc, main, 0, pt, sl, nl)
    torch.cuda.synchronize()
    _assert_pool_bar(a[0], ref[0], "k4", "f32")


TINY = 2.0 ** -120  # keys and values of this size: their TF32 lo pieces are subnormal


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["k4-pool", "k4-contiguous", "k6"])
def test_f32_tiny_values_on_card(form):
    """K4 (both forms) and K6 on f32 pools whose keys and values lie below
    2^-115 (random values times 2^-120), so that the lo pieces of their TF32
    splits fall below 2^-126, TF32's least normal: against the plain version
    within the unchanged ``POOL_BARS`` (K6 with ``K6_F32_EQUAL_SHARE`` of the
    output bitwise equal) at G 4, the first and the last layer. K4's output
    scaled back by 2^120 is held to the same bar against the plain version's,
    so that the subnormal pieces count; both errors are printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(97)
    kv, g, ps, n_l = 2, 4, 16, 3
    fa = flash_attention

    def rnd(*shape, scale=TINY, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    errs = []
    if form == "k6":
        b, mp = 4, 64
        sl = torch.tensor([17, 300, 640, 1000], dtype=torch.int32, device=dev)
        main, stage = rnd(b * mp + 1, 2 * n_l, ps, kv * 128), rnd(b, ps, 2 * n_l, kv * 128)
        q = rnd(b, kv * g, 128, scale=1.0, dtype=torch.bfloat16)
        kc, vc = (rnd(b, kv, 128, dtype=torch.bfloat16) for _ in range(2))
        pt = (torch.randperm(b * mp, generator=gen, device=dev) + 1).reshape(b, mp).int()
        for layer in (0, n_l - 1):
            a = fa.flash_paged_decode(q, kc, vc, main, stage, layer, pt, sl)
            ref = fa.flash_paged_decode_plain(q, kc, vc, main, stage, layer, pt, sl)
            assert a.abs().max() > 0
            _assert_pool_bar(a, ref, "k6", "f32")
            errs.append(fa.meets_pool_bar(a, ref, "k6", "f32")[2])
    else:
        b, s, mp = 2, 128, 16
        sl, nl = [256, 80], [128, 65]
        slt, nlt = (torch.tensor(x, dtype=torch.int32, device=dev) for x in (sl, nl))
        q = rnd(b, s, kv * g, 128, scale=1.0)
        kc, vc, main = rnd(b, s, kv, 128), rnd(b, s, kv, 128), rnd(b * mp + 1, 2 * n_l, ps,
                                                                    kv * 128)
        pt = (torch.randperm(b * mp, generator=gen, device=dev) + 1).reshape(b, mp).int()
        if form == "k4-pool":
            runs = [(lambda layer=layer: fa.flash_paged_prefill_pool(
                         q, kc, vc, main, layer, pt, slt, nlt),
                     lambda layer=layer: fa.flash_paged_prefill_pool_plain(
                         q, kc, vc, main, layer, pt, slt, nlt)) for layer in (0, n_l - 1)]
        else:
            kf = torch.cat([main[pt.long(), 0].reshape(b, 256, kv, 128), kc], dim=1)
            vf = torch.cat([main[pt.long(), n_l].reshape(b, 256, kv, 128), vc], dim=1)
            runs = [(lambda: fa.flash_paged_prefill(q, kf, vf, slt, nlt, hist_len=256),
                     lambda: fa.flash_paged_prefill_plain(q, kf, vf, slt, nlt, hist_len=256))]
        for run, plain in runs:
            a, ref = run(), plain()
            for i, n in enumerate(nl):
                assert a[i, :n].abs().max() > 0
                _assert_pool_bar(a[i, :n], ref[i, :n], "k4", "f32")
                _assert_pool_bar(a[i, :n] / TINY, ref[i, :n] / TINY, "k4", "f32")
                errs.append(float((a[i, :n] / TINY - ref[i, :n] / TINY).abs().max()))
    torch.cuda.synchronize()
    print(f"f32 {form} at 2^-120: " + (f"bitwise equal share {min(errs):.4f}" if form == "k6"
                                       else f"max error scaled back {max(errs):.3g}"))


@pytest.mark.cuda
@pytest.mark.parametrize("g,b,s,t,off,on_device", K9_CASES,
                         ids=[f"G{g}-B{b}-S{s}-T{t}-off{o}{'-dev' if d else ''}"
                              for g, b, s, t, o, d in K9_CASES])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k9_matches_plain_on_card(dtype, d, g, b, s, t, off, on_device):
    """K9, the causal flash prefill, against its plain version with 64-key
    blocks (the kernel's tiles, so p rounds against the same running max) at
    G 1-16 (G 16 in two blocks of 8 heads in bf16, four of 4 in f32), B 1-2,
    S below 64 and not a multiple of 16, q_offset 0, 128, a multiple of 64,
    one that is not, one past T - S, and offsets read from the device. The
    largest absolute error: f32 within 2e-5 (sums in another order), bf16
    within 2e-2 (a bf16 ulp of p or of the output); finite, and two calls
    bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(130 + g + s + t + off + d)
    kv = 2 if g < 8 else 1
    q = torch.randn((b, s, kv * g, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, kv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, kv, d), generator=gen, device=dev).to(dtype)
    qoff = torch.tensor([off], device=dev) if on_device else off
    n0 = flash_attention.flash_prefill.launches
    a = flash_attention.flash_prefill(q, k, v, qoff, block_q=s, block_k=64)
    again = flash_attention.flash_prefill(q, k, v, qoff, block_q=s, block_k=64)
    assert flash_attention.flash_prefill.launches - n0 == 2
    ref = flash_attention.flash_prefill_plain(q, k, v, off, block_q=s, block_k=64)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert torch.isfinite(a).all()
    assert (a.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(a, again)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the captured batch-1 decode window (bench.decode.DecodeGraph)
# ---------------------------------------------------------------------------

WINDOW_MODES = ["default", "split", "layer_mega"]


@pytest.fixture(scope="module")
def window_2b():
    """Two layers of BitNet-2B width with the int8 head and fused projections
    (bench.decode's params, cut to two layers), a 16-token prompt's cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the window's kernels have no CPU mode)")
    import dataclasses

    from wrinklefree_tpu_torch.bench import decode as bd
    from wrinklefree_tpu_torch.config import BitNetConfig

    cfg = dataclasses.replace(BitNetConfig.bitnet_2b(), num_layers=2)
    dev = torch.device("cuda")
    params = bd.bench_params(cfg, dev)
    g = torch.Generator(device="cpu").manual_seed(11)
    prompt = torch.randint(1, cfg.vocab_size, (1, 16), generator=g).to(dev)
    return cfg, params, prompt


def _window_start(window_2b, mode, steps):
    """(params, linear_fn, first token, cache, position) of a mode after the prompt."""
    from wrinklefree_tpu_torch.bench import decode as bd
    from wrinklefree_tpu_torch.models.bitnet import split_layers_for_decode

    cfg, params, prompt = window_2b
    if mode == "split":
        params = split_layers_for_decode(params, cfg)
    lf = ternary_cuda.make_linear_fused(layer_mega=mode == "layer_mega")
    tok, cache = bd.prefill(params, cfg, lf, prompt, prompt.shape[1] + 2 * steps + 8)
    pos = torch.full((1,), prompt.shape[1], dtype=torch.int32, device=prompt.device)
    return params, lf, tok, cache, pos


def _copy(cache):
    from wrinklefree_tpu_torch.models.bitnet import KVCache

    return KVCache(cache.k.clone(), cache.v.clone())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", WINDOW_MODES)
def test_captured_window_equals_eager_on_card(window_2b, mode):
    """Per mode, at 2 layers of 2B width: the captured 16-step window's tokens
    and final cache equal the eager window's from the same state, bit for
    bit; the capture records each of the mode's kernels once per layer and
    step; two replays from one state are bitwise equal; a window that was
    not captured does not run on the card."""
    from wrinklefree_tpu_torch.bench import decode as bd

    cfg, _, _ = window_2b
    steps = 16
    params, lf, tok, cache, pos = _window_start(window_2b, mode, steps)
    start = _copy(cache)
    want, _, wcache, _ = bd.decode_window(params, cfg, lf, tok, _copy(start), pos, steps,
                                          bd.exact_head(cfg))
    graph = bd.DecodeGraph(params, cfg, lf, cache, steps)
    with pytest.raises(RuntimeError, match="capture"):
        graph.run(tok, pos)  # no uncaptured window on the card
    counters = {"default": [ternary_cuda.attn_block_megakernel,
                            ternary_cuda.mlp_block_megakernel],
                "split": [ternary_cuda.attn_block_megakernel_static,
                          ternary_cuda.mlp_block_megakernel_static],
                "layer_mega": [ternary_cuda.layer_block_megakernel]}[mode]
    graph.warm_up(tok, pos)
    before = [c.launches for c in counters]
    graph.capture(tok, pos)
    assert [c.launches - b for c, b in zip(counters, before)] == [cfg.num_layers * steps] * len(
        counters)
    got, last, gcache, nxt, repaired = graph.run(tok, pos)
    torch.cuda.synchronize()
    assert gcache is cache and int(nxt) == int(pos) + steps
    assert torch.equal(got, want), (got, want)
    assert torch.equal(cache.k, wcache.k) and torch.equal(cache.v, wcache.v)
    first_cache = _copy(cache)
    cache.k.copy_(start.k)
    cache.v.copy_(start.v)
    again, *_ = graph.run(tok, pos)
    torch.cuda.synchronize()
    assert torch.equal(again, got)
    assert torch.equal(cache.k, first_cache.k) and torch.equal(cache.v, first_cache.v)


@pytest.mark.cuda
def test_captured_window_repair_on_card(window_2b):
    """A window captured with a one-candidate shortlist (k = 1), whose
    certificate fails: the repair gives the eager window's tokens and cache
    (the eager window through the bench's k = 64 head)."""
    from wrinklefree_tpu_torch.bench import decode as bd

    cfg, _, _ = window_2b
    steps = 16
    params, lf, tok, cache, pos = _window_start(window_2b, "default", steps)
    start = _copy(cache)
    want, _, wcache, _ = bd.decode_window(params, cfg, lf, tok, _copy(start), pos, steps,
                                          bd.exact_head(cfg))
    graph = bd.DecodeGraph(params, cfg, lf, cache, steps, k=1).capture(tok, pos)
    got, _, _, _, repaired = graph.run(tok, pos)
    torch.cuda.synchronize()
    assert repaired > 0
    assert torch.equal(got, want)
    assert torch.equal(cache.k, wcache.k) and torch.equal(cache.v, wcache.v)


@pytest.mark.cuda
def test_host_read_fails_capture_on_card(window_2b):
    """A step that reads the device on the host (the eager exact head's
    certificate read) cannot be captured: the capture raises."""
    from wrinklefree_tpu_torch.bench import decode as bd
    from wrinklefree_tpu_torch.models.bitnet import forward

    class HostRead(bd.DecodeGraph):
        def _step(self, tok, i):
            tok, _ = forward(self.params, self.cfg, tok, self.cache, self.pos + i,
                             linear_fn=self.lf, logits_all=False,
                             head_fn=bd.exact_head(self.cfg, self.k))
            return tok

    cfg, _, _ = window_2b
    params, lf, tok, cache, pos = _window_start(window_2b, "default", 2)
    with pytest.raises(RuntimeError):
        HostRead(params, cfg, lf, cache, 2).capture(tok, pos)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The port's HTTP server on the card (two layers of BitNet-2B width)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def server_2b():
    """The port's server around an Engine at two layers of 2B width, served
    on a free port in a thread; a second Engine on the same weights is the
    oracle (Engine.generate). Yields (url, the served engine's requests,
    oracle)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the serving kernels have no CPU mode)")
    import dataclasses

    from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
    from wrinklefree_tpu_torch.engine import Engine
    from wrinklefree_tpu_torch.models.bitnet import fuse_projections, init_params
    from wrinklefree_tpu_torch.server._web import ServerThread
    from wrinklefree_tpu_torch.server.http import ByteTokenizer, InferenceServer, build_app

    cfg = dataclasses.replace(BitNetConfig.bitnet_2b(), num_layers=2)
    dev = torch.device("cuda")
    params = fuse_projections(init_params(cfg, seed=0, device=dev), cfg)
    ecfg = EngineConfig(max_batch_slots=8, page_size=16, num_pages=256, max_context=512,
                        prefill_buckets=(32, 128))
    eng = Engine(params, cfg, ecfg, eos_token_id=0, device=dev)
    reqs = []
    submit = eng.submit

    def record(*a, **kw):
        reqs.append(submit(*a, **kw))
        return reqs[-1]

    eng.submit = record
    server = InferenceServer(eng, ByteTokenizer(), "synth:2-layer-2b")
    st = ServerThread(build_app(server))
    yield st.url, reqs, Engine(params, cfg, ecfg, eos_token_id=0, device=dev)
    st.stop()
    server.async_engine.shutdown()


def _reset(url, oracle):
    import urllib.request

    urllib.request.urlopen(urllib.request.Request(f"{url}/admin/reset-cache", data=b"",
                                                  method="POST"), timeout=30).read()
    oracle.reset_prefix_cache()


@pytest.mark.cuda
def test_server_greedy_equals_engine_on_card(server_2b):
    """A greedy completion served over HTTP gives Engine.generate's tokens."""
    from wrinklefree_tpu_torch.client import InferenceClient

    url, reqs, oracle = server_2b
    c = InferenceClient(url)
    prompt = "The serving front end of a ternary model, driven on the card. " * 3
    _reset(url, oracle)
    n0 = len(reqs)
    text = c.chat([{"role": "user", "content": prompt}], max_tokens=24, temperature=0.0,
                  ignore_eos=True)
    (req,) = reqs[n0:]
    assert len(req.output_ids) == 24 and req.finish_reason == "length"
    assert oracle.generate(req.prompt_ids, req.sampling).output_ids == req.output_ids
    assert text == "".join(chr((t - 1) % 250) for t in req.output_ids)


@pytest.mark.cuda
def test_server_stream_equals_engine_on_card(server_2b):
    """The same request streamed (SSE): the text of Engine.generate's
    tokens, equal to the non-streamed answer."""
    from wrinklefree_tpu_torch.client import InferenceClient
    from wrinklefree_tpu_torch.server.http import ByteTokenizer

    url, reqs, oracle = server_2b
    c = InferenceClient(url)
    prompt = "Stream these tokens one event at a time. " * 4
    _reset(url, oracle)
    streamed = "".join(c.generate_stream(prompt, max_tokens=20, temperature=0.0))
    req = reqs[-1]
    want = oracle.generate(req.prompt_ids, req.sampling).output_ids
    assert req.output_ids == want
    assert streamed == ByteTokenizer().decode(want)
    _reset(url, oracle)
    assert c.generate(prompt, max_tokens=20, temperature=0.0) == streamed


# -- loading weights onto the card -------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["directory", "packed_cache", "gguf"])
def test_loaded_weights_on_card(tmp_path, fmt):
    """A tiny model written as an HF directory (chip_smoke.write_hf_dir, the
    port's safetensors writer), as its packed cache and as its i2_s GGUF
    loads onto the card bit-equal to the same file loaded on the CPU, and
    (directory, packed cache) to the params it was written from."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the loaders' default device)")
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import tensor_diffs, write_hf_dir
    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.convert.convert import convert_and_save
    from wrinklefree_tpu_torch.convert.gguf import convert_hf_to_gguf, load_params_gguf
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.models.loader import load_params

    cfg = BitNetConfig.tiny()
    params = init_params(cfg, seed=3, device="cuda")
    path = write_hf_dir(params, cfg, tmp_path / "hf")
    load = load_params
    if fmt == "packed_cache":
        path = convert_and_save(path, tmp_path / "packed")
    elif fmt == "gguf":
        path, load = convert_hf_to_gguf(path, tmp_path / "m.gguf"), load_params_gguf
    on_card, card_cfg = load(path)
    on_cpu, cpu_cfg = load(path, device="cpu")
    assert card_cfg == cpu_cfg
    assert all(t.is_cuda for t in [*on_card["layers"].values(), on_card["embed"]])

    def cuda(p):
        return {k: cuda(v) if isinstance(v, dict) else v.cuda() for k, v in p.items()}

    assert tensor_diffs(on_card, cuda(on_cpu)) == []
    if fmt != "gguf":
        assert tensor_diffs(on_card, params) == []


@pytest.mark.cuda
def test_keyed_draws_on_card():
    """The counter-keyed draws on the card: keys and words bit-equal to the
    CPU's, Gumbel floats within 1e-6 relative, and the sampler's tokens on
    the same logits and keys equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wrinklefree_tpu_torch.ops import sampling

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(18)
    seeds = torch.randint(0, 2**32, (64,), generator=g, dtype=torch.int64)
    ctrs = torch.randint(0, 2**20, (64,), generator=g, dtype=torch.int64)
    keys = sampling.per_request_keys(seeds, ctrs)
    keys_dev = sampling.per_request_keys(seeds.to(dev), ctrs.to(dev))
    assert torch.equal(keys_dev.cpu(), keys)
    assert torch.equal(sampling.random_bits(keys_dev, 300).cpu(), sampling.random_bits(keys, 300))
    a, b = sampling.gumbel(keys, 300), sampling.gumbel(keys_dev, 300).cpu()
    assert ((a - b).abs() <= 1e-6 * a.abs().clamp_min(1.0)).all()
    logits = torch.randn((64, 5000), generator=g) * 3
    kw = dict(temperature=[0.8] * 32 + [0.0] * 32, top_k=[0, 40] * 32)
    assert torch.equal(sampling.sample_token(logits.to(dev), sampling.gumbel(keys_dev, 256),
                                             **kw).cpu(),
                       sampling.sample_token(logits, sampling.gumbel(keys, 256), **kw))


@pytest.mark.cuda
def test_request_features_on_card():
    """The tiny engine on the card: a logprobs request's top-1 id is its
    token at every step and its tokens those of the plain request; a seeded
    mirostat request draws the same tokens alone and beside others; a GBNF
    request ends in one of its two words; a snapshot restored on two fresh
    engines continues every request with the same tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.models.bitnet import init_params

    cfg = BitNetConfig.tiny()
    params = init_params(cfg, seed=0, device="cuda")
    pieces = [chr(i) if 32 <= i < 127 else "" for i in range(cfg.vocab_size)]

    def engine():
        e = Engine(params, cfg, EngineConfig(max_batch_slots=4, page_size=8, num_pages=64,
                                             max_context=64, prefill_buckets=(8, 16, 32),
                                             decode_burst=4), device="cuda")
        e.token_pieces = pieces
        return e

    def run(e, jobs):
        reqs = [e.submit(p, sp) for p, sp in jobs]
        while not all(r.finished for r in reqs):
            e.step()
        return reqs

    eng = engine()
    (lp,) = run(eng, [([1, 5, 9, 2], SamplingParams(max_new_tokens=12, logprobs_k=3))])
    eng.reset_prefix_cache()
    (plain,) = run(eng, [([1, 5, 9, 2], SamplingParams(max_new_tokens=12))])
    assert lp.output_ids == plain.output_ids
    assert all(tops[0][0] == t and c == tops[0][1] <= 0
               for t, (c, tops) in zip(lp.output_ids, lp.logprobs_seq))
    miro = SamplingParams(max_new_tokens=12, temperature=1.5, seed=3, mirostat=2)
    (alone,) = run(engine(), [([4, 4, 2], miro)])
    beside = run(engine(), [([7, 8], SamplingParams(max_new_tokens=9, temperature=1.0, seed=1)),
                            ([4, 4, 2], miro)])[1]
    assert alone.output_ids == beside.output_ids
    (yn,) = run(eng, [([3, 3], SamplingParams(max_new_tokens=6,
                                              grammar='root ::= "yes" | "no"'))])
    assert "".join(pieces[t] for t in yn.output_ids) in ("yes", "no")
    e1 = engine()
    reqs = [e1.submit([1 + i, 2, 3], SamplingParams(max_new_tokens=20, temperature=0.9, seed=i))
            for i in range(3)]
    while min(len(r.output_ids) for r in reqs) < 5:
        e1.step()
    snap = e1.snapshot()
    outs = []
    for e in (engine(), engine()):
        restored = e.restore(snap)
        while not all(r.finished for r in restored):
            e.step()
        outs.append([r.output_ids for r in restored])
    assert outs[0] == outs[1]
    assert [len(o) for o in outs[0]] == [20 - len(d["output_ids"]) for d in snap["requests"]]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 40])
def test_k3_token_major_pool_on_card(rows):
    """K3 on the token-major pool [P, ps, 2L, KV*D]: one row per token at
    (page_ids, offsets), bit-equal to its plain version; padding rows on the
    trash page; ``paged_kv_update``'s per-layer writes too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    pool = torch.randn(24, 16, 60, 640, generator=g, device=dev).to(torch.bfloat16)
    vals = torch.randn(rows, 60, 640, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.randperm(23 * 16, generator=g, device=dev)[:rows] + 16
    ids, offs = (pos // 16).to(torch.int32), (pos % 16).to(torch.int32)
    ids[rows // 2:][: rows // 4] = 0  # padding: the trash page
    plain = kv_update_cuda.kv_write_plain(pool.clone(), vals, ids, offs)
    n = kv_update_cuda.kv_write.launches
    got = kv_update_cuda.kv_write(pool, vals, ids, offs)
    assert kv_update_cuda.kv_write.launches == n + 1
    assert torch.equal(got[1:], plain[1:])
    layered = torch.randn(3, 6, 8, 2, 128, generator=g, device=dev).to(torch.bfloat16)
    lv = torch.randn(3, 2, 5, 2, 128, generator=g, device=dev).to(torch.bfloat16)
    pid = torch.tensor([[1, 1, 2, 3, 5], [4, 4, 4, 2, 0]], device=dev)
    off = torch.tensor([[0, 7, 3, 1, 2], [5, 6, 7, 0, 0]], device=dev)
    want = layered.clone()
    for l in range(3):
        want[l, pid, off] = lv[l]
    kv_update_cuda.paged_kv_update(layered, lv, pid, off, layer_stride=6)
    assert torch.equal(layered, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_kv_quantize_on_card_equals_cpu(kv_dtype):
    """``quantize_kv`` on the card stores the CPU's bytes and scales (the
    f32 -> fp8 casts included, every vector's absmax on the format's
    maximum) and ``dequantize_kv`` gives the CPU's bf16 values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wrinklefree_tpu_torch.kv import quantized

    g = torch.Generator().manual_seed(19)
    x = (torch.randn(256, 5, 128, generator=g)
         * torch.exp(torch.rand(256, 5, 1, generator=g) * 14 - 7)).to(torch.bfloat16)
    x[0, 0] = 0
    q, s = quantized.quantize_kv(x, kv_dtype)
    qd, sd = quantized.quantize_kv(x.cuda(), kv_dtype)
    assert torch.equal(qd.cpu().view(torch.uint8), q.view(torch.uint8))
    assert torch.equal(sd.cpu(), s)
    assert torch.equal(quantized.dequantize_kv(qd, sd).cpu(), quantized.dequantize_kv(q, s))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["fp16", "f32"])
def test_engine_serves_fp16_f32_pools_on_card(kv_dtype):
    """The engine on fp16 and f32 pools at 2 layers of 2B width with
    ``flash_decode``: two greedy requests (a 200-token prompt prefills through
    K4 over the pool) finish by length, launching K3, K4 and K6 (chip_smoke's
    heads_kv phase holds the streams at 30 layers against the bf16 runs'
    under the near-tie rule: K6 returns the bf16 query's type, and a one-step
    bf16 rounding of its output can move the next layer's int8 codes, so
    not even the f32 pool's tokens need equal another attention's). The
    wrappers raise for a type outside bf16, fp16 and f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.models.bitnet import init_params

    dev = torch.device("cuda")
    cfg = dataclasses.replace(BitNetConfig.bitnet_2b(), num_layers=2)
    params = init_params(cfg, seed=0, device=dev)
    ecfg = EngineConfig(max_batch_slots=4, page_size=16, num_pages=128, max_context=512,
                        prefill_buckets=(32, 128, 256), kv_dtype=kv_dtype, flash_decode=True)
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist() for n in (200, 40)]
    counters = (kv_update_cuda.kv_write, flash_attention.flash_paged_prefill,
                flash_attention.flash_paged_decode)
    for c in counters:
        c.launches = 0
    eng = Engine(params, cfg, ecfg, device=dev)
    assert eng.pools.kv_dtype_name == kv_dtype and eng.kv_layout == "layer"
    reqs = [eng.submit(p, SamplingParams(max_new_tokens=12, temperature=0.0)) for p in prompts]
    while not all(r.finished for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    assert all(r.finish_reason == "length" and len(r.output_ids) == 12 for r in reqs)
    assert all(c.launches for c in counters), [c.launches for c in counters]
    for dt in (torch.float64, torch.int8):
        q = torch.zeros(1, 128, 4, 128, dtype=dt, device=dev)
        kv = torch.zeros(1, 256, 2, 128, dtype=dt, device=dev)
        with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
            flash_attention.flash_paged_prefill(q, kv, kv, 128, 128, hist_len=128)
        pool = torch.zeros(3, 4, 16, 256, dtype=dt, device=dev)
        with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
            flash_attention.flash_paged_decode(
                torch.zeros(1, 8, 128, dtype=torch.bfloat16, device=dev),
                torch.zeros(1, 2, 128, dtype=torch.bfloat16, device=dev),
                torch.zeros(1, 2, 128, dtype=torch.bfloat16, device=dev), pool,
                torch.zeros(1, 16, 4, 256, dtype=dt, device=dev), 0,
                torch.ones(1, 2, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))


@pytest.mark.cuda
def test_spec_engine_equals_plain_on_card():
    """The speculative engine (k 4, bursts of 8) at 2 layers of 2B width on
    the card, with the o and down projections set to ternary zeros (the
    logits then depend on the current token alone, so no rounding of the
    k+1-row verify against the one-row step can part the streams): its
    greedy streams equal the plain engine's token for token, it accepts
    drafts, and its verify runs K1's GEMM (8 slots x 5 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.models.bitnet import init_params

    cfg = dataclasses.replace(BitNetConfig.bitnet_2b(), num_layers=2)
    params = init_params(cfg, seed=0, device="cuda")
    layers = dict(params["layers"])
    for name in ("o_qw", "down_qw"):
        layers[name] = torch.full_like(layers[name], 0x55)
    params = {**params, "layers": layers}
    g = torch.Generator().manual_seed(0)
    pattern = torch.randint(1, cfg.vocab_size, (16,), generator=g).tolist()
    prompts = [pattern * 4, (pattern * 3)[:45], torch.randint(1, cfg.vocab_size, (30,),
                                                               generator=g).tolist(),
               [5, 6, 7], pattern[:14] * 2, list(range(100, 161)), pattern * 2 + [9], [42] * 20]
    outs, stats = [], []
    for k in (0, 4):
        eng = Engine(params, cfg, EngineConfig(max_batch_slots=8, page_size=16, num_pages=256,
                                               max_context=512, prefill_buckets=(32, 128),
                                               decode_burst=8, speculative_k=k,
                                               spec_min_accept=0.0), device="cuda")
        tiled = ternary_cuda.ternary_matmul_stacked_fused.tiled_launches
        reqs = [eng.submit(p, SamplingParams(max_new_tokens=40)) for p in prompts]
        prefilled = False
        while not all(r.finished for r in reqs):
            eng.step()
            if not prefilled and all(r.slot >= 0 and not r.pending for r in reqs):
                prefilled, tiled = True, ternary_cuda.ternary_matmul_stacked_fused.tiled_launches
        outs.append([r.output_ids for r in reqs])
        stats.append((eng.stats, ternary_cuda.ternary_matmul_stacked_fused.tiled_launches - tiled))
    assert outs[0] == outs[1]
    (_, plain_tiled), (spec_stats, spec_tiled) = stats
    assert spec_stats["spec_accepted"] > 0 and spec_stats["spec_drafted"] > 0
    assert plain_tiled == 0 < spec_tiled  # decode at 8 rows: the GEMV; the verify: the GEMM


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2560, 6912), (6912, 2560)], ids=["gate_up", "down"])
def test_k7_int32_at_16384_rows_on_card(shape):
    """K7's exact int32 mode at the 16384 rows of a 16K prompt on one card
    (the long-context prefill's projections), 2B gate/up and down: bitwise
    equal to its plain version over every row, through the GEMM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    k, n = shape
    g = torch.Generator(device=dev).manual_seed(16)
    xq = torch.randint(-128, 128, (16384, k), generator=g, device=dev, dtype=torch.int8)
    qw = torch.randint(0, 256, (k // 4, n), generator=g, device=dev, dtype=torch.uint8)
    tiled = ternary_cuda.ternary_matmul_stacked.tiled_launches
    got = ternary_cuda.ternary_matmul(xq, qw)
    assert got.dtype == torch.int32 and got.shape == (16384, n)
    assert ternary_cuda.ternary_matmul_stacked.tiled_launches == tiled + 1
    for r0 in range(0, 16384, 4096):
        assert torch.equal(got[r0:r0 + 4096],
                           ternary_cuda.ternary_matmul_plain(xq[r0:r0 + 4096], qw)), r0


@pytest.mark.cuda
def test_long_context_engine_on_card():
    """LongContextEngine on an NCCL group of one against the dense forward
    in f32 at 2B width (2 layers; TF32 off), a 1500-token prompt in q-chunks
    of 512 (the last one shorter), 8 greedy tokens: ``chip_smoke.py``'s
    ``longctx_f32_gate`` (every layer's attention within
    ``LONGCTX_ATTN_TOL`` of the dense one, the logits within
    ``LONGCTX_HYBRID_TOL`` (bitwise) of the dense forward run with the ring's
    attention, the distance to the dense logits under the exact-attention
    witness's cap, and its two controls caught); every projection through
    K7 (7 per layer and forward pass)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    import dataclasses

    from chip_smoke import longctx_f32_gate
    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.engine.long_context import LongContextEngine, group_of_one
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.ops.ternary import ternary_linear

    dev = torch.device("cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        group = group_of_one(dev)
        assert torch.distributed.get_backend(group) == "nccl"
        cfg = dataclasses.replace(BitNetConfig.bitnet_2b(), num_layers=2, dtype=torch.float32)
        params = init_params(cfg, seed=0, device=dev)
        lce = LongContextEngine(params, cfg, group, device=dev)
        lce.PREFILL_Q_CHUNK = 512
        g = torch.Generator(device=dev).manual_seed(4)
        prompt = torch.randint(1, cfg.vocab_size, (1500,), generator=g, device=dev)

        def k7_linear(x, qw, scale, out_dtype=torch.bfloat16):
            return ternary_linear(x, qw, scale, out_dtype=out_dtype,
                                  kernel=ternary_cuda.ternary_matmul)

        launches = {}

        def generate():
            n = ternary_cuda.ternary_matmul_stacked.launches
            got = lce.generate(prompt.tolist(), 8)
            launches["n"] = ternary_cuda.ternary_matmul_stacked.launches - n
            return got

        rep, failures = longctx_f32_gate(lce, params, cfg, prompt, 8, k7_linear, generate)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert failures == [], rep
        assert launches["n"] == 7 * 2 * 8
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_long_route_beside_the_scheduler_on_card():
    """The async route on the card: a greedy prompt beyond max_context runs
    the ring path on its executor thread while a short stream runs on the
    replica's scheduler thread (2B width, 2 layers, bf16, a group of one),
    for each of two short prompts, three times: each request gets the
    tokens it gets served alone through the same route (the radix cache
    emptied before each run, so that every run starts from one state)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    import asyncio
    import dataclasses

    from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.engine.long_context import group_of_one
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.server.http import ByteTokenizer, InferenceServer

    dev = torch.device("cuda")
    cfg = dataclasses.replace(BitNetConfig.bitnet_2b(), num_layers=2)
    params = init_params(cfg, seed=0, device=dev)
    group = group_of_one(dev)
    try:
        eng = Engine(params, cfg, EngineConfig(max_batch_slots=8, page_size=16, num_pages=256,
                                               max_context=512, prefill_buckets=(32, 128)),
                     long_context_mesh=group, device=dev)
        g = torch.Generator(device=dev).manual_seed(5)
        prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g, device=dev).tolist()
                   for n in (3000, 40, 200)]
        greedy = SamplingParams(max_new_tokens=16, temperature=0.0)
        server = InferenceServer(eng, ByteTokenizer(), "synth:2-layer-2b")
        try:
            def serve(*ps):
                async def run():
                    return await asyncio.gather(*(server.async_engine.generate(p, greedy)
                                                  for p in ps))

                eng.reset_prefix_cache()
                return [r.output_ids for r in asyncio.run(run())]

            alone = [serve(p)[0] for p in prompts]
            assert alone[0] == eng.generate(prompts[0], greedy).output_ids
            for _ in range(3):
                for i in (1, 2):
                    assert serve(prompts[0], prompts[i]) == [alone[0], alone[i]], i
        finally:
            server.async_engine.shutdown()
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_axis_collectives_gloo_on_card():
    """``Axis.ppermute`` and ``Axis.all_to_all`` (and ``Axis.broadcast``) on
    CUDA tensors over gloo, two ranks on one card (the pipeline's and the
    expert all-to-all's collectives in ``chip_smoke.py``'s pp_ep phase):
    each result on the card and bit for bit what the CPU gives
    (``tests/test_torch_pipeline.py::test_axis_collectives`` holds the CPU
    world to the same values). gloo's point-to-point transfers cannot read
    CUDA memory, so the axis stages them through the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    # by its own name, as _subnormal_cases above
    from _torch_dist import axis_collectives_expected, run_worlds

    ranks = run_worlds((2,), "axis_collectives_case", dict(device="cuda:0"), timeout=300)[2]
    for index, (got, calls) in enumerate(ranks):
        want = axis_collectives_expected(index, 2)
        for k, (dev, v) in got.items():
            assert dev == "cuda" and (v == want[k]).all(), k
        assert calls == {"ppermute": 2, "all_to_all": 1, "broadcast": 1}
