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


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_k6_split_matches_plain_on_card(g, b, split):
    """K6 split over 1, 2, 4 and 8 blocks per slot (the page-table width
    picks the split, as in the engine) against its plain version within 2e-2
    (probabilities round to bf16 against each warp's running max, and the
    states combine in warp and rank order), at seq_lens 0, 1, ps-1, ps,
    ps+1, 63, 64, 65 and MP*ps-1, G query heads per KV head, B slots, the
    first and the last layer. Two calls give the same bits. With the pool
    pages past each slot's committed span and the staging rows from its
    offset on set to NaN, the output is finite and bitwise equal to the run
    with those rows zero (the kernel never reads them)."""
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

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for c in range(0, len(rows), b):
        sl = torch.tensor((rows[c:] + rows)[:b], dtype=torch.int32, device=dev)
        main = rnd(b * mp + 1, 2 * n_l, ps, kv * 128)
        stage = rnd(b, ps, 2 * n_l, kv * 128)
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
            torch.testing.assert_close(a.float(), ref.float(), rtol=2e-2, atol=2e-2)
            assert torch.equal(a, again)
            assert torch.isfinite(p).all() and torch.equal(p, z)
            assert torch.equal(a, z)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [8, 12, 32, 64])
def test_k6_page_sizes_on_card(ps):
    """K6 at page sizes other than the engine's 16: committed rows row by row
    where a page does not hold whole 16-row boxes (8, 12), by box at an
    offset inside the page (32, 64); against its plain version within 2e-2,
    at seq_lens around the page and the 64-token tile, both layers, a split
    above 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(70 + ps)
    b, kv, g, n_l = 6, 2, 4, 2
    mp = -(-512 // ps)
    lens = [0, ps - 1, ps + 1, 63, 65, mp * ps - 1]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    main = rnd(b * mp + 1, 2 * n_l, ps, kv * 128)
    stage = rnd(b, ps, 2 * n_l, kv * 128)
    q, kc, vc = rnd(b, kv * g, 128), rnd(b, kv, 128), rnd(b, kv, 128)
    pt = (torch.randperm(b * mp, generator=gen, device=dev) + 1).reshape(b, mp).to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert flash_attention.flash_decode_split(b, kv, mp * ps, sms) > 1
    for layer in (0, n_l - 1):
        a = flash_attention.flash_paged_decode(q, kc, vc, main, stage, layer, pt, sl)
        ref = flash_attention.flash_paged_decode_plain(q, kc, vc, main, stage, layer, pt, sl)
        torch.testing.assert_close(a.float(), ref.float(), rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()


def _k4_check(run, plain, real_rows, poison_runs):
    """K4 against its plain version within 3e-2 on the real query rows; two
    calls bitwise equal; with NaN in every row the kernel may not read, the
    real rows finite and bitwise equal to the run with zeros there."""
    a, again, ref = run(), run(), plain()
    for b, n in enumerate(real_rows):
        # probabilities round to bf16 against the running max in the kernel,
        # after normalization in the plain softmax
        torch.testing.assert_close(a[b, :n].float(), ref[b, :n].float(), rtol=3e-2, atol=3e-2)
    assert torch.equal(a, again)
    z, p = (r() for r in poison_runs)
    for b, n in enumerate(real_rows):
        assert torch.isfinite(p[b, :n]).all() and torch.equal(p[b, :n], z[b, :n])
        assert torch.equal(a[b, :n], z[b, :n])


# (query heads per KV head, page size, chunk, batch)
K4_POOL_CASES = [(1, 16, 512, 1), (4, 16, 512, 1), (8, 16, 512, 1), (4, 16, 128, 4),
                 (1, 16, 128, 4), (8, 16, 128, 4), (4, 8, 128, 4), (4, 64, 128, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("g,ps,s,b", K4_POOL_CASES,
                         ids=[f"G{g}-ps{ps}-S{s}-B{b}" for g, ps, s, b in K4_POOL_CASES])
def test_k4_pool_matches_plain_on_card(g, ps, s, b):
    """K4 reading its history from the pool (``flash_paged_prefill_pool``)
    against its plain version (the gathered history, as the paged forward
    had it) at seq_lens 0, ps, 5 ps and the full table (256 tokens), new_lens
    1, 63, 64, 65 and S, different per row, the first and the last layer;
    boxes of 16 rows (ps 16, 64) and rows one by one (ps 8). Deterministic,
    and blind to NaN in the pool pages from each row's seq_lens on and in
    the chunk's rows from its new_lens on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(80 + g + ps + s + b)
    kv, n_l, mp = 2, 3, 256 // ps
    sls, nls = [0, ps, 5 * ps, mp * ps], [1, 63, 64, 65, s]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

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
            _k4_check(
                lambda: fa.flash_paged_prefill_pool(q, kc, vc, main, layer, pt, slt, nlt),
                lambda: fa.flash_paged_prefill_pool_plain(q, kc, vc, main, layer, pt, slt, nlt),
                nl,
                [lambda m=m, kv_=kv_: fa.flash_paged_prefill_pool(q, *kv_, m, layer, pt, slt, nlt)
                 for m, kv_ in zip(pools, curs)])
            assert fa.flash_paged_prefill.launches - n0 == 4
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("s,b", [(128, 4), (512, 1)])
def test_k4_contiguous_matches_plain_on_card(g, s, b):
    """K4 over contiguous keys (``flash_paged_prefill``, the reference's
    signature) against its plain version at kv_valid 0, 16, 80 and the whole
    history (hist_len 256), new_len 1, 63, 64, 65 and S; deterministic, and
    blind to NaN in the history columns from kv_valid on and in the chunk's
    columns from new_len on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(90 + g + s + b)
    kv, T = 2, 256
    kvs, nls = [0, 16, 80, T], [1, 63, 64, 65, s]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

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
        _k4_check(lambda: fa.flash_paged_prefill(q, kf, vf, kvt, nlt, hist_len=T),
                  lambda: fa.flash_paged_prefill_plain(q, kf, vf, kvt, nlt, hist_len=T),
                  nl,
                  [lambda f=f: fa.flash_paged_prefill(q, *f, kvt, nlt, hist_len=T)
                   for f in fills])
    torch.cuda.synchronize()
