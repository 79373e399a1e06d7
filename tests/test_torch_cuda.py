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
