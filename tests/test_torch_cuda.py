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
@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4"])
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
