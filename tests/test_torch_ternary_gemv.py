"""The host rule and the arithmetic of the port's decode GEMV
(``wrinklefree_tpu_torch/csrc/ternary_gemv.cu``, K1 and K7 at 8 rows or
fewer), written in PyTorch, against the JAX reference on the CPU.

The GEMV splits each 128-column tile's K/4 packed rows over ``gemv_split``
blocks in k-steps of 8 packed rows. Each block multiplies the unsigned
weight codes (w + 1, in {0, 1, 2}; random bytes also give 3) by its slice of
the int8 codes and subtracts the codes' sum over that slice; the blocks'
partials add up to the signed dot. That sum must be bit for bit the port's
``ternary_matmul_reference`` and the reference's ``ternary_matmul_pallas`` in
its int32 mode (interpret mode), on the same seed-made numpy inputs, for
every split and at a K/4 that is not a multiple of the k-step or the split.
The kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.ops import ternary_pallas as ref_tp
from wrinklefree_tpu_torch.ops import ternary_cuda
from wrinklefree_tpu_torch.ops.ternary import ternary_matmul_reference

H100_SMS = 132
# BitNet-2B's decode dots (K, N) and the split the rule gives on an H100
SPLITS_2B = [
    ("qkv", 2560, 3840, 4),
    ("o", 2560, 2560, 4),
    ("gateup", 2560, 13824, 1),
    ("down", 6912, 2560, 4),
    ("expert gate", 2560, 6912, 2),
    ("k", 2560, 640, 8),
]


@pytest.mark.parametrize("name,k,n,split", SPLITS_2B, ids=[s[0] for s in SPLITS_2B])
def test_gemv_split_at_2b_shapes(name, k, n, split):
    """Every 2B shape's grid stays within one block per SM, and doubling the
    split would leave it (or pass the cluster's 8 blocks per tile)."""
    got = ternary_cuda.gemv_split(k, n, H100_SMS)
    assert got == split
    tiles = -(-n // 128)
    assert tiles * got <= H100_SMS
    assert 2 * tiles * got > H100_SMS or got == 8


def test_gemv_split_bounds():
    """A power of two in [1, 8], never more than the k-steps of 8 packed rows,
    and the largest whose grid stays within one block per SM."""
    rng = np.random.default_rng(0)
    for _ in range(500):
        k = 4 * int(rng.integers(1, 3000))
        n = 16 * int(rng.integers(1, 1200))
        sms = int(rng.integers(1, 200))
        s = ternary_cuda.gemv_split(k, n, sms)
        steps = -(-(k // 4) // 8)
        tiles = -(-n // 128)
        assert s in (1, 2, 4, 8) and (s == 1 or s <= steps)
        assert s == 1 or tiles * s <= sms
        assert 2 * tiles * s > sms or s == 8 or 2 * s > steps


def gemv_model(xq: torch.Tensor, qw: torch.Tensor, split: int) -> torch.Tensor:
    """The kernel's integer arithmetic: per block of the split, the unsigned
    codes of its slice of packed rows times the codes, minus the codes' sum
    over the slice; the blocks' partials summed."""
    k4, n = qw.shape
    steps = -(-k4 // 8)
    x = xq.to(torch.int64).reshape(xq.shape[0], 4, k4)  # [m, plane p, packed row r]
    codes = torch.stack([((qw >> (2 * p)) & 3).to(torch.int64) for p in range(4)])  # [p, r, n]
    total = torch.zeros((xq.shape[0], n), dtype=torch.int64)
    for rank in range(split):
        r0 = rank * steps // split * 8
        r1 = min(k4, (rank + 1) * steps // split * 8)
        xs = x[:, :, r0:r1]
        part = torch.einsum("mpr,prn->mn", xs, codes[:, r0:r1])
        total += part - xs.sum(dim=(1, 2))[:, None]
    return total.to(torch.int32)


@pytest.mark.parametrize("k,n", [(336, 272), (400, 144), (2560, 640)])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8])
def test_gemv_partials_give_the_exact_dot(rows, k, n):
    """The split's partials, for the rule's split and for 1, 3 and 8 blocks,
    sum to the port's reference dot and to the reference's
    ternary_matmul_pallas int32 mode (interpret mode). K/4 = 84 and 100 are
    not multiples of the 8-row k-step or of the split; N = 272 and 144 not of
    the 128-column tile."""
    rng = np.random.default_rng(rows * 31 + k)
    xq = rng.integers(-128, 128, (rows, k)).astype(np.int8)
    qw = rng.integers(0, 256, (k // 4, n)).astype(np.uint8)
    x, w = torch.from_numpy(xq), torch.from_numpy(qw)
    want = ternary_matmul_reference(x, w)
    for split in {ternary_cuda.gemv_split(k, n, H100_SMS), 1, 3, 8}:
        assert torch.equal(gemv_model(x, w, split), want), split
    ref = ref_tp.ternary_matmul_pallas(jnp.asarray(xq), jnp.asarray(qw), interpret=True)
    assert np.array_equal(np.asarray(ref), want.numpy())
