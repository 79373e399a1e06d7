"""The operand layout of the port's tensor-core ternary GEMM
(``wrinklefree_tpu_torch/csrc/ternary_gemm.cu``, K1 and K7 above 8 rows),
written in PyTorch, against the JAX reference on the CPU.

The GEMM multiplies the interleaved int8 codes (``interleave_codes``, what
K1's prologue and K7's pre-pass write) by the signed weight codes in the
layout the kernel unpacks in registers (``unpack_signed_interleaved``):
that product must be the exact integer dot, equal to the port's
``ternary_matmul_reference`` and to the reference's ``ternary_matmul_pallas``
in its int32 mode (interpret mode), on the same seed-made numpy inputs. The
shapes cover a K/4 that is not a multiple of the kernel's 32-row stage and
an N that is not a multiple of its 128-column tile. The kernel itself is
held against its plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.ops import ternary_pallas as ref_tp
from wrinklefree_tpu_torch.ops import ternary_cuda
from wrinklefree_tpu_torch.ops.ternary import ternary_matmul_reference, unpack_ternary

SHAPES = [(336, 272), (256, 384)]  # (K, N): ragged K/4 = 84 and N = 272; even


def case(rows, k, n, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-128, 128, (rows, k)).astype(np.int8)
    qw = rng.integers(0, 256, (k // 4, n)).astype(np.uint8)
    return xq, qw


def test_unpack_signed_interleaved_layout():
    """Bt[n, 4r + p] is weight W[p*K/4 + r, n] in {-1, 0, 1}: byte w[r, n]
    spread to its four codes, minus one."""
    _, qw = case(1, 336, 272, seed=0)
    w = torch.from_numpy(qw)
    bt = ternary_cuda.unpack_signed_interleaved(w)
    dense = unpack_ternary(w)  # [K, N]
    k4 = qw.shape[0]
    assert bt.dtype == torch.int8 and bt.shape == (272, 336)
    for r in (0, 1, 31, 32, 83):
        for p in range(4):
            assert torch.equal(bt[:, 4 * r + p], dense[p * k4 + r])


def test_interleave_codes_layout():
    """x4[m, 4r + p] = x[m, p*K/4 + r]."""
    xq, _ = case(9, 336, 16, seed=1)
    x4 = ternary_cuda.interleave_codes(torch.from_numpy(xq)).numpy()
    k4 = 84
    for r in (0, 5, 83):
        for p in range(4):
            assert np.array_equal(x4[:, 4 * r + p], xq[:, p * k4 + r])


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("rows", [9, 40, 64, 130])
def test_gemm_operands_give_the_exact_dot(rows, k, n):
    """interleave_codes(x) @ unpack_signed_interleaved(w).T, in int32, is
    bit for bit the port's reference dot and the reference's
    ternary_matmul_pallas int32 mode (interpret mode)."""
    xq, qw = case(rows, k, n, seed=rows * 7 + k)
    x, w = torch.from_numpy(xq), torch.from_numpy(qw)
    got = ternary_cuda.interleave_codes(x).int() @ ternary_cuda.unpack_signed_interleaved(w).int().T
    assert got.dtype == torch.int32 and got.shape == (rows, n)
    assert torch.equal(got, ternary_matmul_reference(x, w))
    ref = ref_tp.ternary_matmul_pallas(jnp.asarray(xq), jnp.asarray(qw), interpret=True)
    assert np.array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("k,n", [(20, 64), (64, 40), (256, 20), (256, 264), (100, 64),
                                 (264, 128), (2560, 3848)])
def test_gemm_shape_check(k, n):
    """At any row count the wrappers refuse a K or N that the GEMV's 16-byte
    loads and the GEMM's TMA cannot load (not a multiple of 16) with a
    ValueError, before any launch."""
    with pytest.raises(ValueError, match="multiples of 16"):
        ternary_cuda._check_rows16(k, n, 0, "ternary_matmul")
    ternary_cuda._check_rows16(2560, 3840, 256, "ternary_matmul")
