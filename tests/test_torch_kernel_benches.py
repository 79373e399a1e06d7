"""The argument parsing and the host arithmetic of the kernel benches
``wrinklefree_tpu_torch/bench/flash_decode.py`` (K6),
``wrinklefree_tpu_torch/bench/flash_prefill.py`` (K4) and
``wrinklefree_tpu_torch/bench/pool_steps.py`` (the 2B forward's chunk and
decode step on one pool type), which time on a GPU: ``--pool`` picks the
pool type (bf16 by default), the bound follows it, and without a CUDA
device ``main`` refuses with code 2; all three take device time from one
yardstick, ``flash_decode.device_times``.
"""

import pytest

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu_torch.bench import flash_decode, flash_prefill, pool_steps
from wrinklefree_tpu_torch.ops import flash_attention

BENCHES = {"flash_decode": flash_decode, "flash_prefill": flash_prefill,
           "pool_steps": pool_steps}


@pytest.mark.parametrize("name", list(BENCHES))
def test_pool_defaults_to_bf16(name):
    args = BENCHES[name].parse_args([])
    assert args.pool == "bf16" and args.iters == (5 if name == "pool_steps" else 50)


@pytest.mark.parametrize("pool", ["bf16", "fp16", "f32"])
@pytest.mark.parametrize("name", list(BENCHES))
def test_pool_choices(name, pool):
    args = BENCHES[name].parse_args(["--pool", pool, "--iters", "7", "--root", "/x"])
    assert (args.pool, args.iters, args.root) == (pool, 7, "/x")


@pytest.mark.parametrize("name", list(BENCHES))
def test_pool_refuses_other_types(name):
    with pytest.raises(SystemExit):
        BENCHES[name].parse_args(["--pool", "int8"])


@pytest.mark.parametrize("name", list(BENCHES))
def test_main_needs_a_gpu(name, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert BENCHES[name].main(["--pool", "fp16"]) == 2


def test_decode_bound_by_pool():
    """K6 moves the history in the pool's type: fp16 as many bytes as bf16,
    f32 twice the history's (q, the output and the table stay)."""
    lens = flash_decode.SHAPES["mixed"]
    b16, f16, f32 = (flash_decode.bound(lens, p) for p in ("bf16", "fp16", "f32"))
    tokens = sum(n + 1 for n in lens)
    hist = 2 * tokens * flash_decode.KV * flash_decode.D * 2
    assert b16 == f16 and f32 > b16
    assert flash_decode.nbytes(lens, "f32") - flash_decode.nbytes(lens, "bf16") == hist


def test_prefill_bound_and_block_by_pool():
    """K4's bound on fp16 is bf16's (the same bytes, the same tensor-core
    rate); on f32 the 3xTF32 rate, a third of TF32's 495 T/s (six times
    bf16's time), and beside it the bound on f32 FMAs (67 T/s, 495 / 3 / 67
    = 2.46 times the 3xTF32 one). Every pool type takes the tensor-core
    kernels' block."""
    c = flash_prefill.CONTIGUOUS
    args = (c["S"], [c["kv_valid"]], [c["new_len"]])
    b16, f16, f32 = (flash_prefill.bound(*args, p) for p in ("bf16", "fp16", "f32"))
    assert b16 == f16 and b16[1] == "operations"
    assert f32[1] == "operations" and f32[0] == pytest.approx(b16[0] * 989 / 165)
    fma = flash_prefill.fma_bound(*args, "f32")["bound_f32_fma_ms"]
    assert fma == pytest.approx(f32[0] * 165 / 67)
    assert flash_prefill.fma_bound(*args, "bf16") == {}
    g = flash_prefill.NH // flash_prefill.KV
    for pool in ("bf16", "fp16", "f32"):
        assert flash_prefill.block_q(flash_attention, pool) == flash_attention.flash_prefill_bq(g)


# (intervals, the length of their union)
UNIONS = [([], 0.0), ([(0, 5)], 5.0), ([(0, 5), (5, 7)], 7.0), ([(3, 4), (0, 10)], 10.0),
          ([(6, 9), (0, 2), (1, 3)], 6.0), ([(0, 1), (2, 3), (2.5, 4)], 3.0)]


@pytest.mark.parametrize("spans,want", UNIONS)
def test_busy_us_is_the_union(spans, want):
    """The device-time yardstick of every bench (``flash_decode.busy_us``):
    overlapping and touching intervals count once, in any order."""
    assert flash_decode.busy_us(spans) == want
    assert flash_decode.busy_us(iter(spans[::-1])) == want


def test_pool_steps_times_with_flash_decode():
    """``pool_steps`` loads ``device_times`` from its own tree's
    ``flash_decode.py`` (``--root`` may name an older tree): the same code."""
    got = pool_steps.device_times()
    assert got.__code__.co_code == flash_decode.device_times.__code__.co_code
