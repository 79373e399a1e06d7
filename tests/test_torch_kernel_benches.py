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


# each kernel bench's H100 figures (from bench/roofline.py::GPU_SPECS["h100"])
# and the literals they were before that table: the same numbers
BENCH_PEAKS = {
    "flash_decode": {"HBM_BYTES_PER_S": 3.35e12},
    "causal_prefill": {"HBM_BYTES_PER_S": 3.35e12},
    "flash_prefill": {"HBM_BYTES_PER_S": 3.35e12, "F16_OPS_PER_S": 989e12,
                      "TF32_OPS_PER_S": 495e12, "F32_OPS_PER_S": 67e12},
    "mlp_block": {"HBM_BYTES_PER_S": 3.35e12, "INT8_OPS_PER_S": 1979e12,
                  "BF16_OPS_PER_S": 989e12},
    "attn_block": {"HBM_BYTES_PER_S": 3.35e12, "INT8_OPS_PER_S": 1979e12,
                   "BF16_OPS_PER_S": 989e12},
}


@pytest.mark.parametrize("name", list(BENCH_PEAKS))
def test_bench_peaks_come_from_the_roofline_table(name):
    import importlib

    from wrinklefree_tpu_torch.bench.roofline import GPU_SPECS

    mod = importlib.import_module(f"wrinklefree_tpu_torch.bench.{name}")
    assert mod.GPU_SPECS is GPU_SPECS
    for const, value in BENCH_PEAKS[name].items():
        assert getattr(mod, const) == value, const


def test_bench_bounds_unchanged():
    """The bounds each bench prints at its shapes, as PERF.md's kernel table
    gives them (ms, rounded to 1e-5), read from the one peaks table."""
    from wrinklefree_tpu_torch.bench import attn_block, causal_prefill, mlp_block

    def r(b):
        return round(b[0] if isinstance(b, tuple) else b, 5)

    assert [r(flash_decode.bound(lens)) for lens in flash_decode.SHAPES.values()] == [
        0.00476, 0.01226, 0.00153]
    c = flash_prefill.CONTIGUOUS
    assert r(flash_prefill.bound(c["S"], [c["kv_valid"]], [c["new_len"]])) == 0.00337
    assert [r(flash_prefill.bound(*v)) for v in flash_prefill.POOL.values()] == [0.00679,
                                                                                 0.00435]
    assert [r(causal_prefill.bound(*s)) for s in causal_prefill.SHAPES] == [
        0.00196, 0.00205, 0.02007, 0.03009]
    assert (r(mlp_block.bound(8)), r(mlp_block.bound(1))) == (0.00401, 0.00399)
    assert [r(attn_block.bound(p)) for _, p in attn_block.SHAPES] == [0.00149, 0.00127, 0.0028]
    assert [r(attn_block.bound(p, mlp=True)) for _, p in attn_block.SHAPES] == [
        0.00547, 0.00526, 0.00679]
