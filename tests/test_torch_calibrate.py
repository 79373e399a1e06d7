"""The port's stream calibration (K10) vs the JAX reference, on the CPU.

  bench.calibrate.touch (plain)  vs a numpy statement of the TPU kernel's body
                                    (wrinklefree_tpu/bench/calibrate.py, _kernel)
  calibrate(device="cpu")        vs wrinklefree_tpu.bench.calibrate.calibrate()

The TPU kernel is nested inside ``measure_stream_us_per_layer``, which returns
``(None, None)`` off the TPU, so its function is stated here in numpy.
tests/test_torch_cuda.py and chip_smoke.py hold the kernel against the plain
version on the card.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.bench import calibrate as ref_cal
from wrinklefree_tpu_torch.bench import calibrate


def _kernel_numpy(h, gw, dw, layer, tn_gu, tn_d):
    """The TPU kernel's grid in order: acc += gw[l, :8, :128] of each gate/up
    tile, then of each down tile; the output is h + acc."""
    acc = np.zeros((8, 128), np.float32)
    for g in range(gw.shape[2] // tn_gu):
        acc += gw[layer, :8, g * tn_gu:g * tn_gu + 128].astype(np.float32)
    for d in range(dw.shape[2] // tn_d):
        acc += dw[layer, :8, d * tn_d:d * tn_d + 128].astype(np.float32)
    return h + acc


@pytest.mark.parametrize("layer,tn", [(0, (256, 128)), (2, (512, 256))])
def test_touch_plain_matches_kernel_body(layer, tn):
    """Bit for bit (the integer sums are exact in f32), and the checksum is
    the sum of the layer's bytes read as int32 words."""
    rng = np.random.default_rng(layer)
    gw = rng.integers(-127, 127, size=(3, 16, 1024), dtype=np.int8)
    dw = rng.integers(-127, 127, size=(3, 24, 512), dtype=np.int8)
    h = rng.normal(size=(8, 128)).astype(np.float32)
    checksum = torch.full((1,), 5, dtype=torch.int64)
    got = calibrate.touch(torch.from_numpy(h), torch.from_numpy(gw), torch.from_numpy(dw),
                          layer, checksum, tn_gu=tn[0], tn_d=tn[1])
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), _kernel_numpy(h, gw, dw, layer, *tn))
    words = (gw[layer].view(np.int32).astype(np.int64).sum()
             + dw[layer].view(np.int32).astype(np.int64).sum())
    assert int(checksum) == 5 + int(words)


def test_stream_weights_are_the_reference_draw():
    """The 2B MLP's int8 weights from np.random.default_rng(0), as the
    reference draws them (its lines 77-79), on a cut config."""
    from wrinklefree_tpu_torch.config import BitNetConfig

    cfg = BitNetConfig(num_layers=2, hidden_size=256, intermediate_size=512)
    gw, dw = calibrate.stream_weights("cpu", cfg)
    rng = np.random.default_rng(0)
    want_g = rng.integers(-127, 127, size=(2, 64, 1024), dtype=np.int8)
    want_d = rng.integers(-127, 127, size=(2, 128, 256), dtype=np.int8)
    assert np.array_equal(gw.numpy(), want_g) and np.array_equal(dw.numpy(), want_d)


def test_stream_not_measured_on_cpu():
    assert calibrate.measure_stream_us_per_layer(device="cpu") == (None, None)
    with pytest.raises(ValueError):
        calibrate.stream_busy_share(device="cpu")


def test_calibrate_keys_match_reference():
    """The stamp has the reference's keys; on a CPU device the stream is not
    measured. Its reference stream time and bounds are the port's own, not
    the reference's TPU numbers."""
    ref = ref_cal.calibrate()
    got = calibrate.calibrate(device="cpu")
    assert set(got) == set(ref)
    assert got["platform"] == "cpu" and got["stream_us_per_layer"] is None
    assert got["stream_gb_s"] is None and got["transport_rt_ms"] > 0
    assert got["stream_ref_us"] == calibrate.REF_STREAM_US != ref_cal._REF_STREAM_US
    assert calibrate.HEALTHY_RT_MS != ref_cal._HEALTHY_RT_MS
    assert calibrate.HEALTHY_STREAM_US != ref_cal._HEALTHY_STREAM_US
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert calibrate.main(["--device", "cpu"]) == 0
    assert set(json.loads(buf.getvalue())) == set(ref)
