"""Device health calibration for benchmark artifacts, on the GPU.

Counterpart of ``wrinklefree_tpu/bench/calibrate.py``: a short measurement
of (a) the round trip of a trivial op and its host read and (b) the rate at
which the card streams one BitNet-2B layer's packed MLP weights through a
touch-only kernel (K10, ``csrc/calibrate.cu``), so that a slow benchmark
row beside a slow stamp points at the machine, not the engine.

The stream is the slope between two windows of chained K10 launches
(``h <- touch(h, layer l % L)``), each window captured once in a CUDA graph
and timed by its replay: one layer's 13.27 MB take about 4 us at 3.35 TB/s,
less than an eager launch from Python, so an eager chain would time the
host (the reference chains its windows in one jitted ``scan`` for the same
reason). ``stream_busy_share`` profiles replays to show that the card, not
the host, fills the window.

The reference stream time and the health bounds are this port's own,
measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit by
``chip_smoke.py``'s calibrate phase; the bounds keep the reference's
margins (2x for the round trip, 25/18.16 for the stream).

    python -m wrinklefree_tpu_torch.bench.calibrate [--device cuda] [--busy N]

prints one JSON line with the reference's keys (and, with ``--busy N``, N
readings of the busy share, one line each). On a CPU device the stream
is not measured (``None``), as the reference off the TPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import BitNetConfig
from ..models.bitnet import resolve_device
from ..ops import cuda_lib

# measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py calibrate phase)
REF_STREAM_US = 7.2  # us per layer: the 64 -> 512 window slope (1.84 TB/s)
REF_RT_MS = 0.032  # the round trip of measure_transport_rt_ms
HEALTHY_RT_MS = 2.0 * REF_RT_MS
HEALTHY_STREAM_US = REF_STREAM_US * 25.0 / 18.16
TN_GU, TN_D = 1536, 1280  # the reference's weight tile widths


def touch_plain(h, gw, dw, layer: int, checksum, *, tn_gu: int = TN_GU, tn_d: int = TN_D):
    """Plain version of K10: ``h + sum_g gw[layer, :8, g*tn_gu:][:, :128] +
    sum_d dw[layer, :8, d*tn_d:][:, :128]`` in f32 (the TPU kernel's
    function; the integer sums are exact in f32), and ``checksum`` (one
    int64) incremented by the sum of the layer's bytes read as int32 words."""
    k4, n_gu = gw.shape[1:]
    n_h = dw.shape[2]
    g = gw[layer, :8].reshape(8, n_gu // tn_gu, tn_gu)[:, :, :128].float().sum(dim=1)
    d = dw[layer, :8].reshape(8, n_h // tn_d, tn_d)[:, :, :128].float().sum(dim=1)
    checksum += gw[layer].view(torch.int32).sum() + dw[layer].view(torch.int32).sum()
    return h + (g + d)


def touch(
    h: torch.Tensor,  # [8, 128] f32
    gw: torch.Tensor,  # [L, H/4, 2I] int8
    dw: torch.Tensor,  # [L, I/4, H] int8
    layer: int,
    checksum: torch.Tensor,  # [1] int64, incremented in place
    *,
    tn_gu: int = TN_GU,
    tn_d: int = TN_D,
) -> torch.Tensor:
    """One touch of layer ``layer``'s packed MLP weights: reads every byte
    once and returns the TPU kernel's [8, 128] function of them (K10)."""
    if h.device.type == "cpu":
        return touch_plain(h, gw, dw, layer, checksum, tn_gu=tn_gu, tn_d=tn_d)
    cuda_lib.require_cuda(h, "touch")
    L, k4, n_gu = gw.shape
    _, i4, n_h = dw.shape
    if not 0 <= layer < L or dw.shape[0] != L:
        raise IndexError(f"layer {layer} out of range for {L} stacked layers")
    if gw.dtype != torch.int8 or dw.dtype != torch.int8 or not (gw.is_contiguous()
                                                                and dw.is_contiguous()):
        raise ValueError("the weights must be contiguous int8 stacks")
    if (k4 * n_gu) % 16 or (i4 * n_h) % 16 or gw.data_ptr() % 16 or dw.data_ptr() % 16:
        raise ValueError("the CUDA kernel reads 16-byte words of each layer")
    if n_gu % tn_gu or n_h % tn_d or min(k4, i4) < 8 or min(tn_gu, tn_d) < 128:
        raise ValueError(f"weights {tuple(gw.shape)}/{tuple(dw.shape)} do not tile by "
                         f"{tn_gu}/{tn_d} with 8 rows and 128 columns")
    if (h.dtype != torch.float32 or tuple(h.shape) != (8, 128) or checksum.dtype != torch.int64
            or checksum.numel() != 1 or checksum.device != h.device):
        raise ValueError("h must be [8, 128] float32 and checksum one int64 on h's device")
    hc = h.contiguous()
    out = torch.empty((8, 128), dtype=torch.float32, device=h.device)
    cuda_lib.call(
        "wf_stream_touch", hc.data_ptr(), gw[layer].data_ptr(), dw[layer].data_ptr(), k4, n_gu,
        i4, n_h, tn_gu, tn_d, out.data_ptr(), checksum.data_ptr(), cuda_lib.stream(h),
    )
    touch.launches += 1
    return out


touch.launches = 0


def stream_weights(device, cfg: BitNetConfig = None):
    """The 2B MLP's packed weights as the reference makes them: int8
    ``[L, H/4, 2I]`` and ``[L, I/4, H]`` from ``np.random.default_rng(0)``."""
    cfg = cfg or BitNetConfig.bitnet_2b()
    L, H, inter = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    rng = np.random.default_rng(0)
    gw = rng.integers(-127, 127, size=(L, H // 4, 2 * inter), dtype=np.int8)
    dw = rng.integers(-127, 127, size=(L, inter // 4, H), dtype=np.int8)
    return torch.from_numpy(gw).to(device), torch.from_numpy(dw).to(device)


def _chain_graph(gw, dw, steps: int):
    """A CUDA graph of ``steps`` chained touches over the layers, cycling.
    Returns (graph, the tensors it reads and writes besides the weights):
    the caller keeps both, since a replay writes to the tensors' memory."""
    dev = gw.device
    L = gw.shape[0]
    h = torch.ones((8, 128), dtype=torch.float32, device=dev)
    checksum = torch.zeros(1, dtype=torch.int64, device=dev)
    touch(h, gw, dw, 0, checksum)  # builds the kernels before the capture
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = h
        for i in range(steps):
            out = touch(out, gw, dw, i % L, checksum)
    return graph, (h, checksum, out)


def _replay_s(graph) -> float:
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def measure_transport_rt_ms(n: int = 10, device=None) -> float:
    """The minimum round trip (ms) of a trivial op and the host read of its
    result."""
    dev = resolve_device(device)
    x = torch.zeros((8,), dtype=torch.float32, device=dev)
    (x + 1).cpu()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        (x + 1).cpu()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def measure_stream_us_per_layer(windows=(64, 512), reps: int = 3, device=None):
    """K10 chained over the 2B MLP's packed weights: the slope between two
    windows of ``windows`` steps, the best of ``reps``. Returns
    ``(us_per_layer, gb_per_s)``, or ``(None, None)`` on a CPU device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None, None
    gw, dw = stream_weights(dev)
    layer_bytes = gw[0].numel() + dw[0].numel()
    n1, n2 = windows
    (g1, io1), (g2, io2) = _chain_graph(gw, dw, n1), _chain_graph(gw, dw, n2)
    _replay_s(g1)
    _replay_s(g2)
    slope = min((_replay_s(g2) - _replay_s(g1)) / (n2 - n1) for _ in range(reps))
    del io1, io2  # the graphs' tensors outlive every replay
    return slope * 1e6, layer_bytes / slope / 1e9


def stream_busy_share(steps: int = 512, device=None, replays: int = 5):
    """The device's busy share of a window of ``steps`` chained touches, the
    median over ``replays`` traced replays of the window's graph. Each
    replay's share is the time in which a touch kernel ran (the union of the
    kernels' intervals that ``torch.profiler`` records) over that replay's
    device span, from the first kernel's start to the last one's end: both
    come from the same replay. (Dividing one traced replay's kernel time by
    the host wall of other, untraced replays mixed two clocks and two sets
    of replays, and its reading moved with the host's timing of the
    replay.) A host that cannot feed the chain shows as gaps between the
    kernels. Returns (the median share, kernel seconds and span seconds of
    that replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the busy share is a device measurement")
    gw, dw = stream_weights(dev)
    graph, io = _chain_graph(gw, dw, steps)
    _replay_s(graph)
    readings = []
    for _ in range(replays):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _replay_s(graph)
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if not spans:
            raise RuntimeError("torch.profiler recorded no kernel of the window")
        busy, end = 0.0, spans[0][0]
        for a, b in spans:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        window = spans[-1][1] - spans[0][0]
        readings.append((busy / window, busy / 1e6, window / 1e6))
    del io  # the graph's tensors outlive every replay
    return sorted(readings)[len(readings) // 2]


def calibrate(device=None) -> dict:
    """The health stamp. Keys: platform, transport_rt_ms,
    stream_us_per_layer, stream_gb_s, stream_ref_us, healthy."""
    dev = resolve_device(device)
    rt = measure_transport_rt_ms(device=dev)
    us, gbs = measure_stream_us_per_layer(device=dev)
    healthy = rt < HEALTHY_RT_MS and (us is None or us < HEALTHY_STREAM_US)
    return {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "transport_rt_ms": round(rt, 4),
        "stream_us_per_layer": None if us is None else round(us, 3),
        "stream_gb_s": None if gbs is None else round(gbs, 1),
        "stream_ref_us": REF_STREAM_US,
        "healthy": bool(healthy),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--busy", type=int, default=0, metavar="N",
                    help="also print N readings of stream_busy_share(512), one JSON line each")
    a = ap.parse_args(argv)
    print(json.dumps(calibrate(a.device)))
    for i in range(a.busy):
        share, kernel_s, span_s = stream_busy_share(512, a.device)
        print(json.dumps({"busy_reading": i, "share": share, "kernel_s": kernel_s,
                          "span_s": span_s}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
