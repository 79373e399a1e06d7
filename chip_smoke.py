#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wrinklefree_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``wrinklefree_tpu_torch/csrc`` and runs seven phases at
BitNet b1.58-2B width (30 layers, H 2560, I 6912, 20 query / 5 KV heads,
vocab 128256) with random weights drawn on the card from seed 0:

1. build     — compile the kernels (one nvcc per source, in parallel);
2. kernels   — every kernel against its plain PyTorch version on the same
               inputs at the main paths' shapes, timed beside its bound
               (bytes over 3.35 TB/s or operations over the published dense
               peak) and a PyTorch library call; K1 and K7 at every row
               count 1-8 (the GEMV of csrc/ternary_gemv.cu; K7 bitwise in
               bf16, f32 and int32), 64 and 512; K2 at every row count
               1-8 bitwise against h + K1(K1(h)) and across two calls (its
               streamed dots' int32 merge); K5's qkv row and output bitwise
               against K1(h) and h + K1(its attention row) and across two
               calls; K8's attention half bitwise K5 and its output K2 of
               it; the static wrappers also
               bitwise against K5/K2, K1 above 8 rows (the tensor-core GEMM)
               bitwise against K1 over its 8-row slices (the GEMV), K6 at
               three history shapes (with its split, and checked for
               determinism and for NaN rows past the valid tokens), K4 over
               contiguous keys and over the pool (checked likewise), and
               the causal flash prefill, which no path runs, only here;
3. forward   — ``paged_forward``: a 128-token prefill chunk and 4 decode
               steps, once through the kernels and once through the plain
               functions, logits compared; then one 512-token chunk under
               the profiler (the ``prefill:`` line: its device ms, K1's
               share and K4's ms, exactly one K4 launch per layer);
4. batch1    — ``models.bitnet.forward`` at batch 1 (the path of
               ``wrinklefree_tpu_torch.bench.decode``) in its three modes
               (the default K5 + K2 pair, ``split``: the static wrappers on
               per-layer views, ``layer_mega``: K8): 8 decode steps through
               the kernels vs the plain functions per mode, ``split``
               bitwise equal to the default; a 64-token prefill and 64
               greedy steps whose exact head must equal the bf16 head's
               argmax every step, with the mode's kernels launched once per
               layer and step; then the bench's timed windows and the
               device's busy share per mode;
5. engine    — ``Engine``: six greedy requests (prompts of 17..700 tokens,
               32 new tokens each) and two radix-cache resubmissions, every
               serving kernel's launch counter growing (K1's GEMM in the
               prefills: ``tiled_launches``); then the six
               requests again with ``flash_decode=True``, whose decode
               attention kernel must launch once per layer and decode step;
6. moe       — the repo's MoE configuration (8 layers, 8 experts, top-2) on
               the unfused stacked linear and K7 experts: kernels vs plain,
               the fake-MoE oracle bit for bit against the dense model, and
               the engine phase with K7's launches per decode step counted;
7. calibrate — ``bench.calibrate.calibrate()`` (the stream-touch kernel
               chained in CUDA graphs) and the device's busy share of its
               window (median of 5 traced replays, kernel time over the same
               replay's device span), at least 90%.

It exits non-zero on any failure (nothing is caught, nothing falls back)
and when CUDA or the package is missing. The line before the last is a
JSON object with each kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
# published dense peaks: tensor cores for int8 and bf16, CUDA cores for f32
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}

KERNELS = {
    # K1 and K7 at <= 8 rows: the GEMV (K1 after its prologue in ternary.cu)
    "ternary_matmul_stacked_fused": {
        "source": "wrinklefree_tpu_torch/csrc/ternary_gemv.cu",
        "also_source": "wrinklefree_tpu_torch/csrc/ternary.cu",
        "replaces": "wrinklefree_tpu/ops/ternary_pallas.py:353",
    },
    "mlp_block_megakernel": {
        "source": "wrinklefree_tpu_torch/csrc/ternary.cu",
        "replaces": "wrinklefree_tpu/ops/ternary_pallas.py:2443",
    },
    "kv_write": {
        "source": "wrinklefree_tpu_torch/csrc/kv_write.cu",
        "replaces": "wrinklefree_tpu/ops/kv_update_pallas.py:57",
    },
    "flash_paged_prefill": {
        "source": "wrinklefree_tpu_torch/csrc/flash_paged_prefill.cu",
        "replaces": "wrinklefree_tpu/ops/flash_attention.py:219",
    },
    "attn_block_megakernel": {
        "source": "wrinklefree_tpu_torch/csrc/ternary.cu",
        "replaces": "wrinklefree_tpu/ops/ternary_pallas.py:1033",
        # the same function over the flat cache (ROADMAP queue 2 row 7)
        "also_replaces": "wrinklefree_tpu/ops/ternary_pallas.py:1991",
    },
    "flash_paged_decode": {
        "source": "wrinklefree_tpu_torch/csrc/flash_decode.cu",
        "replaces": "wrinklefree_tpu/ops/flash_attention.py:382",
    },
    "ternary_matmul_stacked": {
        "source": "wrinklefree_tpu_torch/csrc/ternary_gemv.cu",
        "replaces": "wrinklefree_tpu/ops/ternary_pallas.py:228",
        # the same kernel on one [K/4, N] matrix (ROADMAP queue 2 row 5)
        "also_replaces": "wrinklefree_tpu/ops/ternary_pallas.py:132",
    },
    "layer_block_megakernel": {
        "source": "wrinklefree_tpu_torch/csrc/ternary.cu",
        "replaces": "wrinklefree_tpu/ops/ternary_pallas.py:584",
    },
    # row 9: K5 and K2 launched on one layer's views by their own wrappers
    "attn_block_megakernel_static": {
        "source": "wrinklefree_tpu_torch/csrc/ternary.cu",
        "replaces": "wrinklefree_tpu/ops/ternary_pallas.py:1298",
    },
    "mlp_block_megakernel_static": {
        "source": "wrinklefree_tpu_torch/csrc/ternary.cu",
        "replaces": "wrinklefree_tpu/ops/ternary_pallas.py:2181",
    },
    "flash_prefill": {
        "source": "wrinklefree_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "wrinklefree_tpu/ops/flash_attention.py:88",
    },
    "measure_stream_us_per_layer": {
        "source": "wrinklefree_tpu_torch/csrc/calibrate.cu",
        "replaces": "wrinklefree_tpu/bench/calibrate.py:50",
    },
    # K1 and K7 above 8 rows: their wrappers' calls that end in the
    # tensor-core GEMM, counted in each wrapper's tiled_launches
    "ternary_matmul_stacked_fused/tiled": {
        "source": "wrinklefree_tpu_torch/csrc/ternary_gemm.cu",
        "replaces": "wrinklefree_tpu/ops/ternary_pallas.py:353",
    },
    "ternary_matmul_stacked/tiled": {
        "source": "wrinklefree_tpu_torch/csrc/ternary_gemm.cu",
        "replaces": "wrinklefree_tpu/ops/ternary_pallas.py:228",
        "also_replaces": "wrinklefree_tpu/ops/ternary_pallas.py:132",
    },
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def busy_us(events) -> float:
    """The time in which at least one of the device events (kernels, copies,
    sets) ran: the union of their intervals. It is their sum where they do
    not overlap; a grid launched with programmatic dependent launch (the
    decode GEMV after K1's prologue) may start while the grid before it
    still runs, and its wait for that grid is not device work of its own."""
    total, end = 0.0, None
    for e in sorted(events, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def cuda_ms(fn, iters: int = 20, warmup: int = 3):
    """(device ms, call ms) per call of fn. Device ms is the time the device
    was busy (busy_us over the kernels, copies and sets that torch.profiler
    records) over `iters` calls; call ms is CUDA-event time between the
    first and the last call, which includes the host's launch overhead when
    that is the longer of the two."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / iters
    # an empty window (see start_profiler) is profiled again, up to three
    # times, before that counts as a failure
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev_us = busy_us(device_events(prof))
        if dev_us > 0:
            break
    else:
        fail("torch.profiler recorded no device time")
    return dev_us / 1e3 / iters, call_ms


def start_profiler(dev) -> int:
    """Profile a small matmul until torch.profiler records device activity:
    the first sessions of a process can record none while CUPTI is still
    starting. Returns the sessions it took; fails after five."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones((256, 256), device=dev)
    for n in range(1, 6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            x @ x
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.key_averages()):
            return n
    fail("torch.profiler recorded no device activity in 5 sessions")


def bound(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3 if ops else 0.0
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the library yardstick of K1 and K7 above 8 rows (library_bf16_ms: the bf16
# matmul on unpacked weights that they are timed against at <= 8 rows)
INT_MM = "torch._int_mm (int8 codes x signed int8 weights, int32 out)"


def tc_share(ops: float, ms: float) -> float:
    """Share of the int8 tensor-core peak that `ops` operations in `ms` reach."""
    return ops / (ms * 1e-3 * PEAK_OPS["int8"])


class TiledCounter:
    """A wrapper's ``tiled_launches`` (its calls above 8 rows, which end in
    the tensor-core GEMM), zeroed and read like a wrapper's ``launches``."""

    def __init__(self, fn):
        self.fn = fn
        self.__name__ = fn.__name__ + "/tiled"

    @property
    def launches(self):
        return self.fn.tiled_launches

    @launches.setter
    def launches(self, n):
        self.fn.tiled_launches = n


class Cycle:
    """Layer index that advances on every call, so each launch streams
    another layer's weights (the stacks exceed the 50 MB L2, as in decode)."""

    def __init__(self, n):
        self.n, self.i = n, -1

    def __call__(self):
        self.i = (self.i + 1) % self.n
        return self.i


def phase_kernels(params, cfg, dev, results):
    import torch

    from wrinklefree_tpu_torch.kv.paged import PagedKV
    from wrinklefree_tpu_torch.ops import flash_attention as fa
    from wrinklefree_tpu_torch.ops import kv_update_cuda as kvu
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.ternary import unpack_ternary

    st = params["layers"]
    L = cfg.num_layers
    H, I, Q = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    # ---- K1 at the four linears of a layer, at 1-8 rows (the GEMV), 64 and
    # 512 rows; above 8 rows (the tensor-core GEMM) also bit for bit against
    # K1 over its 8-row slices (the same prologue per row, exact dot and
    # epilogue; so the GEMM against the GEMV). At 2-7 rows only the kernel is
    # timed (its plain and library times follow the row count as at 1 and 8).
    shapes = [  # name, weights, scales, norm row, act, input width
        ("qkv", "qkv", "input_ln", "none", H),
        ("o", "o", "attn_sub", "none", Q),
        ("gateup", "gateup", "post_ln", "none", H),
        ("down", "down", "ffn_sub", "relu2", 2 * I),
    ]
    k1_rows, k1_mid, k1_err, slice_checks = [], [], 0.0, 0
    for name, w, nrm, act, kin in shapes:
        qw, sw, nw = st[w + "_qw"], st[w + "_scale"], st[nrm]
        k, n = 4 * qw.shape[1], qw.shape[2]
        # the library yardsticks, cycled like the kernel's layers: bf16 matmul
        # against every layer's unpacked weight and, above 8 rows,
        # torch._int_mm of int8 codes with the signed int8 weights (the exact
        # int32 dot at the int8 peak; stored [N, K], K-major)
        wls = [unpack_ternary(qw[i]).to(torch.bfloat16) for i in range(L)]
        wis = [w.to(torch.int8).t().contiguous() for w in wls]
        for rows in (*range(1, 9), 64, 512):
            x = rnd(rows, kin)
            lay = Cycle(L)
            a = tc.ternary_matmul_stacked_fused(x, qw, 3, sw, nw, act=act)
            b = tc.ternary_matmul_stacked_fused_plain(x, qw, 3, sw, nw, act=act)
            if rows > 8:
                sl = torch.cat([tc.ternary_matmul_stacked_fused(x[r:r + 8], qw, 3, sw, nw, act=act)
                                for r in range(0, rows, 8)])
                torch.cuda.synchronize()
                if not torch.equal(a, sl):
                    fail(f"K1 {name} rows={rows}: differs from K1 over its 8-row slices by "
                         f"{(a.float() - sl.float()).abs().max().item()}")
                slice_checks += 1
            torch.cuda.synchronize()
            d = (a.float() - b.float()).abs()
            rel = (d / b.float().abs().amax(dim=1, keepdim=True).clamp_min(1e-30)).max().item()
            eq = (a == b).float().mean().item()
            # the prologue's f32 variance is a block tree sum in the kernel
            # and torch's reduction in the plain version: a bf16 rounding
            # boundary can move an int8 code by one
            if not (torch.isfinite(a).all() and rel <= 0.03):
                fail(f"K1 {name} rows={rows}: max row-relative error {rel}")
            k1_err = max(k1_err, d.max().item())
            ms, call_ms = cuda_ms(
                lambda: tc.ternary_matmul_stacked_fused(x, qw, lay(), sw, nw, act=act))
            nbytes = rows * kin * 2 + k // 4 * n + n * 4 + k * 2 + rows * n * 2
            b_ms, b_by = bound(nbytes, 2 * rows * k * n, "int8")
            if 1 < rows < 8:
                k1_mid.append(dict(shape=f"{name} {k}->{n} rows={rows}", ms=ms, bound_ms=b_ms,
                                   max_abs_err=d.max().item()))
                continue
            plain_ms, _ = cuda_ms(
                lambda: tc.ternary_matmul_stacked_fused_plain(x, qw, lay(), sw, nw, act=act),
                iters=5, warmup=1)
            xl = x[:, :k].contiguous()
            lib_ms, _ = cuda_ms(lambda: torch.matmul(xl, wls[lay()]))
            lib = dict(library_ms=lib_ms)
            if rows > 8:
                xi = torch.randint(-128, 128, (rows, k), generator=g, device=dev,
                                   dtype=torch.int8)
                int_ms, _ = cuda_ms(lambda: torch._int_mm(xi, wis[lay()].t()))
                lib = dict(library_ms=int_ms, library_bf16_ms=lib_ms, library=INT_MM,
                           tc_share=tc_share(2 * rows * k * n, ms))
            k1_rows.append(dict(shape=f"{name} {k}->{n} rows={rows}", ms=ms, call_ms=call_ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                max_abs_err=d.max().item(), exact_share=eq, **lib))
        del wls, wis
    for r in k1_rows:
        print("kernels: K1 " + json.dumps(r))
    for r in k1_mid:
        print("kernels: K1 " + json.dumps(r))
    print(f"kernels: K1 above 8 rows bitwise equal to K1 over its 8-row slices in "
          f"{slice_checks}/{slice_checks} checks")
    pick = next(r for r in k1_rows if r["shape"].startswith("qkv") and r["shape"].endswith("=8"))
    results["ternary_matmul_stacked_fused"] = dict(pick, max_abs_err=k1_err)
    results["ternary_matmul_stacked_fused/tiled"] = dict(
        next(r for r in k1_rows if r["shape"].startswith("qkv") and r["shape"].endswith("=512")),
        max_abs_err=max(r["max_abs_err"] for r in k1_rows if int(r["shape"].split("=")[-1]) > 8))

    # ---- K2: at every row count 1-8 bit for bit the composition of K1 calls
    # (h + K1(K1(h, gateup), down, relu^2, ffn_sub)) and the same over two
    # calls, as its streamed dots are exact int32 sums in any order; timed at
    # 1 and 8 rows
    k2_rows, k2_err = [], 0.0
    gw, dw = st["gateup_qw"], st["down_qw"]
    gs, ds, pl, fs = st["gateup_scale"], st["down_scale"], st["post_ln"], st["ffn_sub"]
    k2_checks = 0
    g2 = torch.Generator(device=dev).manual_seed(2)  # leaves rnd's stream to the later rows
    for rows in range(1, 9):
        for layer in (0, L - 1):
            h = torch.randn((rows, H), generator=g2, device=dev).to(torch.bfloat16)
            a = tc.mlp_block_megakernel(h, gw, dw, layer, gs, ds, pl, fs)
            a2 = tc.mlp_block_megakernel(h, gw, dw, layer, gs, ds, pl, fs)
            gu = tc.ternary_matmul_stacked_fused(h, gw, layer, gs, pl)
            want = h + tc.ternary_matmul_stacked_fused(gu, dw, layer, ds, fs, act="relu2")
            torch.cuda.synchronize()
            if not (torch.equal(a, want) and torch.equal(a, a2)):
                fail(f"K2 rows={rows} layer={layer}: not bitwise the K1 composition (max "
                     f"{(a.float() - want.float()).abs().max().item()}) or not deterministic")
            k2_checks += 1
    print(f"kernels: K2 bitwise equal to h + K1(K1(h)) and across two calls in "
          f"{k2_checks}/{k2_checks} checks (rows 1-8, layers 0 and {L - 1})")
    wgs = [unpack_ternary(gw[i]).to(torch.bfloat16) for i in range(L)]
    wds = [unpack_ternary(dw[i]).to(torch.bfloat16) for i in range(L)]
    for rows in (1, 8):
        h = rnd(rows, H)
        lay = Cycle(L)
        a = tc.mlp_block_megakernel(h, gw, dw, 3, gs, ds, pl, fs)
        b = tc.mlp_block_megakernel_plain(h, gw, dw, 3, gs, ds, pl, fs)
        gu = tc.ternary_matmul_stacked_fused(h, gw, 3, gs, pl)
        want = h + tc.ternary_matmul_stacked_fused(gu, dw, 3, ds, fs, act="relu2")
        torch.cuda.synchronize()
        d = (a.float() - b.float()).abs()
        rel = (d / b.float().abs().amax(dim=1, keepdim=True)).max().item()
        if not (torch.isfinite(a).all() and rel <= 0.05):
            fail(f"K2 rows={rows}: max row-relative error {rel}")
        k2_err = max(k2_err, d.max().item())
        ms, call_ms = cuda_ms(lambda: tc.mlp_block_megakernel(h, gw, dw, lay(), gs, ds, pl, fs))
        plain_ms, _ = cuda_ms(
            lambda: tc.mlp_block_megakernel_plain(h, gw, dw, lay(), gs, ds, pl, fs),
            iters=5, warmup=1)
        def lib():
            i = lay()
            gu = torch.matmul(h, wgs[i])
            return h + torch.matmul(torch.square(torch.relu(gu[:, :I])) * gu[:, I:], wds[i])

        lib_ms, _ = cuda_ms(lib)
        b_ms, b_by = _block_bytes_ops(st, cfg, 0, attn=False, rows=rows)
        k2_rows.append(dict(shape=f"mlp {H}->{2 * I}->{H} rows={rows}", ms=ms, call_ms=call_ms,
                            plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                            max_abs_err=d.max().item(), exact_share=(a == b).float().mean().item(),
                            exact_share_k1=(a == want).float().mean().item()))
    del wgs, wds
    for r in k2_rows:
        print("kernels: K2 " + json.dumps(r))
    results["mlp_block_megakernel"] = dict(k2_rows[-1], max_abs_err=k2_err)

    # ---- K3: 8 staging rows, and 8 page flushes into the layer-major pool;
    # timed over 8 sets of rows and destinations (160 MB for the flushes) so
    # repeats do not find their bytes in the 50 MB L2
    pools = PagedKV.zeros_dual(cfg, 1024, 16, 8, device=dev)
    two_l, kvd = 2 * L, cfg.num_kv_heads * cfg.head_dim
    k3_rows = []
    i32 = dict(device=dev, dtype=torch.int32)
    cases = [
        ("staging rows", pools.staging, [rnd(8, two_l, kvd) for _ in range(8)],
         [torch.arange(8, **i32)] * 8,
         [torch.randint(0, 16, (8,), generator=g, **i32) for _ in range(8)]),
        ("page flush", pools.kv.view(1024, 1, two_l * 16, kvd),
         [rnd(8, two_l * 16, kvd) for _ in range(8)],
         [torch.arange(1 + 8 * j, 9 + 8 * j, **i32) * 7 for j in range(8)],
         [torch.zeros(8, **i32)] * 8),
    ]
    for name, pool, vals, ids, offs in cases:
        a = kvu.kv_write(pool.clone(), vals[0], ids[0], offs[0])
        b = kvu.kv_write_plain(pool.clone(), vals[0], ids[0], offs[0])
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            fail(f"K3 {name}: kernel and plain writes differ")
        cyc = Cycle(8)

        def set_args():
            j = cyc()
            return pool, vals[j], ids[j], offs[j]

        ms, call_ms = cuda_ms(lambda: kvu.kv_write(*set_args()))
        plain_ms, _ = cuda_ms(lambda: kvu.kv_write_plain(*set_args()))
        flat = pool.view(pool.shape[0] * pool.shape[1], -1)
        rows_l = [(i.long() * pool.shape[1] + o.long()) for i, o in zip(ids, offs)]
        v2 = [v.reshape(v.shape[0], -1) for v in vals]

        def lib():
            j = cyc()
            return flat.index_copy_(0, rows_l[j], v2[j])

        lib_ms, _ = cuda_ms(lib)
        nbytes = 2 * vals[0].numel() * vals[0].element_size() + 8 * ids[0].numel()
        b_ms, b_by = bound(nbytes, 0, "bf16")
        k3_rows.append(dict(shape=f"{name} {tuple(vals[0].shape)}", ms=ms, call_ms=call_ms,
                            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=0.0))
    for r in k3_rows:
        print("kernels: K3 " + json.dumps(r))
    results["kv_write"] = dict(k3_rows[1])
    del pools

    kernels_k4(cfg, dev, results)
    kernels_k5(params, cfg, dev, rnd, results)
    kernels_k6(cfg, dev, results)
    kernels_k7(params, cfg, dev, g, results)
    kernels_k8_static(params, cfg, dev, rnd, results)
    kernels_k9(cfg, dev, g, results)
    kernels_k10(dev, results)


def kernels_k4(cfg, dev, results):
    """K4, the paged flash prefill, against its plain versions at the shapes
    of ``wrinklefree_tpu_torch/bench/flash_prefill.py`` (2B attention): over
    contiguous keys (a 512-token chunk over a 512-slot history, kv_valid 400,
    new_len 500: the kernels phase's first K4 shape) and over the pool at
    the engine's widest table (page size 16, 128 pages per row): one row of a
    512-token chunk after 1024 tokens, and four rows of 128-token chunks
    after 0/320/1024/1904 tokens; pool shapes at layers 0 and 29. Bar: 3e-2
    absolute on the real query rows (the kernel rounds probabilities to bf16
    against its running max, the plain softmax after normalization). At each
    shape two calls must give the same bits, and with NaN in every row the
    kernel may not read (history from kv_valid or seq_lens on, chunk keys
    from new_len on) the real rows must be finite and bitwise equal to the
    run with zeros there. Each shape prints its time, SDPA's over contiguous
    copies, the plain version's, the bound, the query tokens per block and
    the error."""
    import torch

    from wrinklefree_tpu_torch.bench import flash_prefill as bench
    from wrinklefree_tpu_torch.ops import flash_attention as fa

    L, NH, KV, D, ps = bench.L, bench.NH, bench.KV, bench.D, bench.PS
    if (L, NH, KV, D) != (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim):
        fail("K4: the bench's shapes are not the model's")
    inp = bench.make_inputs(dev, seed=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def checked(name, run, plain, poisoned, new_lens):
        """Max abs error of run() against plain() on the real rows, after
        the determinism and poison checks."""
        a, again, b = run(), run(), plain()
        torch.cuda.synchronize()
        err = max((a[i, :n].float() - b[i, :n].float()).abs().max().item()
                  for i, n in enumerate(new_lens))
        if not (all(torch.isfinite(a[i, :n]).all() for i, n in enumerate(new_lens))
                and err <= 3e-2):
            fail(f"K4 {name}: max abs error {err}")
        if not torch.equal(a, again):
            fail(f"K4 {name}: two calls differ")
        z, nan = (r() for r in poisoned)
        for i, n in enumerate(new_lens):
            if not (torch.isfinite(nan[i, :n]).all() and torch.equal(nan[i, :n], z[i, :n])
                    and torch.equal(a[i, :n], z[i, :n])):
                fail(f"K4 {name}: the NaN rows past the valid keys changed the output")
        return err

    def library_ms(q, ks, vs, mask):
        """SDPA over contiguous per-layer copies [n_l, B, KV, T, D], cycled."""
        cyc = Cycle(ks.shape[0])
        qs = q.transpose(1, 2)

        def lib():
            i = cyc()
            return sdpa(qs, ks[i], vs[i], attn_mask=mask, enable_gqa=True)

        return cuda_ms(lib)[0]

    rows = []
    # contiguous keys
    c = bench.CONTIGUOUS
    S, T = c["S"], c["T"]
    q, kf, vf, kvv, nl = bench.contiguous_case(inp)
    fills = []
    for fill in (0.0, float("nan")):
        k2, v2 = kf.clone(), vf.clone()
        k2[:, c["kv_valid"]:T], v2[:, c["kv_valid"]:T] = fill, fill
        k2[:, T + c["new_len"]:], v2[:, T + c["new_len"]:] = fill, fill
        fills.append((k2, v2))
    err = checked("contiguous", lambda: fa.flash_paged_prefill(q, kf, vf, kvv, nl, hist_len=T),
                  lambda: fa.flash_paged_prefill_plain(q, kf, vf, kvv, nl, hist_len=T),
                  [lambda f=f: fa.flash_paged_prefill(q, *f, kvv, nl, hist_len=T)
                   for f in fills], [c["new_len"]])
    del fills
    ms, call_ms = cuda_ms(lambda: fa.flash_paged_prefill(q, kf, vf, kvv, nl, hist_len=T))
    plain_ms, _ = cuda_ms(lambda: fa.flash_paged_prefill_plain(q, kf, vf, kvv, nl, hist_len=T))
    col = torch.arange(T + S, device=dev)
    row = torch.arange(S, device=dev)[:, None]
    mask = torch.where(col[None] < T, col[None] < c["kv_valid"],
                       ((col - T)[None] <= row) & ((col - T)[None] < c["new_len"]))
    lib_ms = library_ms(q, kf.transpose(1, 2)[None], vf.transpose(1, 2)[None], mask[None, None])
    b_ms, b_by = bench.bound(S, [c["kv_valid"]], [c["new_len"]])
    rows.append(dict(shape=f"contiguous S={S} T={T} kv_valid={c['kv_valid']} "
                           f"new_len={c['new_len']} NH={NH} KV={KV}",
                     ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                     library="SDPA", bound_ms=b_ms, bound_by=b_by,
                     bq=fa.flash_prefill_bq(NH // KV), max_abs_err=err,
                     deterministic=True, nan_rows_unread=True))
    # the pool
    for name, (S, sl, nls) in bench.POOL.items():
        (q, kc, vc, main), (pt, slt, nlt) = bench.pool_case(inp, name)
        B = len(sl)
        pm = main.clone()
        curs = []
        for fill in (0.0, float("nan")):
            k2, v2 = kc.clone(), vc.clone()
            for i in range(B):
                k2[i, nls[i]:], v2[i, nls[i]:] = fill, fill
            curs.append((k2, v2))
        err = 0.0
        for layer in (0, L - 1):
            def poisoned(fill, layer=layer, kv_=None):
                for i, n in enumerate(sl):
                    pm[pt[i, n // ps:].long()] = fill
                return fa.flash_paged_prefill_pool(q, *kv_, pm, layer, pt, slt, nlt)

            err = max(err, checked(
                f"{name} layer={layer}",
                lambda: fa.flash_paged_prefill_pool(q, kc, vc, main, layer, pt, slt, nlt),
                lambda: fa.flash_paged_prefill_pool_plain(q, kc, vc, main, layer, pt, slt, nlt),
                [lambda f=f, k=k: poisoned(f, kv_=k)
                 for f, k in zip((0.0, float("nan")), curs)], nls))
        del pm, curs
        lay = Cycle(L)
        ms, call_ms = cuda_ms(
            lambda: fa.flash_paged_prefill_pool(q, kc, vc, main, lay(), pt, slt, nlt))
        plain_ms, _ = cuda_ms(
            lambda: fa.flash_paged_prefill_pool_plain(q, kc, vc, main, lay(), pt, slt, nlt),
            iters=5, warmup=1)
        # the yardstick: SDPA over contiguous copies of each row's history and
        # chunk (made untimed; four layers' copies, so repeats miss the L2)
        Tm = max(sl) + S
        n_l = min(4, L)
        ks = torch.zeros((n_l, B, KV, Tm, D), dtype=torch.bfloat16, device=dev)
        vs = torch.zeros_like(ks)
        mask = torch.zeros((B, 1, S, Tm), dtype=torch.bool, device=dev)
        r = torch.arange(S, device=dev)[:, None]
        for i, (n, m) in enumerate(zip(sl, nls)):
            pages = pt[i, :n // ps].long()
            for li in range(n_l):
                ks[li, i, :, :n] = main[pages, li].reshape(n, KV, D).permute(1, 0, 2)
                vs[li, i, :, :n] = main[pages, L + li].reshape(n, KV, D).permute(1, 0, 2)
                ks[li, i, :, n:n + S] = kc[i].permute(1, 0, 2)
                vs[li, i, :, n:n + S] = vc[i].permute(1, 0, 2)
            rel = torch.arange(Tm, device=dev)[None, :] - n
            mask[i, 0] = (rel < 0) | ((rel <= r) & (rel < m))
        lib_ms = library_ms(q, ks, vs, mask)
        del ks, vs
        b_ms, b_by = bench.bound(S, sl, nls)
        rows.append(dict(shape=f"pool {name} B={B} S={S} ps={ps} MP={bench.MP} seq_lens={sl} "
                               f"new_lens={nls}",
                         ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         library="SDPA over contiguous copies", bound_ms=b_ms, bound_by=b_by,
                         bq=fa.flash_prefill_bq(NH // KV), max_abs_err=err,
                         deterministic=True, nan_rows_unread=True))
    for r in rows:
        print("kernels: K4 " + json.dumps(r))
    results["flash_paged_prefill"] = dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))


def kernels_k5(params, cfg, dev, rnd, results):
    """K5, the batch-1 attention block, against its plain version at 2B
    shapes: caches of T = 328 (the bench's) and 2048 rows, pos 0, 47 and
    T - 1, layers 0 and 29. Bars: h' within 5% of its largest value and the
    written k/v rows within 3% of theirs (the prologues' variance and the
    scores sum in another order than torch's, so an int8 code can move by
    one, as for K1/K2); every other cache row bitwise unchanged. Its streamed
    qkv and o dots are exact int32 sums and its prologues and epilogues K1's
    arithmetic, so in every case its bf16 qkv row is bitwise K1(h, qkv), h'
    bitwise h + K1(its attention row, o), and a second call bitwise the
    first."""
    import torch

    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.rope import rope_cos_sin
    from wrinklefree_tpu_torch.ops.ternary import unpack_ternary

    st = params["layers"]
    L, H, Q = cfg.num_layers, cfg.hidden_size, cfg.q_dim
    NH, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(q_dim=Q, n_kv=KV, n_heads=NH, head_dim=D, eps=cfg.rms_norm_eps)

    def call(fn, h, ck, cv, layer, pos, cos, sin, **extra):
        return fn(h, ck, cv, st["qkv_qw"], st["o_qw"], layer, pos, st["qkv_scale"],
                  st["o_scale"], st["input_ln"], st["attn_sub"], cos, sin, **kw, **extra)[0]

    wq = [unpack_ternary(st["qkv_qw"][i]).to(torch.bfloat16) for i in range(L)]
    wo = [unpack_ternary(st["o_qw"][i]).to(torch.bfloat16) for i in range(L)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, worst, exact_rows, checks, k1_checks = [], 0.0, 0, 0, 0
    eps = cfg.rms_norm_eps
    for T in (328, 2048):
        ck0, cv0 = rnd(L, 1, T, KV, D), rnd(L, 1, T, KV, D)
        h = rnd(1, H)
        for pos in (0, 47, T - 1):
            cos, sin = rope_cos_sin(torch.tensor([pos], device=dev), D, cfg.rope_theta,
                                    torch.bfloat16)
            cos, sin = cos[0], sin[0]
            p = torch.tensor([pos], dtype=torch.int32, device=dev)
            for layer in (0, L - 1):
                ka, va, kb, vb = ck0.clone(), cv0.clone(), ck0.clone(), cv0.clone()
                s1, s2 = {}, {}
                a = call(tc.attn_block_megakernel, h, ka, va, layer, p, cos, sin, scratch=s1)
                a2 = call(tc.attn_block_megakernel, h, ck0.clone(), cv0.clone(), layer, p, cos,
                          sin, scratch=s2)
                b = call(tc.attn_block_megakernel_plain, h, kb, vb, layer, p, cos, sin)
                want_qkv = tc.ternary_matmul_stacked_fused(h, st["qkv_qw"], layer,
                                                           st["qkv_scale"], st["input_ln"], eps=eps)
                want = h + tc.ternary_matmul_stacked_fused(s1["attn"], st["o_qw"], layer,
                                                           st["o_scale"], st["attn_sub"], eps=eps)
                torch.cuda.synchronize()
                if not (torch.equal(s1["qkv"], want_qkv) and torch.equal(a, want)):
                    fail(f"K5 T={T} pos={pos} layer={layer}: not bitwise the K1 composition "
                         f"(qkv {(s1['qkv'].float() - want_qkv.float()).abs().max().item()}, "
                         f"h' {(a.float() - want.float()).abs().max().item()})")
                if not all(torch.equal(x, y) for x, y in ((a, a2), (s1["qkv"], s2["qkv"]),
                                                          (s1["attn"], s2["attn"]))):
                    fail(f"K5 T={T} pos={pos} layer={layer}: two calls differ")
                k1_checks += 1
                d = (a.float() - b.float()).abs().max().item()
                if not (torch.isfinite(a).all() and d <= 0.05 * b.float().abs().max().item()):
                    fail(f"K5 T={T} pos={pos} layer={layer}: h' differs by {d}")
                keep = torch.ones(L, T, dtype=torch.bool, device=dev)
                keep[layer, pos] = False
                for x, x0, y in ((ka, ck0, kb), (va, cv0, vb)):
                    if not torch.equal(x[:, 0][keep], x0[:, 0][keep]):
                        fail(f"K5 T={T} pos={pos} layer={layer}: a cache row other than pos "
                             "changed")
                    r, s = x[layer, 0, pos].float(), y[layer, 0, pos].float()
                    if not (r - s).abs().max().item() <= 0.03 * s.abs().max().item():
                        fail(f"K5 T={T} pos={pos} layer={layer}: written row differs")
                    exact_rows += bool(torch.equal(r, s))
                worst = max(worst, d)
                checks += 1
        for pos in ((47, T - 1) if T == 328 else (T - 1,)):
            cos, sin = rope_cos_sin(torch.tensor([pos], device=dev), D, cfg.rope_theta,
                                    torch.bfloat16)
            cos, sin = cos[0], sin[0]
            p = torch.tensor([pos], dtype=torch.int32, device=dev)
            lay = Cycle(L)
            ck, cv = ck0.clone(), cv0.clone()
            ms, call_ms = cuda_ms(
                lambda: call(tc.attn_block_megakernel, h, ck, cv, lay(), p, cos, sin))
            plain_ms, _ = cuda_ms(
                lambda: call(tc.attn_block_megakernel_plain, h, ck, cv, lay(), p, cos, sin),
                iters=5, warmup=1)

            def lib():
                i = lay()
                qkv = torch.matmul(h, wq[i])
                q = qkv[:, :Q].reshape(1, NH, 1, D)
                k = ck[i, 0, :pos + 1].permute(1, 0, 2)[None]
                v = cv[i, 0, :pos + 1].permute(1, 0, 2)[None]
                o = sdpa(q, k, v, enable_gqa=True)
                return h + torch.matmul(o.reshape(1, Q), wo[i])

            lib_ms, _ = cuda_ms(lib)
            b_ms, b_by = _block_bytes_ops(st, cfg, pos, mlp=False)
            rows.append(dict(shape=f"attention block T={T} pos={pos}", ms=ms, call_ms=call_ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             library="bf16 matmul qkv + SDPA over pos+1 rows + bf16 matmul o",
                             bound_ms=b_ms, bound_by=b_by))
    del wq, wo
    for r in rows:
        print("kernels: K5 " + json.dumps(r))
    print(f"kernels: K5 {checks} checks, max |h' diff| {worst}, written rows bitwise equal to "
          f"the plain version's {exact_rows}/{2 * checks}; qkv row and h' bitwise the K1 "
          f"composition and across two calls in {k1_checks}/{k1_checks} checks")
    pick = next(r for r in rows if r["shape"].endswith("T=328 pos=327"))
    results["attn_block_megakernel"] = dict(pick, max_abs_err=worst)


def kernels_k6(cfg, dev, results):
    """K6, the paged flash decode, against its plain version at the shapes of
    ``wrinklefree_tpu_torch/bench/flash_decode.py`` (2B attention, page size
    16, 128 pages per slot): 8 slots of 17..2000 tokens, 8 slots of 2000 and
    1 slot of 2000; layers 0 and 29. Bar: 2e-2 absolute (probabilities round
    to bf16 against each warp's running max over its rows of a rank's tiles
    in the kernel, against one max over all committed pages in the plain
    version). At each shape two calls must give the same bits, and with the
    pool pages past each slot's committed span and the staging rows from its
    offset on set to NaN the output must be finite and bitwise equal to the
    run with those rows zero. Each shape prints its time, SDPA's, the bound,
    the split the wrapper picked and the error."""
    import torch

    from wrinklefree_tpu_torch.bench import flash_decode as bench
    from wrinklefree_tpu_torch.ops import cuda_lib
    from wrinklefree_tpu_torch.ops import flash_attention as fa

    L, NH, KV, D, ps, MP = bench.L, bench.NH, bench.KV, bench.D, bench.PS, bench.MP
    if (L, NH, KV, D) != (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim):
        fail("K6: the bench's shapes are not the model's")
    inp = bench.make_inputs(dev, seed=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, worst = [], 0.0
    for name, lens in bench.SHAPES.items():
        (q, kc, vc, main, stage), (pt, sl) = bench.case(inp, lens)
        B = len(lens)
        err = 0.0
        for layer in (0, L - 1):
            a = fa.flash_paged_decode(q, kc, vc, main, stage, layer, pt, sl)
            again = fa.flash_paged_decode(q, kc, vc, main, stage, layer, pt, sl)
            b = fa.flash_paged_decode_plain(q, kc, vc, main, stage, layer, pt, sl)
            torch.cuda.synchronize()
            d = (a.float() - b.float()).abs().max().item()
            if not (torch.isfinite(a).all() and d <= 2e-2):
                fail(f"K6 {name} layer={layer}: max abs error {d}")
            if not torch.equal(a, again):
                fail(f"K6 {name} layer={layer}: two calls differ")
            err = max(err, d)
        # the rows no slot may read: zero, then NaN (on a copy of the pool)
        pm, psg = main.clone(), stage.clone()
        past = [pt[i, n // ps:].long() for i, n in enumerate(lens)]
        outs = {}
        for fill in (0.0, float("nan")):
            for i, n in enumerate(lens):
                pm[past[i]] = fill
                psg[i, n % ps:] = fill
            for layer in (0, L - 1):
                o = fa.flash_paged_decode(q, kc, vc, pm, psg, layer, pt, sl)
                if fill == 0.0:
                    outs[layer] = o
                elif not (torch.isfinite(o).all() and torch.equal(o, outs[layer])):
                    fail(f"K6 {name} layer={layer}: the NaN rows past the valid tokens changed "
                         "the output")
        del pm, psg
        lay = Cycle(L)
        ms, call_ms = cuda_ms(
            lambda: fa.flash_paged_decode(q, kc, vc, main, stage, lay(), pt, sl))
        plain_ms, _ = cuda_ms(
            lambda: fa.flash_paged_decode_plain(q, kc, vc, main, stage, lay(), pt, sl),
            iters=5, warmup=1)
        # the yardstick: SDPA over contiguous copies of the same histories
        # (made untimed; four layers' copies, so repeats miss the 50 MB L2)
        Tm = max(lens) + 1
        n_l = min(4, L)
        ks = torch.zeros((n_l, B, KV, Tm, D), dtype=torch.bfloat16, device=dev)
        vs = torch.zeros_like(ks)
        for li in range(n_l):
            for bi, n in enumerate(lens):
                full, off = n // ps * ps, n % ps
                pages = pt[bi, :full // ps].long()
                kk = main[pages, li].reshape(full, KV, D)
                vv = main[pages, L + li].reshape(full, KV, D)
                ks_ = torch.cat([kk, stage[bi, :off, li].reshape(off, KV, D), kc[bi][None]])
                vs_ = torch.cat([vv, stage[bi, :off, L + li].reshape(off, KV, D), vc[bi][None]])
                ks[li, bi, :, :n + 1] = ks_.permute(1, 0, 2)
                vs[li, bi, :, :n + 1] = vs_.permute(1, 0, 2)
        mask = (torch.arange(Tm, device=dev)[None, :] <= sl[:, None])[:, None, None, :]
        cyc = Cycle(n_l)

        def lib():
            i = cyc()
            return sdpa(q[:, :, None], ks[i], vs[i], attn_mask=mask, enable_gqa=True)

        lib_ms, _ = cuda_ms(lib)
        del ks, vs
        tokens = sum(n + 1 for n in lens)
        b_ms, b_by = bound(bench.nbytes(lens), 4 * NH * D * tokens, "bf16")
        split = fa.flash_decode_split(B, KV, MP * ps, cuda_lib.sm_count(dev))
        rows.append(dict(shape=f"decode {name} B={B} ps={ps} MP={MP} seq_lens={lens}", ms=ms,
                         call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         library="SDPA over contiguous histories", bound_ms=b_ms, bound_by=b_by,
                         split=split, max_abs_err=err, deterministic=True, nan_rows_unread=True))
        worst = max(worst, err)
    for r in rows:
        print("kernels: K6 " + json.dumps(r))
    results["flash_paged_decode"] = dict(rows[0], max_abs_err=worst)


def kernels_k7(params, cfg, dev, g, results):
    """K7, the packed-ternary matmul of quantized codes, against its plain
    version at the MoE path's shapes: stacked with a per-layer scale at
    q/o 2560->2560 and k 2560->640, stacked with per-column scales at the
    fused qkv 2560->3840, one matrix at the experts' gate 2560->6912 and
    down 6912->2560, and the exact int32 mode. Bar: bit for bit (exact
    integer dot, the same IEEE rescale); at every row count 1-8 (the GEMV)
    each shape is checked in bf16, f32 and int32. Each shape cycles over
    enough distinct weight matrices (>= 64 MB) that the weights stream from
    HBM; the library yardstick is a bf16 matmul on unpacked weights, cycled
    the same way, and above 8 rows ``torch._int_mm`` on the signed int8
    weights (in the int32 mode first checked equal to the kernel). At 2-7
    rows only the kernel is timed."""
    import torch

    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.ternary import unpack_ternary

    H, I, Q, KVD = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, cfg.kv_dim

    def stack(k, n, min_bytes=64e6):
        nl = max(8, math.ceil(min_bytes / (k // 4 * n)))
        return torch.randint(0, 256, (nl, k // 4, n), generator=g, device=dev, dtype=torch.uint8)

    def library(qw, k, n):  # bf16 [K, N] and signed int8 [N, K] (K-major)
        nl = min(qw.shape[0], max(2, math.ceil(64e6 / (k * n * 2))))
        ws = [unpack_ternary(qw[i]).to(torch.bfloat16) for i in range(nl)]
        return ws, [w.to(torch.int8).t().contiguous() for w in ws]

    st = params["layers"]
    gemv_rows = tuple(range(1, 9))
    cases = [  # name, weights, scales ([L], [L, N] or None: one matrix), rows, mode
        ("q", (H, Q), "layer", (*gemv_rows, 64, 512), "bf16"),
        ("k", (H, KVD), "layer", (*gemv_rows, 64, 512), "bf16"),
        ("o", (Q, H), "layer", (*gemv_rows, 64, 512), "bf16"),
        ("qkv", None, "column", (*gemv_rows, 512), "bf16"),
        ("expert gate", (H, I), "matrix", (*gemv_rows, 64, 512), "bf16"),
        ("expert down", (I, H), "matrix", (*gemv_rows, 64, 512), "bf16"),
        ("q int32", (H, Q), "matrix", (8, 512), "int32"),
    ]
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    rows_out, mid, checks = [], [], 0
    for name, dims, scale, all_rows, mode in cases:
        if dims is None:  # the engine's fused stack and its column scales
            qw, sw = st["qkv_qw"], st["qkv_scale"]
        else:
            qw = stack(*dims)
            sw = torch.rand((qw.shape[0],), generator=g, device=dev) * 80 + 10
        nl, k4, n = qw.shape
        k = 4 * k4
        lib_w, lib_i = library(qw, k, n)
        for rows in all_rows:
            xq = torch.randint(-128, 128, (rows, k), generator=g, device=dev, dtype=torch.int8)
            sx = torch.rand((rows, 1), generator=g, device=dev) * 60 + 0.5
            lay, lib_lay = Cycle(nl), Cycle(len(lib_w))

            def args_of(m):  # the call's arguments in mode m, for weights i
                if m == "int32":
                    return tc.ternary_matmul, tc.ternary_matmul_plain, lambda i: (xq, qw[i])
                kw = dict(out_dtype=dtypes[m])
                if scale == "matrix":
                    return (lambda *a: tc.ternary_matmul(*a, **kw),
                            lambda *a: tc.ternary_matmul_plain(*a, **kw),
                            lambda i: (xq, qw[i], sx, sw[i]))
                return (lambda *a: tc.ternary_matmul_stacked(*a, **kw),
                        lambda *a: tc.ternary_matmul_stacked_plain(*a, **kw),
                        lambda i: (xq, qw, i, sx, sw))

            for m in ("bf16", "f32", "int32") if rows <= 8 and mode == "bf16" else (mode,):
                ker, pla, args = args_of(m)
                for i in (0, nl - 1):
                    a, b = ker(*args(i)), pla(*args(i))
                    torch.cuda.synchronize()
                    if not torch.equal(a, b):
                        fail(f"K7 {name} {m} rows={rows} weights {i}: kernel and plain version "
                             f"differ by {(a.float() - b.float()).abs().max().item()}")
                    checks += 1
            ker, pla, args = args_of(mode)
            ms, call_ms = cuda_ms(lambda: ker(*args(lay())))
            out_bytes = 4 if mode == "int32" else 2
            sw_bytes = 0 if mode == "int32" else (n * 4 if scale == "column" else 4)
            nbytes = rows * k + (0 if mode == "int32" else rows * 4) + k4 * n + sw_bytes \
                + rows * n * out_bytes
            b_ms, b_by = bound(nbytes, 2 * rows * k * n, "int8")
            shape = f"{name} {k}->{n} ({scale} scale, {mode}) rows={rows}"
            if 1 < rows < 8:
                mid.append(dict(shape=shape, ms=ms, bound_ms=b_ms))
                continue
            plain_ms, _ = cuda_ms(lambda: pla(*args(lay())), iters=5, warmup=1)
            xb = torch.randn((rows, k), generator=g, device=dev).to(torch.bfloat16)
            lib_ms, _ = cuda_ms(lambda: torch.matmul(xb, lib_w[lib_lay()]))
            lib = dict(library_ms=lib_ms)
            if rows > 8:  # the int8 yardstick, the exact int32 dot of the same codes
                if mode == "int32" and not torch.equal(ker(*args(0)),
                                                       torch._int_mm(xq, lib_i[0].t())):
                    fail(f"K7 {name} rows={rows}: torch._int_mm is not the function timed")
                int_ms, _ = cuda_ms(lambda: torch._int_mm(xq, lib_i[lib_lay()].t()))
                lib = dict(library_ms=int_ms, library_bf16_ms=lib_ms, library=INT_MM,
                           tc_share=tc_share(2 * rows * k * n, ms))
            rows_out.append(dict(shape=shape, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0, **lib))
        del qw, lib_w, lib_i
    for r in rows_out + mid:
        print("kernels: K7 " + json.dumps(r))
    print(f"kernels: K7 bitwise equal to its plain version in {checks}/{checks} checks (rows 1-8 "
          "in bf16, f32 and int32 at every shape)")
    # the MoE decode step's most frequent launch: an expert dot at 8 rows
    results["ternary_matmul_stacked"] = next(
        r for r in rows_out if r["shape"].startswith("expert gate") and r["shape"].endswith("=8"))
    results["ternary_matmul_stacked/tiled"] = next(
        r for r in rows_out if r["shape"].startswith("expert gate") and r["shape"].endswith("=512"))


def _layer_library(cfg, wls, h, ck, cv, lay, pos, attn=True, mlp=True):
    """The library yardstick of the attention and/or MLP block: bf16 matmuls
    on unpacked weights, SDPA over the cache rows 0..pos, relu^2."""
    import torch

    Q, NH, D, I = cfg.q_dim, cfg.num_heads, cfg.head_dim, cfg.intermediate_size
    sdpa = torch.nn.functional.scaled_dot_product_attention
    i = lay()
    if attn:
        qkv = torch.matmul(h, wls["qkv"][i])
        q = qkv[:, :Q].reshape(1, NH, 1, D)
        k = ck[i, 0, :pos + 1].permute(1, 0, 2)[None]
        v = cv[i, 0, :pos + 1].permute(1, 0, 2)[None]
        h = h + torch.matmul(sdpa(q, k, v, enable_gqa=True).reshape(1, Q), wls["o"][i])
    if mlp:
        gu = torch.matmul(h, wls["gateup"][i])
        h = h + torch.matmul(torch.square(torch.relu(gu[:, :I])) * gu[:, I:], wls["down"][i])
    return h


def _block_bytes_ops(st, cfg, pos, attn=True, mlp=True, rows=1):
    """Bytes a block must move (packed weights, scales, norms, its input and
    output rows, cos/sin and cache rows 0..pos once) and its operations
    (int8 dots; bf16 scores and PV)."""
    H, Q, I, NH, KV, D = (cfg.hidden_size, cfg.q_dim, cfg.intermediate_size, cfg.num_heads,
                          cfg.num_kv_heads, cfg.head_dim)
    nbytes, int8_ops, bf16_ops = rows * H * 2 * 2, 0, 0
    if attn:
        n_q = st["qkv_qw"].shape[2]
        nbytes += (H // 4 * n_q + Q // 4 * H + (n_q + H) * 4 + (H + Q) * 2 + 2 * D * 2
                   + 2 * (pos + 1) * KV * D * 2)
        int8_ops += 2 * (H * n_q + Q * H)
        bf16_ops += 4 * NH * D * (pos + 1)
    if mlp:
        nbytes += H // 4 * 2 * I + I // 4 * H + (2 * I + H) * 4 + (H + I) * 2
        int8_ops += 2 * rows * (H * 2 * I + I * H)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (int8_ops / PEAK_OPS["int8"] + bf16_ops / PEAK_OPS["bf16"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_k8_static(params, cfg, dev, rnd, results):
    """K8, the whole batch-1 decode layer, against its plain version (the
    plain K5 then the plain K2, with the reference's per-KV-head softmax)
    at 2B shapes: T 328 at pos 47 and 327, T 2048 at pos 2047, layers 0 and
    29. K5's and K2's bars: the written k/v rows bitwise equal, every other
    cache row unchanged, h' within 5% of each row's largest value (the
    prologues' reductions run in another order than torch's, so an int8 code
    can move by one). K8 runs K5's body then K2's: its h' (the attention
    half's output) is bitwise K5's and its output bitwise K2 of that h'.
    The static wrappers (row 9) launch K5 and K2 on one layer's views:
    bitwise equal to K5 and K2 on the stack, the MLP also at 12 rows (two K2
    launches)."""
    import torch

    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.rope import rope_cos_sin
    from wrinklefree_tpu_torch.ops.ternary import unpack_ternary

    st = params["layers"]
    L, H = cfg.num_layers, cfg.hidden_size
    KV, D = cfg.num_kv_heads, cfg.head_dim
    kw = dict(q_dim=cfg.q_dim, n_kv=KV, n_heads=cfg.num_heads, head_dim=D, eps=cfg.rms_norm_eps)
    w8 = [st[n] for n in ("qkv_qw", "o_qw", "gateup_qw", "down_qw")]
    s8 = [st[n] for n in ("qkv_scale", "o_scale", "gateup_scale", "down_scale", "input_ln",
                          "attn_sub", "post_ln", "ffn_sub")]

    def k8(fn, h, ck, cv, layer, p, cos, sin, **extra):
        return fn(h, ck, cv, *w8, layer, p, *s8, cos, sin, **kw, **extra)[0]

    def k5_static(h, ck, cv, layer, p, cos, sin, fn=tc.attn_block_megakernel_static):
        return fn(h, ck[layer], cv[layer], st["qkv_qw"][layer], st["o_qw"][layer], p,
                  st["qkv_scale"][layer], st["o_scale"][layer], st["input_ln"][layer],
                  st["attn_sub"][layer], cos, sin, **kw)[0]

    def k2_static(h, layer, fn=tc.mlp_block_megakernel_static):
        return fn(h, st["gateup_qw"][layer], st["down_qw"][layer], st["gateup_scale"][layer],
                  st["down_scale"][layer], st["post_ln"][layer], st["ffn_sub"][layer])

    wls = {n: [unpack_ternary(st[n + "_qw"][i]).to(torch.bfloat16) for i in range(L)]
           for n in ("qkv", "o", "gateup", "down")}
    rows8, rows_s, worst, checks, k8_checks = [], [], 0.0, 0, 0
    for T in (328, 2048):
        ck0, cv0 = rnd(L, 1, T, KV, D), rnd(L, 1, T, KV, D)
        h = rnd(1, H)
        for pos in ((47, T - 1) if T == 328 else (T - 1,)):
            cos, sin = rope_cos_sin(torch.tensor([pos], device=dev), D, cfg.rope_theta,
                                    torch.bfloat16)
            cos, sin = cos[0], sin[0]
            p = torch.tensor([pos], dtype=torch.int32, device=dev)
            for layer in (0, L - 1):
                ka, va, kb, vb = ck0.clone(), cv0.clone(), ck0.clone(), cv0.clone()
                s8k = {}
                a = a8 = k8(tc.layer_block_megakernel, h, ka, va, layer, p, cos, sin,
                            scratch=s8k)
                a_k2 = tc.mlp_block_megakernel(s8k["h1"], *w8[2:], layer, *s8[2:4], *s8[6:],
                                               eps=cfg.rms_norm_eps)
                b = k8(tc.layer_block_megakernel_plain, h, kb, vb, layer, p, cos, sin)
                torch.cuda.synchronize()
                d = (a.float() - b.float()).abs().max().item()
                if not (torch.isfinite(a).all() and d <= 0.05 * b.float().abs().max().item()):
                    fail(f"K8 T={T} pos={pos} layer={layer}: h' differs by {d}")
                if not (torch.equal(ka, kb) and torch.equal(va, vb)):
                    fail(f"K8 T={T} pos={pos} layer={layer}: the caches differ from the plain "
                         "version's")
                keep = torch.ones(L, T, dtype=torch.bool, device=dev)
                keep[layer, pos] = False
                if not (torch.equal(ka[:, 0][keep], ck0[:, 0][keep])
                        and torch.equal(va[:, 0][keep], cv0[:, 0][keep])):
                    fail(f"K8 T={T} pos={pos} layer={layer}: a cache row other than pos changed")
                worst = max(worst, d)
                # row 9: the static attention block against K5 on the same inputs
                kc, vc, kd, vd = ck0.clone(), cv0.clone(), ck0.clone(), cv0.clone()
                a = k5_static(h, kc, vc, layer, p, cos, sin)
                b = tc.attn_block_megakernel(h, kd, vd, *w8[:2], layer, p, st["qkv_scale"],
                                             st["o_scale"], st["input_ln"], st["attn_sub"], cos,
                                             sin, **kw)[0]
                torch.cuda.synchronize()
                if not (torch.equal(a, b) and torch.equal(kc, kd) and torch.equal(vc, vd)):
                    fail(f"static attention T={T} pos={pos} layer={layer}: differs from K5")
                # K8's attention half is K5's body, its MLP half K2's
                if not (torch.equal(s8k["h1"], b) and torch.equal(a8, a_k2)):
                    fail(f"K8 T={T} pos={pos} layer={layer}: h' not bitwise K5's or the output "
                         "not bitwise K2(h')")
                checks += 1
                k8_checks += 1
            lay = Cycle(L)
            ck, cv = ck0.clone(), cv0.clone()
            ms, call_ms = cuda_ms(lambda: k8(tc.layer_block_megakernel, h, ck, cv, lay(), p, cos,
                                             sin))
            plain_ms, _ = cuda_ms(lambda: k8(tc.layer_block_megakernel_plain, h, ck, cv, lay(), p,
                                             cos, sin), iters=5, warmup=1)
            lib_ms, _ = cuda_ms(lambda: _layer_library(cfg, wls, h, ck, cv, lay, pos))
            b_ms, b_by = _block_bytes_ops(st, cfg, pos)
            rows8.append(dict(shape=f"decode layer T={T} pos={pos}", ms=ms, call_ms=call_ms,
                              plain_ms=plain_ms, library_ms=lib_ms,
                              library="K5's and K2's library calls", bound_ms=b_ms,
                              bound_by=b_by))
            if T == 328 and pos == T - 1:  # the bench's shape
                ms, call_ms = cuda_ms(lambda: k5_static(h, ck, cv, lay(), p, cos, sin))
                plain_ms, _ = cuda_ms(lambda: k5_static(
                    h, ck, cv, lay(), p, cos, sin, tc.attn_block_megakernel_static_plain),
                    iters=5, warmup=1)
                lib_ms, _ = cuda_ms(lambda: _layer_library(cfg, wls, h, ck, cv, lay, pos,
                                                           mlp=False))
                b_ms, b_by = _block_bytes_ops(st, cfg, pos, mlp=False)
                rows_s.append(("attn_block_megakernel_static", dict(
                    shape=f"attention block, one layer's views, T={T} pos={pos}", ms=ms,
                    call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                    bound_by=b_by, max_abs_err=0.0)))
    for rows in (1, 12):
        x = rnd(rows, H)
        for layer in (0, L - 1):
            a = k2_static(x, layer)
            b = torch.cat([tc.mlp_block_megakernel(
                x[r:r + 8], st["gateup_qw"], st["down_qw"], layer, st["gateup_scale"],
                st["down_scale"], st["post_ln"], st["ffn_sub"]) for r in range(0, rows, 8)])
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"static MLP rows={rows} layer={layer}: differs from K2")
            checks += 1
        lay = Cycle(L)
        ms, call_ms = cuda_ms(lambda: k2_static(x, lay()))
        plain_ms, _ = cuda_ms(lambda: k2_static(x, lay(), tc.mlp_block_megakernel_static_plain),
                              iters=5, warmup=1)
        lib_ms, _ = cuda_ms(lambda: _layer_library(cfg, wls, x, None, None, lay, 0,
                                                   attn=False))
        b_ms, b_by = _block_bytes_ops(st, cfg, 0, attn=False, rows=rows)
        rows_s.append(("mlp_block_megakernel_static", dict(
            shape=f"MLP block, one layer's views, rows={rows}", ms=ms, call_ms=call_ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=0.0)))
    del wls
    for r in rows8:
        print("kernels: K8 " + json.dumps(r))
    for name, r in rows_s:
        print(f"kernels: {name} " + json.dumps(r))
    print(f"kernels: K8 {len(rows8) * 2} checks, max |h' diff| {worst}, caches bitwise equal to the "
          f"plain version's; h' bitwise K5's and the output bitwise K2(h') in "
          f"{k8_checks}/{k8_checks} checks; static wrappers bitwise equal to K5/K2 in "
          f"{checks}/{checks} checks")
    results["layer_block_megakernel"] = dict(
        next(r for r in rows8 if r["shape"].endswith("T=328 pos=327")), max_abs_err=worst)
    for name, r in rows_s:
        results.setdefault(name, r)  # the bench's shapes: T 328 pos 327, one row


def kernels_k9(cfg, dev, g, results):
    """K9, the causal flash prefill, against its plain version at BitNet-2B
    heads (20/5 of 128): S 512 over T 512, and S 512 over T 1024 at q_offset
    128, in bf16 and f32. The kernel walks 64-key tiles whatever the blocks,
    so its plain version is held with 64-key blocks (the same running maxima
    where p is rounded): f32 within 2e-5 (FMA sums in another order), bf16
    within 2e-2 (a bf16 ulp of p or of the output)."""
    import torch

    from wrinklefree_tpu_torch.ops import flash_attention as fa

    NH, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out, worst = [], {}
    for dt, kind, tol in ((torch.bfloat16, "bf16", 2e-2), (torch.float32, "f32", 2e-5)):
        for S, T, off in ((512, 512, 0), (512, 1024, 128)):
            q = torch.randn((1, S, NH, D), generator=g, device=dev).to(dt)
            k = torch.randn((1, T, KV, D), generator=g, device=dev).to(dt)
            v = torch.randn((1, T, KV, D), generator=g, device=dev).to(dt)
            a = fa.flash_prefill(q, k, v, off)
            b = fa.flash_prefill_plain(q, k, v, off, block_k=64)
            torch.cuda.synchronize()
            d = (a.float() - b.float()).abs().max().item()
            if not (torch.isfinite(a).all() and d <= tol):
                fail(f"K9 {kind} S={S} T={T} q_offset={off}: max abs error {d}")
            worst[kind] = max(worst.get(kind, 0.0), d)
            ms, call_ms = cuda_ms(lambda: fa.flash_prefill(q, k, v, off))
            plain_ms, _ = cuda_ms(lambda: fa.flash_prefill_plain(q, k, v, off), iters=5, warmup=1)
            mask = (torch.arange(T, device=dev)[None, :]
                    <= off + torch.arange(S, device=dev)[:, None])
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib_ms, _ = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
            pairs = sum(min(T, off + s + 1) for s in range(S))  # visible (query, key) pairs
            keys = min(T, off + S)
            nbytes = (2 * S * NH * D + 2 * keys * KV * D) * q.element_size() + 4
            b_ms, b_by = bound(nbytes, 4 * D * pairs * NH, kind)
            out.append(dict(shape=f"{kind} S={S} T={T} q_offset={off} NH={NH} KV={KV} D={D}",
                            ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                            library="SDPA with the causal mask, enable_gqa", bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=d))
    for r in out:
        print("kernels: K9 " + json.dumps(r))
    results["flash_prefill"] = dict(out[0], max_abs_err=worst["bf16"])


def kernels_k10(dev, results):
    """K10, the stream touch, against its plain version on the calibration's
    own weights (the 2B MLP's int8 [30, 640, 13824] and [30, 1728, 2560]):
    output and checksum bit for bit (exact integer sums), layers 0 and 29.
    Timed cycling over the 30 layers (398 MB, so each call streams from
    HBM); the library yardstick is one int32 sum over each layer's bytes."""
    import torch

    from wrinklefree_tpu_torch.bench import calibrate as cal

    gw, dw = cal.stream_weights(dev)
    L = gw.shape[0]
    h = torch.randn((8, 128), device=dev)
    for layer in (0, L - 1):
        ca = torch.zeros(1, dtype=torch.int64, device=dev)
        cb = torch.zeros(1, dtype=torch.int64, device=dev)
        a = cal.touch(h, gw, dw, layer, ca)
        b = cal.touch_plain(h, gw, dw, layer, cb)
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(ca, cb)):
            fail(f"K10 layer={layer}: kernel and plain version differ")
    lay = Cycle(L)
    cs = torch.zeros(1, dtype=torch.int64, device=dev)
    ms, call_ms = cuda_ms(lambda: cal.touch(h, gw, dw, lay(), cs))
    plain_ms, _ = cuda_ms(lambda: cal.touch_plain(h, gw, dw, lay(), cs), iters=5, warmup=1)

    def lib():
        i = lay()
        return gw[i].view(torch.int32).sum() + dw[i].view(torch.int32).sum()

    lib_ms, _ = cuda_ms(lib)
    layer_bytes = gw[0].numel() + dw[0].numel()
    b_ms, b_by = bound(layer_bytes + 2 * 8 * 128 * 4 + 8, 0, "f32")
    r = dict(shape=f"one layer's packed MLP weights, {layer_bytes / 1e6} MB", ms=ms,
             call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
             library="int32 sums over the layer's bytes", bound_ms=b_ms, bound_by=b_by,
             max_abs_err=0.0)
    print("kernels: K10 " + json.dumps(r))
    results["measure_stream_us_per_layer"] = r


def _prefill_attention_p_rounded(q, k_cur, v_cur, main, staging_b, layer, page_table,
                                 seq_lens, new_lens, cfg):
    """Plain causal attention of a first prefill chunk (empty history) that
    rounds the unnormalized probabilities to bf16 before the PV product, as
    the flash kernel does, instead of the normalized ones as the plain
    softmax does. Only the rounding point differs from the plain path: the
    logit difference it causes is the noise floor of the forward check."""
    import torch

    if bool((seq_lens != 0).any()):
        fail("the noise-floor attention takes a first chunk only")
    B, S, NH, D = q.shape
    KV = k_cur.shape[2]
    G = NH // KV
    qs = (q * torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype, device=q.device)).float()
    s = torch.einsum("bskgd,btkd->bkgst", qs.reshape(B, S, KV, G, D), k_cur.float())
    i = torch.arange(S, device=q.device)
    ok = (i[None, :] <= i[:, None])[None] & (i[None, None, :] < new_lens[:, None, None])
    s = s.masked_fill(~ok[:, None, None], -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bkgst,btkd->bskgd", p.to(torch.bfloat16).float(), v_cur.float())
    o = o / p.sum(-1, keepdim=True).permute(0, 3, 1, 2, 4)
    return o.reshape(B, S, NH, D).to(q.dtype)


def phase_forward(params, cfg, dev):
    """paged_forward through the kernels vs through the plain functions.

    The int8 activation quantization of every linear turns bf16-level
    differences into whole code steps, so at full width the logits move
    measurably with nothing but the point where attention probabilities are
    rounded. The script measures that noise floor in the same run (the plain
    path with the flash kernel's rounding point, at the prefill step) and
    holds the kernels to max(6e-2, 3 x floor) at 2 layers. Over 30
    random-weight layers the differences grow chaotically, so at full depth
    it reports them without a bar. Returns the noise floor by depth."""
    from wrinklefree_tpu_torch.kv.paged import _paged_attention_dual
    from wrinklefree_tpu_torch.ops import kv_update_cuda as kvu
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc

    plain = dict(
        linear_fn=tc.make_linear_fused(tc.ternary_matmul_stacked_fused_plain,
                                       tc.mlp_block_megakernel_plain),
        attention_fn=_paged_attention_dual, kv_write=kvu.kv_write_plain)
    floors = {}
    for depth in (2, cfg.num_layers):
        floors[depth] = kernels_vs_plain("forward", params, cfg, dev, depth, plain)
    return floors


def paged_run(p, c, dev, kw, forced=None, steps=5):
    """paged_forward on one slot: a 128-token prefill chunk (seed 2), then
    decode steps fed with `forced` (or the run's own argmax); the logits of
    every step."""
    import torch

    from wrinklefree_tpu_torch.kv.paged import PagedKV, paged_forward

    g = torch.Generator(device="cpu").manual_seed(2)
    prompt = torch.randint(1, c.vocab_size, (1, 128), generator=g).to(dev)
    pt = torch.arange(1, 17, dtype=torch.int32, device=dev)[None]
    slot = torch.zeros(1, dtype=torch.int32, device=dev)
    pools = PagedKV.zeros_dual(c, 32, 16, 1, device=dev)
    tok, sl, out = prompt, 0, []
    for step in range(steps):
        n = tok.shape[1]
        logits, pools = paged_forward(
            p, c, tok, pools, pt, torch.tensor([sl], device=dev),
            torch.tensor([n], device=dev), slot_ids=slot, **kw)
        out.append(logits.float())
        sl += n
        nxt = torch.argmax(logits, -1) if forced is None else forced[step]
        tok = nxt.reshape(1, 1)
    return out


def kernels_vs_plain(what, params, cfg, dev, depth, plain):
    """paged_forward through the kernels (the defaults) and through `plain`
    at `depth` layers, with the noise floor of the same run (see
    phase_forward); returns the floor."""
    import dataclasses

    import torch

    c = dataclasses.replace(cfg, num_layers=depth)
    p = dict(params, layers={k: v[:depth] for k, v in params["layers"].items()})
    ker = paged_run(p, c, dev, {})
    pla = paged_run(p, c, dev, plain, forced=[torch.argmax(x, -1) for x in ker])
    alt = paged_run(p, c, dev, dict(plain, attention_fn=_prefill_attention_p_rounded), steps=1)
    floor = (alt[0] - pla[0]).abs().max().item()
    worst, agree, bar, ties = compare_logits(what, ker, pla, depth, floor)
    print(f"{what}: {depth} layers at full width, 128-token prefill + 4 decode steps, "
          f"kernels vs plain: max |logit diff| {worst}, noise floor {floor}, "
          f"argmax equal at {agree}/5 steps"
          + (f", bar {bar}, ties {json.dumps(ties)}" if depth == 2 else " (no bar)"))
    return floor


def compare_logits(what, ker, pla, depth, floor):
    """The kernels' logits against the plain path's, step by step: at 2
    layers within max(6e-2, 3 x the noise floor) with any argmax change at a
    top-2 gap below twice the difference; deeper, reported only. Returns
    (max |difference|, steps with equal argmax, bar, ties)."""
    import torch

    bar = max(6e-2, 3 * floor)
    worst, ties, agree = 0.0, [], 0
    for step, (a, b) in enumerate(zip(ker, pla)):
        if not torch.isfinite(a).all():
            fail(f"{what} depth {depth} step {step}: non-finite logits")
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        ia, ib = int(a.argmax()), int(b.argmax())
        agree += ia == ib
        if depth != 2:
            continue
        if err > bar:
            fail(f"{what} step {step}: logits differ by {err} (bar {bar})")
        if ia != ib:
            top2 = torch.topk(b[0], 2).values
            gap = (top2[0] - top2[1]).item()
            if gap > 2 * err:
                fail(f"{what} step {step}: argmax {ia} vs {ib} with top-2 gap {gap}")
            ties.append(dict(step=step, kernels=ia, plain=ib, top2_gap=gap))
    return worst, agree, bar, ties


def phase_prefill(params, cfg, dev):
    """One 512-token prefill chunk of ``paged_forward`` (the engine's
    largest bucket) at full width and depth, under the profiler: its device
    ms, the share of it in K1 (``k1_prologue`` and the tensor-core GEMM,
    four K1 calls per layer) and K4's ms, which must be exactly one launch
    per layer (reading the history from the pool). Returns the device ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wrinklefree_tpu_torch.kv.paged import PagedKV, paged_forward
    from wrinklefree_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cpu").manual_seed(4)
    prompt = torch.randint(1, cfg.vocab_size, (1, 512), generator=g).to(dev)
    pt = torch.arange(1, 33, dtype=torch.int32, device=dev)[None]
    pools = PagedKV.zeros_dual(cfg, 40, 16, 1, device=dev)
    slot = torch.zeros(1, dtype=torch.int32, device=dev)
    seq, n_new = torch.tensor([0], device=dev), torch.tensor([512], device=dev)

    def chunk():
        return paged_forward(params, cfg, prompt, pools, pt, seq, n_new, slot_ids=slot)[0]

    logits = chunk()
    torch.cuda.synchronize()
    if not torch.isfinite(logits).all():
        fail("prefill: non-finite logits")
    fa.flash_paged_prefill.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chunk()
        torch.cuda.synchronize()
    k4_launches = fa.flash_paged_prefill.launches
    if k4_launches != cfg.num_layers:
        fail(f"prefill: {k4_launches} K4 launches in a {cfg.num_layers}-layer chunk")
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.device_time_total for e in evs) / 1e3
    k1 = sum(e.device_time_total for e in evs
             if "k1_prologue" in e.key or "k_ternary_gemm" in e.key) / 1e3
    k4 = sum(e.device_time_total for e in evs if "k4_prefill" in e.key) / 1e3
    if not (total > 0 and k1 > 0 and k4 > 0):
        fail(f"prefill: no device time recorded for the chunk or its K1/K4 calls "
             f"({total}, {k1}, {k4})")
    top = sorted(evs, key=lambda e: -e.device_time_total)[:6]
    print(f"prefill: one 512-token chunk of paged_forward, {cfg.num_layers} layers at full width: "
          f"{total} ms of device time, K1 (prologue + tensor-core GEMM) {k1} ms ({k1 / total} of "
          f"it), K4 {k4} ms in {k4_launches} launches (3.23 ms before K4 read the pool, PERF.md "
          "section 5); device ms by kernel: "
          + json.dumps({e.key[:60]: e.device_time_total / 1e3 for e in top}))
    return total


BATCH1_MODES = {  # bench.decode's modes -> the kernels each launches once per layer and token
    "default": ("attn_block_megakernel", "mlp_block_megakernel"),
    "split": ("attn_block_megakernel_static", "mlp_block_megakernel_static"),
    "layer_mega": ("layer_block_megakernel",),
}


def phase_batch1(qparams, cfg, dev, floors, counters):
    """The batch-1 path of ``wrinklefree_tpu_torch.bench.decode`` on the
    dense cache (T = 64 + 4 * 64 + 8 = 328, as the bench's), in its three
    modes: ``default`` (K5 then K2 per layer), ``split`` (the unrolled loop
    over ``split_layers_for_decode``'s per-layer views: the static wrappers)
    and ``layer_mega`` (K8 per layer):

    - at 2 and 30 layers, per mode, a 64-token prefill and 8 greedy decode
      steps through the kernels, then teacher-forced through the plain
      functions; logits compared under phase_forward's noise-floor rule.
      ``split`` runs the default's kernels on the same bytes: its logits must
      equal the default run's bit for bit. ``layer_mega`` (teacher-forced
      with the default's tokens) is reported bitwise equal to the default,
      or held to the noise-floor rule against it;
    - at 30 layers, per mode, the prefill and 64 greedy steps through the
      exact head (int8 scan + top-64 rescore), whose token must equal the
      argmax of the bf16 head every step, with the mode's kernels launched
      once per layer and step and the other batch-1 kernels not at all
      (counters zeroed just before); ``split``'s tokens equal the default's;
    - per mode, the bench itself (warm window, best of 3 windows of 64
      steps) and the device's busy share over one window under the profiler.
    Returns the launches of each mode's counted run."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wrinklefree_tpu_torch.bench import decode as bd
    from wrinklefree_tpu_torch.models.bitnet import (
        KVCache, compute_logits, forward, greedy_exact_topk, split_layers_for_decode)
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc

    prompt_len, steps = 64, 64
    T = prompt_len + 4 * steps + 8
    g = torch.Generator(device="cpu").manual_seed(3)
    prompt = torch.randint(1, cfg.vocab_size, (1, prompt_len), generator=g).to(dev)

    def linear_fns(mode):
        """(the kernels' linear_fn, the plain functions' linear_fn) of a mode."""
        mega = mode == "layer_mega"
        plain = tc.make_linear_fused(
            tc.ternary_matmul_stacked_fused_plain, tc.mlp_block_megakernel_plain,
            tc.attn_block_megakernel_plain, layer=tc.layer_block_megakernel_plain,
            attn_static=tc.attn_block_megakernel_static_plain,
            mlp_static=tc.mlp_block_megakernel_static_plain, layer_mega=mega)
        return tc.make_linear_fused(layer_mega=mega), plain

    def mode_params(p, c, mode):
        return split_layers_for_decode(p, c) if mode == "split" else p

    def logits_run(p, c, lf, forced=None, n=8):
        cache = KVCache.zeros(c, 1, T, device=dev)
        lo, cache = forward(p, c, prompt, cache, torch.zeros(1, dtype=torch.int32, device=dev),
                            linear_fn=lf, logits_all=False)
        out, pos = [lo.float()], torch.full((1,), prompt_len, dtype=torch.int32, device=dev)
        for step in range(n):
            tok = (torch.argmax(lo, -1) if forced is None else forced[step]).reshape(1, 1)
            lo, cache = forward(p, c, tok, cache, pos, linear_fn=lf, logits_all=False)
            out.append(lo.float())
            pos = pos + 1
        return out

    for depth in (2, cfg.num_layers):
        c = dataclasses.replace(cfg, num_layers=depth)
        p = dict(qparams, layers={k: v[:depth] for k, v in qparams["layers"].items()})
        runs, default_toks = {}, None
        for mode in BATCH1_MODES:
            klf, plf = linear_fns(mode)
            pm = mode_params(p, c, mode)
            ker = logits_run(pm, c, klf, forced=default_toks if mode == "layer_mega" else None)
            toks = [torch.argmax(x, -1) for x in ker[:-1]]
            default_toks = default_toks or toks
            pla = logits_run(pm, c, plf, forced=toks)
            worst, agree, bar, ties = compare_logits(f"batch1 {mode}", ker, pla, depth,
                                                     floors[depth])
            print(f"batch1 {mode}: {depth} layers, 64-token prefill + 8 decode steps, kernels vs "
                  f"plain: max |logit diff| {worst} (noise floor {floors[depth]}), argmax equal "
                  f"at {agree}/9 steps"
                  + (f", bar {bar}, ties {json.dumps(ties)}" if depth == 2 else " (no bar)"))
            runs[mode] = ker
        if not all(torch.equal(a, b) for a, b in zip(runs["split"], runs["default"])):
            fail(f"batch1 split at {depth} layers: logits differ from the default run's")
        print(f"batch1 split: {depth} layers: logits bitwise equal to the default run's at 9/9 "
              "steps")
        if all(torch.equal(a, b) for a, b in zip(runs["layer_mega"], runs["default"])):
            print(f"batch1 layer_mega: {depth} layers: logits bitwise equal to the default "
                  "run's at 9/9 steps")
        else:
            worst, agree, bar, ties = compare_logits("batch1 layer_mega vs default",
                                                     runs["layer_mega"], runs["default"], depth,
                                                     floors[depth])
            print(f"batch1 layer_mega: {depth} layers: logits not bitwise equal to the default "
                  f"run's (teacher-forced): max |logit diff| {worst}, argmax equal at {agree}/9 "
                  "steps, under the noise-floor rule"
                  + (f" (bar {bar}, ties {json.dumps(ties)})" if depth == 2 else " (no bar)"))

    # the exact head against the bf16 head, every step; launch counts
    clean = {k: v for k, v in qparams.items() if not k.startswith("lm_head_")}
    launches, states, mode_toks = {}, {}, {}
    for mode, kernels in BATCH1_MODES.items():
        klf, _ = linear_fns(mode)
        pm = mode_params(qparams, cfg, mode)
        checks = []

        def checked_head(hidden, p):
            tok, _ = greedy_exact_topk(hidden, p, cfg, k=bd.EXACT_HEAD_K)
            checks.append(tok == torch.argmax(compute_logits(hidden, clean, cfg), -1))
            return tok[:, None]

        tok, cache = bd.prefill(pm, cfg, klf, prompt, T)
        pos = torch.full((1,), prompt_len, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        for cnt in counters:
            cnt.launches = 0
        toks, tok, cache, pos = bd.decode_window(pm, cfg, klf, tok, cache, pos, steps,
                                                 checked_head)
        torch.cuda.synchronize()
        launches[mode] = {cnt.__name__: cnt.launches for cnt in counters}
        states[mode] = (pm, klf, tok, cache, pos)
        mode_toks[mode] = toks
        if not bool(torch.cat(checks).all()):
            bad = [i for i, x in enumerate(checks) if not bool(x.all())]
            fail(f"batch1 {mode}: the exact head's token differs from the bf16 head's argmax at "
                 f"steps {bad}")
        for name, n in launches[mode].items():
            want = cfg.num_layers * steps if name in kernels else 0
            if n != want:
                fail(f"batch1 {mode}: {name} launched {n} times in {steps} decode steps, "
                     f"expected {want}")
        if not all(0 <= t < cfg.vocab_size for t in toks.tolist()):
            fail(f"batch1 {mode}: token id out of vocabulary")
        per_step = {k: v / steps for k, v in launches[mode].items()}
        print(f"batch1 {mode}: {cfg.num_layers} layers, 64-token prefill + {steps} greedy steps: "
              f"exact head == bf16 argmax at {len(checks)}/{steps} steps, launches per decode "
              f"step {json.dumps(per_step)}")
    if not torch.equal(mode_toks["split"], mode_toks["default"]):
        fail("batch1 split: the 64 greedy tokens differ from the default run's")
    same = next((i for i, (a, b) in enumerate(zip(mode_toks["layer_mega"].tolist(),
                                                  mode_toks["default"].tolist())) if a != b), steps)
    print(f"batch1: split's {steps} greedy tokens equal the default's; layer_mega's equal the "
          f"default's on the first {same}/{steps}")

    head = bd.exact_head(cfg)
    for mode in BATCH1_MODES:
        res = bd.run("bitnet2b", prompt_len, steps, dev, split=mode == "split",
                     layer_mega=mode == "layer_mega")
        print("batch1: bench " + json.dumps(res))
        # device busy share over one more window, under the profiler
        pm, klf, tok, cache, pos = states[mode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, tok, cache, pos = bd.decode_window(pm, cfg, klf, tok, cache, pos, steps, head)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_s = sum(e.device_time_total for e in evs) / 1e6
        top = sorted(evs, key=lambda e: -e.device_time_total)[:8]
        print(f"batch1 {mode}: {res['value']} tok/s, {res['ms_per_token']} ms per token (bench); "
              f"{dev_s / steps * 1e3} ms of device time per token, "
              f"{dev_s / steps * 1e3 / res['ms_per_token']} of the bench's token; device busy "
              f"{dev_s / dt} of {dt} s under the profiler; device ms per token by kernel: "
              + json.dumps({e.key[:60]: e.device_time_total / 1e3 / steps for e in top}))
    return launches


def phase_calibrate(dev):
    """``bench.calibrate.calibrate()``: its JSON line, with K10's launches
    counted over it (the wrapper's calls, each graph's chain recorded once at
    capture and replayed), then the device's busy share of a replayed window
    of 512 touches, which must be at least 90% (else the slope would time
    the host): ``stream_busy_share``'s statistic, the median over five
    traced replays of the kernels' busy time over the same replay's device
    span. Returns K10's launches."""
    from wrinklefree_tpu_torch.bench import calibrate as cal

    cal.touch.launches = 0
    stamp = cal.calibrate(dev)
    launches = cal.touch.launches
    print("calibrate: " + json.dumps(stamp))
    busy, dev_s, span = cal.stream_busy_share(512, dev)
    print(f"calibrate: device busy {busy} of a replayed 512-touch window (the median of 5 traced "
          f"replays: {dev_s} s of kernel time in a {span} s device span); K10 launched "
          f"{launches} times through its wrapper")
    if busy < 0.9:
        fail(f"calibrate: the device was busy {busy} of the stream window (< 0.9)")
    if stamp["stream_us_per_layer"] is None or not stamp["stream_us_per_layer"] > 0:
        fail(f"calibrate: no stream measurement ({stamp})")
    return launches


def phase_engine(params, cfg, dev, counters, flash_decode=False, tag=None, idle=(),
                 per_step_exact=None, resubmit=True, step_ref=None, kernel_refs=None):
    """The engine phase; with ``flash_decode`` the decode attention runs the
    paged flash decode kernel. Every counter in ``counters`` must launch and
    every one in ``idle`` must not (all zeroed just before the six requests,
    read after the resubmissions); ``per_step_exact`` ({name: n}) holds every
    decode-only step of the six requests, and the decode window on average,
    to exactly n launches;
    ``resubmit=False`` skips the two radix resubmissions; ``step_ref`` is
    the device ms per decode step of the same window in the reference run
    (PERF.md section 5), printed beside this run's, and ``kernel_refs``
    ({kernel name: ms}) the same for single kernels. Returns (launches, the six
    requests' tokens)."""
    import numpy as np
    import torch

    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams

    ecfg = EngineConfig(max_batch_slots=8, page_size=16, num_pages=1024, max_context=2048,
                        prefill_buckets=(32, 128, 512), flash_decode=flash_decode)
    tag = tag or ("engine (flash_decode)" if flash_decode else "engine")
    eng = Engine(params, cfg, ecfg, device=dev)
    rng = np.random.default_rng(0)
    lens = (17, 64, 200, 333, 512, 700)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    sp = SamplingParams(max_new_tokens=32, temperature=0.0)

    for c in (*counters, *idle):
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, sp) for p in prompts]
    per_step, decode_only = None, []
    while any(not r.finished for r in reqs):
        before = (eng.stats.get("prefill_rounds", 0), eng.stats["decode_steps"],
                  [c.launches for c in counters])
        eng.step()
        steps = eng.stats["decode_steps"] - before[1]
        if eng.stats.get("prefill_rounds", 0) == before[0] and steps:
            step_rate = {c.__name__: (c.launches - n0) / steps  # a decode-only step
                         for c, n0 in zip(counters, before[2])}
            decode_only.append(step_rate)
            per_step = per_step or step_rate
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hit0 = eng.stats["radix_hit_tokens"]
    again = [eng.generate(prompts[-1], sp) for _ in range(2 if resubmit else 0)]
    launches = {c.__name__: c.launches for c in counters}
    busy = {c.__name__: c.launches for c in idle if c.launches}
    if busy:
        fail(f"{tag}: kernels off this path launched: {json.dumps(busy)}")
    for name, n in (per_step_exact or {}).items():
        seen = sorted({r[name] for r in decode_only})
        if not decode_only or seen != [n]:
            fail(f"{tag}: {name} launched {seen} times per decode step, expected {n}")
        print(f"{tag}: {name} launched exactly {n} times in each of {len(decode_only)} "
              "decode-only steps")

    for p, r in zip(prompts + [prompts[-1]] * len(again), reqs + again):
        if r.finish_reason != "length" or len(r.output_ids) != 32:
            fail(f"request of {len(p)} tokens finished {r.finish_reason!r} "
                 f"with {len(r.output_ids)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output_ids):
            fail("token id out of vocabulary")
    resubmitted = ""
    if again:
        if eng.stats["radix_hit_tokens"] < hit0 + 2 * 688:
            fail("the resubmitted prompts did not reuse the 43 cached pages of the prompt")
        # Two resubmissions run the same computation (688 cached tokens, a
        # 12-token suffix): identical tokens. Against the first submission,
        # which prefilled the same 700 tokens as chunks of 512 and 188
        # through the flash kernel, the suffix goes through the plain
        # attention path; on random weights that moves the logits by about
        # the forward phase's noise floor, so the agreement is reported, not
        # required.
        if again[0].output_ids != again[1].output_ids:
            fail("two radix resubmissions of one prompt gave different tokens")
        agree = next((i for i, (a, b) in enumerate(zip(again[0].output_ids,
                                                          reqs[-1].output_ids)) if a != b), 32)
        resubmitted = (f" + 2 radix resubmissions (radix hit tokens "
                       f"{eng.stats['radix_hit_tokens'] - hit0}, resubmission agrees with the "
                       f"first submission on its first {agree}/32 tokens)")
    if not (torch.isfinite(eng.pools.kv).all() and torch.isfinite(eng.pools.staging).all()):
        fail("non-finite values in the KV pools")
    zero = [n for n, v in launches.items() if v == 0]
    if zero:
        fail(f"kernels not launched on the engine path: {zero}")
    ttft = sorted(r.first_token_t - r.arrival_t for r in reqs)
    p50 = float(np.percentile(ttft, 50))
    print(f"{tag}: 6 requests{resubmitted}, wall {wall} s, TTFT p50 {p50} s, "
          f"launches per decode step {json.dumps(per_step)}, launches {json.dumps(launches)}")

    # decode window: all 8 slots busy with 17-token prompts; after the first
    # step (admission, one prefill round, one burst) every step is a decode
    # burst. Timed once plain and once under the profiler for the device's
    # busy share.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for profiled in (False, True):
        batch = [eng.submit(rng.integers(1, cfg.vocab_size, 17).tolist(),
                            SamplingParams(max_new_tokens=49, temperature=0.0))
                 for _ in range(8)]
        eng.step()
        torch.cuda.synchronize()
        tok0, steps0 = eng.stats["decode_tokens"], eng.stats["decode_steps"]
        n0 = {c.__name__: c.launches for c in counters}
        t1 = time.perf_counter()
        if profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                while any(not r.finished for r in batch):
                    eng.step()
                torch.cuda.synchronize()
        else:
            while any(not r.finished for r in batch):
                eng.step()
            torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        steps = eng.stats["decode_steps"] - steps0
        if profiled:
            evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            sum_s = sum(e.device_time_total for e in evs) / 1e6
            dev_s = busy_us(device_events(prof)) / 1e6
            top = sorted(evs, key=lambda e: -e.device_time_total)[:8]
            # K1 at <= 8 rows is k1_prologue + the GEMV; K7 the GEMV alone
            dot = sum(e.device_time_total for e in evs
                      if "k1_prologue" in e.key or "k_ternary_gemv" in e.key) / 1e6
            print(f"{tag}: decode window under the profiler, device busy {dev_s / dt} of "
                  f"{dt} s ({dev_s / steps * 1e3} ms of device time per decode step, "
                  f"{step_ref} ms in the reference run; kernel durations summed "
                  f"{sum_s / steps * 1e3} ms); the <= 8-row K1/K7 kernels "
                  f"(k1_prologue, k_ternary_gemv) {dot / steps * 1e3} ms per decode step "
                  f"({dot / sum_s} of the summed durations); "
                  "device ms per decode step by kernel: " + json.dumps(
                      {e.key[:60]: e.device_time_total / 1e3 / steps for e in top}))
            for name, ref in (kernel_refs or {}).items():
                ms = sum(e.device_time_total for e in evs if name in e.key) / 1e3 / steps
                print(f"{tag}: {name} {ms} ms per decode step ({ref} ms in the reference run)")
        else:
            print(f"{tag}: decode window, 8 slots: "
                  f"{(eng.stats['decode_tokens'] - tok0) / dt} tok/s, {dt / steps * 1e3} ms "
                  f"per decode step ({steps} steps)")
            for name, n in (per_step_exact or {}).items():
                got = (next(c.launches for c in counters if c.__name__ == name)
                       - n0[name]) / steps
                if got != n:
                    fail(f"{tag}: {name} launched {got} times per decode step in the window, "
                         f"expected {n}")
    return launches, [r.output_ids for r in reqs]


def routed_run(p, c, dev, kw, forced=None, steps=5, replay=None):
    """paged_run on an MoE model that also records each call's routing (the
    expert ids of ``models.moe.top_k_route``, one call per layer and step).
    With ``replay`` (another run's record) the run takes those expert ids,
    weighted by its own router's renormalised probabilities: the routing is
    teacher-forced, as `forced` forces the tokens."""
    import torch

    from wrinklefree_tpu_torch.models import moe

    orig, log = moe.top_k_route, []

    def recorded(logits, k, **kw_route):
        if replay is None:
            w, i = orig(logits, k, **kw_route)
        else:
            i = replay[len(log)]
            w = torch.softmax(logits.float(), dim=-1).gather(-1, i.long())
            w = w / w.sum(dim=-1, keepdim=True)
        log.append(i)
        return w, i

    moe.top_k_route = recorded
    try:
        out = paged_run(p, c, dev, kw, forced, steps)
    finally:
        moe.top_k_route = orig
    return out, log


def moe_kernels_vs_plain(params, cfg, dev, depth, plain):
    """The MoE model's paged_forward through the kernels (K7, K4 at the
    prefill chunk, K3) against, teacher-forced with the kernels' tokens:

    - plain linears with the kernels' attention and KV writes: K7 is exact,
      so the logits must be equal bit for bit at every step;
    - the plain functions throughout, with the kernels' expert choices
      replayed, under phase_forward's noise-floor rule. Top-k routing is
      discontinuous: the bf16-level difference of K4's prefill rounding
      flips expert choices at router near-ties, after which the two runs
      compute different experts. How soon the plain run's own routing
      leaves the kernels' is reported. Deeper than 2 layers only the first
      check runs.""" 
    import dataclasses

    import torch

    c = dataclasses.replace(cfg, num_layers=depth)
    p = dict(params, layers={k: v[:depth] for k, v in params["layers"].items()})
    ker, routes = routed_run(p, c, dev, {})
    forced = [torch.argmax(x, -1) for x in ker]
    mix, _ = routed_run(p, c, dev, {"linear_fn": plain["linear_fn"]}, forced=forced)
    for step, (a, b) in enumerate(zip(ker, mix)):
        if not torch.equal(a, b):
            fail(f"moe depth {depth} step {step}: K7 and the plain linears give logits "
                 f"{(a - b).abs().max().item()} apart")
    if depth != 2:
        print(f"moe: {depth} layers, 128-token prefill + 4 decode steps: kernels equal to plain "
              f"linears bit for bit at {len(ker)}/{len(ker)} steps")
        return
    pla, _ = routed_run(p, c, dev, plain, forced=forced, replay=routes)
    alt, _ = routed_run(p, c, dev, dict(plain, attention_fn=_prefill_attention_p_rounded),
                        steps=1, replay=routes)
    floor = (alt[0] - pla[0]).abs().max().item()
    worst, agree, bar, ties = compare_logits("moe", ker, pla, depth, floor)
    free, free_routes = routed_run(p, c, dev, plain, forced=forced)
    moved = [i for i, (x, y) in enumerate(zip(routes, free_routes)) if not torch.equal(x, y)]
    first = moved[0] if moved else None
    print(f"moe: {depth} layers, 128-token prefill + 4 decode steps: kernels equal to plain "
          f"linears bit for bit at {len(ker)}/{len(ker)} steps; against the plain functions "
          f"with the kernels' routing: max |logit diff| {worst}, noise floor {floor}, argmax "
          f"equal at {agree}/5 steps, bar {bar}, ties {json.dumps(ties)}; unforced, the plain "
          f"run's routing leaves the kernels' at router call {first} of {len(routes)} (step "
          f"{None if first is None else first // depth}) and its logits differ by up to "
          f"{max((a - b).abs().max().item() for a, b in zip(ker, free))}")


def phase_moe(dev):
    """The repo's MoE configuration (``scripts/serving_bench.py --model
    moe``): BitNet-2B geometry at 8 layers with 8 ternary experts and top-2
    routing, random weights drawn on the card from seed 0. Unfused q/k/v/o
    run the stacked K7 linear, the experts K7 on one matrix each.

    1. paged_forward through the kernels against the plain linears (bit for
       bit) and against the plain functions (moe_kernels_vs_plain), at 2
       and 8 layers;
    2. the fake-MoE oracle: the dense 8-layer model and the fake-MoE model
       built from its weights (8 identical experts, a zero router), both
       through the K7 path: logits equal bit for bit at every step;
    3. the engine phase on the MoE model: K7 (its prefills through the
       tensor-core GEMM), K3 and K4 launch, K1 and K2 do not, and K7 launches
       exactly (4 + 3 E) L times per decode step.
    Returns the engine's launches."""
    import dataclasses

    import torch

    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.kv.paged import _paged_attention_dual
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.models.moe import fake_moe_model
    from wrinklefree_tpu_torch.ops import flash_attention as fa
    from wrinklefree_tpu_torch.ops import kv_update_cuda as kvu
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc

    cfg = dataclasses.replace(BitNetConfig.bitnet_2b(), num_layers=8, num_experts=8,
                              num_experts_per_tok=2)
    params = init_params(cfg, seed=0, device=dev)
    packed = sum(v.numel() for k, v in params["layers"].items() if k.endswith("_qw"))
    print(f"moe: {cfg.num_layers} layers, {cfg.num_experts} experts, top-{cfg.num_experts_per_tok}:"
          f" {packed / 1e9} GB of packed ternary weights")
    plain_lf = tc.make_linear_stacked(tc.ternary_matmul_stacked_plain, tc.ternary_matmul_plain)
    plain = dict(linear_fn=plain_lf, attention_fn=_paged_attention_dual,
                 kv_write=kvu.kv_write_plain)
    for depth in (2, cfg.num_layers):
        moe_kernels_vs_plain(params, cfg, dev, depth, plain)

    dcfg = dataclasses.replace(cfg, num_experts=0)
    dense = init_params(dcfg, seed=1, device=dev)
    mcfg, fake = fake_moe_model(dense, dcfg, cfg.num_experts)
    lf = {"linear_fn": tc.make_linear_stacked()}
    a = paged_run(dense, dcfg, dev, lf)
    b = paged_run(fake, mcfg, dev, lf, forced=[torch.argmax(x, -1) for x in a])
    for step, (x, y) in enumerate(zip(a, b)):
        if not (torch.isfinite(x).all() and torch.equal(x, y)):
            fail(f"moe: the fake-MoE model differs from the dense model at step {step} by "
                 f"{(x - y).abs().max().item()}")
    print(f"moe: fake-MoE oracle, {cfg.num_layers} layers, 128-token prefill + 4 decode steps: "
          f"logits bitwise equal to the dense model's at {len(a)}/{len(a)} steps")
    del dense, fake, a, b

    per_step = (4 + 3 * cfg.num_experts) * cfg.num_layers
    launches, _ = phase_engine(
        params, cfg, dev, [tc.ternary_matmul_stacked, TiledCounter(tc.ternary_matmul_stacked),
                           kvu.kv_write, fa.flash_paged_prefill],
        tag="moe engine", idle=[tc.ternary_matmul_stacked_fused, tc.mlp_block_megakernel],
        per_step_exact={"ternary_matmul_stacked": per_step}, resubmit=False, step_ref=10.82)
    return launches


def main() -> int:
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from wrinklefree_tpu_torch.config import BitNetConfig
        from wrinklefree_tpu_torch.models.bitnet import (
            fuse_projections, init_params, quantize_lm_head)
        from wrinklefree_tpu_torch.ops import cuda_lib
        from wrinklefree_tpu_torch.ops import flash_attention as fa
        from wrinklefree_tpu_torch.ops import kv_update_cuda as kvu
        from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {here}: {e}", file=sys.stderr)
        return 2

    secs = cuda_lib.timed_build()
    report = cuda_lib.BUILD_DIR / "ptxas.txt"
    per = ([line[3:] for line in report.read_text().splitlines() if line.startswith("== ")]
           if report.exists() else [])
    print(f"build: {secs} s ({cuda_lib.build()}); per source: {', '.join(per)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    dev = torch.device("cuda")
    print(f"profiler: device activity recorded from session {start_profiler(dev)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BitNetConfig.bitnet_2b()
    params = fuse_projections(init_params(cfg, seed=0, device=dev), cfg)
    torch.cuda.synchronize()

    results = {}
    phase_kernels(params, cfg, dev, results)
    floors = phase_forward(params, cfg, dev)
    phase_prefill(params, cfg, dev)
    # the batch-1 path reads the int8 head (its exact head scans it); the
    # engine's params keep the bf16 head only
    flash_prefill_launches = fa.flash_prefill.launches  # it has no path: the kernels phase's
    batch1 = phase_batch1(quantize_lm_head(params, cfg), cfg, dev, floors,
                          [tc.attn_block_megakernel, tc.mlp_block_megakernel,
                           tc.ternary_matmul_stacked_fused, tc.layer_block_megakernel,
                           tc.attn_block_megakernel_static, tc.mlp_block_megakernel_static])
    serving = [tc.ternary_matmul_stacked_fused, TiledCounter(tc.ternary_matmul_stacked_fused),
               tc.mlp_block_megakernel, kvu.kv_write, fa.flash_paged_prefill]
    # the two windows' device ms per decode step in the reference run
    # (PERF.md section 5); the flash_decode window also K6's
    launches, toks = phase_engine(params, cfg, dev, serving, step_ref=5.23,
                                  kernel_refs={"k2_mlp": 0.92})
    flash, ftoks = phase_engine(params, cfg, dev, serving + [fa.flash_paged_decode],
                                flash_decode=True, step_ref=2.82,
                                per_step_exact={"flash_paged_decode": cfg.num_layers},
                                kernel_refs={"k6_decode": 0.17, "k2_mlp": 0.91})
    same = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
            for x, y in zip(toks, ftoks)]
    print(f"engine: flash_decode=True beside the default run: leading tokens equal per request "
          f"{same} of 32 (prompts 17/64/200/333/512/700)")
    for mode, kernels in BATCH1_MODES.items():
        for name in kernels:
            launches.setdefault(name, batch1[mode][name])
    launches["flash_paged_decode"] = flash["flash_paged_decode"]
    launches["flash_prefill"] = flash_prefill_launches
    del params
    torch.cuda.empty_cache()
    moe = phase_moe(dev)
    launches["ternary_matmul_stacked"] = moe["ternary_matmul_stacked"]
    launches["ternary_matmul_stacked/tiled"] = moe["ternary_matmul_stacked/tiled"]
    launches["measure_stream_us_per_layer"] = phase_calibrate(dev)

    line = []
    for name, meta in KERNELS.items():
        r = results[name]
        line.append({
            "name": name, "route": "cuda", **meta, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            **({"library": r["library"]} if "library" in r else {}),
        })
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
