#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wrinklefree_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``wrinklefree_tpu_torch/csrc`` and runs fifteen phases at
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
               contiguous keys and over the pool (checked likewise), K4 and
               K6 again on fp16 and f32 pools (their FMA instantiations), and
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
               layer and step; the bench's window captured in a CUDA graph
               from the same start state: its tokens and cache equal the
               eager window's, the capture records the mode's kernels 30 x 64
               times and the other batch-1 kernels never, and a window with a
               one-candidate shortlist repairs to the same tokens; then the
               bench (the captured window), the eager window timed beside
               it, and the device's busy share per mode;
5. engine    — ``Engine``: six greedy requests (prompts of 17..700 tokens,
               32 new tokens each) and two radix-cache resubmissions, every
               serving kernel's launch counter growing (K1's GEMM in the
               prefills: ``tiled_launches``); then the six
               requests again with ``flash_decode=True``, whose decode
               attention kernel must launch once per layer and decode step;
6. preempt   — retraction on a dry KV pool: eight 200-token prompts x 64
               greedy tokens on 8 slots, page size 16, decode bursts of 20,
               a 137-page pool (admits all eight, dry at the top-up of each
               request's fourth burst) beside a roomy one: at least one
               retraction, every request finished by length, each request's
               streamed tokens equal to its output ids, every request never
               retracted equal to the roomy run, the serving kernels launched;
7. features  — the request features on the engine phase's configuration:
               counter-keyed draws on the card bit-equal to the CPU's; a
               logprobs request (top-1 = emitted token, the same tokens as
               without logprobs) and the logprobs decode window beside the
               plain one; json_mode, GBNF and json_schema requests (valid
               text; ms per constrained token); a seeded mirostat request
               equal alone and beside three others; a snapshot after two
               bursts of six requests restored on a fresh engine to the
               uninterrupted run's tokens; the serving kernels launched in
               every variant;
8. heads_kv  — the engine phase's configuration and prompts under the exact
               head (streams = the bf16 head's or a near-tie of it; sampled and
               penalised rows = the default engine's; device ms and
               certificate failures per decode step beside the plain burst),
               ``int8_logits`` (tokens = the int8 head's argmax), the native
               host runtime (= the Python classes: tokens, radix hits,
               retractions), int8/fp8 pools on both layouts (stored bytes =
               ``quantize_kv`` of the bf16 rows; decode logits cosine >= 0.998
               for int8 and fp8_e4m3; K3, K4 and K6 never launched), the
               token-major layout (K3's writes bit-equal, K4's contiguous form
               30 times a 512-token chunk and within its bar; streams = the
               layer layout's or a near-tie), fp16 and f32 pools (the layer
               layout with ``flash_decode``: K3, K4 and K6 launched; the token
               layout: K3 and K4's contiguous form; streams = the bf16 runs'
               or a near-tie) and the window (>= max_context:
               the full attention's tokens or a near-tie; 256 tokens on
               700-token prompts, pages gathered per step);
9. spec      — speculative decoding (k 4, bursts of 16) beside plain bursts
               on eight greedy requests: on the o/down-zeroed weights the
               spec streams equal the plain ones and drafts are accepted,
               the tokens match the spec counters, the verify launches K1's
               GEMM and K3; on the full weights every parting is a near-tie
               within the decode-against-verify bound; a batch-1
               ``spec_decode_window`` launches K1 at 5 rows and K2; device
               ms and wall per burst step of both;
10. sparsity — a 512-token prefill ``forward`` under activation sparsity
               with each attention mode: K7's logits bit-equal to the plain
               linear's, K7 launched;
11. load     — seed-made 2B params written as an HF directory, its packed
               cache (``convert_and_save``) and its i2_s GGUF
               (``convert_hf_to_gguf``), each loaded onto the card bit-equal
               to the in-memory params (the GGUF against their f16 round
               trip, its storage of norms and embedding), an ``Engine`` on
               each giving the in-memory params' greedy tokens for prompts of
               17 and 512 tokens with K1, K2, K3 and K4 launched; each
               format's bytes, write and load seconds;
12. server   — the port's HTTP server (``create_server("synth:bitnet_2b")``
               with the engine phase's configuration) on a free 127.0.0.1
               port, driven by the port's client: health, models, the
               tokenizer round trip, a greedy completion whose token ids equal
               ``Engine.generate``'s, the same request streamed (the same
               text), a chat completion, a stop string, an embedding of unit
               norm, /metrics, a logprobs chat request answered 200 and
               ``run_server_benchmark`` (16 requests at concurrency 8), every
               serving kernel launched;
13. serving  — ``bench.serving`` (the port of scripts/serving_bench.py) at
               16 streams x 128 + 32 tokens on 8 slots: its JSON line, no
               build or new program inside its measured window;
14. moe      — the repo's MoE configuration (8 layers, 8 experts, top-2) on
               the unfused stacked linear and K7 experts: kernels vs plain,
               the fake-MoE oracle bit for bit against the dense model, and
               the engine phase with K7's launches per decode step counted;
15. calibrate — ``bench.calibrate.calibrate()`` (the stream-touch kernel
               chained in CUDA graphs) and the device's busy share of its
               window (median of 5 traced replays, kernel time over the same
               replay's device span), at least 90%.

It exits non-zero on any failure (nothing is caught, nothing falls back)
and when CUDA or the package is missing. The line before the last is a
JSON object with each kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
# published dense peaks: tensor cores for int8, bf16, fp16 and TF32, CUDA
# cores for f32
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "f32": 67e12}

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
    # K3 and K4 on the token-major layout (the heads_kv phase): K3 writes one
    # [2L, KV*D] row per token into the pool, as the reference's token-major
    # pool does (kv/paged.py :1090); K4's contiguous form attends over the
    # gathered history ++ chunk (its _paged_attention_flash, :482)
    "kv_write/token": {
        "source": "wrinklefree_tpu_torch/csrc/kv_write.cu",
        "replaces": "wrinklefree_tpu/ops/kv_update_pallas.py:57",
        "also_replaces": "wrinklefree_tpu/ops/kv_update_pallas.py:96",
    },
    "flash_paged_prefill/contiguous": {
        "source": "wrinklefree_tpu_torch/csrc/flash_paged_prefill.cu",
        "replaces": "wrinklefree_tpu/ops/flash_attention.py:219",
    },
    # K4 and K6 on fp16 and f32 pools (the heads_kv phase's engines): their
    # FMA instantiations (k4_wide, k6_wide); K4's pool form on the layer
    # layout, its contiguous form on the token layout
    **{f"{name}/{dt}": {"source": f"wrinklefree_tpu_torch/csrc/{src}",
                        "replaces": f"wrinklefree_tpu/ops/flash_attention.py:{line}"}
       for dt in ("fp16", "f32")
       for name, src, line in (("flash_paged_prefill", "flash_paged_prefill.cu", 219),
                               ("flash_paged_prefill/contiguous", "flash_paged_prefill.cu", 219),
                               ("flash_paged_decode", "flash_decode.cu", 382))},
}


# the unquantized pool types K4 and K6 take (their bars: flash_attention.POOL_BARS)
POOL_TYPES = ("bf16", "fp16", "f32")


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
    # an empty window (CUPTI can drop a session, see start_profiler) is
    # profiled again after start_profiler's warm-up, up to five times, before
    # that counts as a failure
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev_us = busy_us(device_events(prof))
        if dev_us > 0:
            break
        start_profiler(torch.device("cuda"))
    else:
        fail("torch.profiler recorded no device time")
    return dev_us / 1e3 / iters, call_ms


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms per call of fn: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times between two CUDA events (no host launch
    overhead and no profiler; the graph's gaps between kernels count)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # outside the capture: first-use allocations
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


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


def bound(nbytes: float, ops, kind: str = ""):
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over the memory
    rate and ``ops`` over the ``kind`` peak; ``ops`` may instead map kinds to
    their operations, which then add up in time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = ops if isinstance(ops, dict) else {kind: ops}
    t_ops = sum(n / PEAK_OPS[k] * 1e3 for k, n in ops.items() if n)
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

    for pool in POOL_TYPES:
        kernels_k4(cfg, dev, results, pool)
    kernels_k5(params, cfg, dev, rnd, results)
    for pool in POOL_TYPES:
        kernels_k6(cfg, dev, results, pool)
    kernels_k7(params, cfg, dev, g, results)
    kernels_k8_static(params, cfg, dev, rnd, results)
    kernels_k9(cfg, dev, g, results)
    kernels_k10(dev, results)


def kernels_k4(cfg, dev, results, pool="bf16"):
    """K4, the paged flash prefill, against its plain versions at the shapes
    of ``wrinklefree_tpu_torch/bench/flash_prefill.py`` (2B attention) on a
    pool of type ``pool`` (bf16 on the tensor cores; fp16 and f32 on FMAs, q,
    the chunk and the output of the pool's type too): over contiguous keys
    (a 512-token chunk over a 512-slot history, kv_valid 400, new_len 500:
    the kernels phase's first K4 shape) and over the pool at the engine's
    widest table (page size 16, 128 pages per row): one row of a 512-token
    chunk after 1024 tokens, and four rows of 128-token chunks after
    0/320/1024/1904 tokens; pool shapes at layers 0 and 29. Bar
    (``POOL_BARS``) on the real query rows: 3e-2 absolute in bf16 and fp16
    (the kernel rounds probabilities to the pool's type against its running
    max, the plain softmax after normalization), 2e-5 in f32 (nothing
    rounds; the f32 sums' order differs). At each shape two calls must give
    the same bits, and with NaN in every row the kernel may not read
    (history from kv_valid or seq_lens on, chunk keys from new_len on) the
    real rows must be finite and bitwise equal to the run with zeros there.
    Each shape prints its time, SDPA's over contiguous copies, the plain
    version's, the bound, the query tokens per block and the error."""
    import torch

    from wrinklefree_tpu_torch.bench import flash_prefill as bench
    from wrinklefree_tpu_torch.ops import flash_attention as fa

    L, NH, KV, D, ps = bench.L, bench.NH, bench.KV, bench.D, bench.PS
    if (L, NH, KV, D) != (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim):
        fail("K4: the bench's shapes are not the model's")
    inp = bench.make_inputs(dev, seed=1, pool=pool)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bar = fa.POOL_BARS[pool]["k4"]
    bq = (fa.flash_prefill_bq if pool == "bf16" else fa.flash_prefill_wide_bq)(NH // KV)
    tag = "" if pool == "bf16" else f" {pool}"

    def checked(name, run, plain, poisoned, new_lens):
        """Max abs error of run() against plain() on the real rows, after
        the determinism and poison checks."""
        name += tag
        a, again, b = run(), run(), plain()
        torch.cuda.synchronize()
        oks, errs, _ = zip(*(fa.meets_pool_bar(a[i, :n], b[i, :n], "k4", pool)
                             for i, n in enumerate(new_lens)))
        err = max(errs)
        if not (all(torch.isfinite(a[i, :n]).all() for i, n in enumerate(new_lens))
                and all(oks)):
            fail(f"K4 {name}: max abs error {err} (bar {bar})")
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
    b_ms, b_by = bench.bound(S, [c["kv_valid"]], [c["new_len"]], pool)
    rows.append(dict(shape=f"contiguous S={S} T={T} kv_valid={c['kv_valid']} "
                           f"new_len={c['new_len']} NH={NH} KV={KV} pool={pool}",
                     ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                     library="SDPA", bound_ms=b_ms, bound_by=b_by,
                     bq=bq, max_abs_err=err, deterministic=True, nan_rows_unread=True))
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
        ks = torch.zeros((n_l, B, KV, Tm, D), dtype=main.dtype, device=dev)
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
        b_ms, b_by = bench.bound(S, sl, nls, pool)
        rows.append(dict(shape=f"pool {name} B={B} S={S} ps={ps} MP={bench.MP} seq_lens={sl} "
                               f"new_lens={nls} pool={pool}",
                         ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         library="SDPA over contiguous copies", bound_ms=b_ms, bound_by=b_by,
                         bq=bq, max_abs_err=err, deterministic=True, nan_rows_unread=True))
    for r in rows:
        print("kernels: K4 " + json.dumps(r))
    if pool == "bf16":
        results["flash_paged_prefill"] = dict(rows[0],
                                              max_abs_err=max(r["max_abs_err"] for r in rows))
    else:  # the pool form at the engine's mixed rows, and the contiguous form
        results[f"flash_paged_prefill/{pool}"] = dict(
            rows[2], max_abs_err=max(r["max_abs_err"] for r in rows[1:]))
        results[f"flash_paged_prefill/contiguous/{pool}"] = rows[0]


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


def kernels_k6(cfg, dev, results, pool="bf16"):
    """K6, the paged flash decode, against its plain version at the shapes of
    ``wrinklefree_tpu_torch/bench/flash_decode.py`` (2B attention, page size
    16, 128 pages per slot) on a pool of type ``pool`` (the query and current
    token bf16): 8 slots of 17..2000 tokens, 8 slots of 2000 and 1 slot of
    2000; layers 0 and 29. Bar (``POOL_BARS``, ``meets_pool_bar``): 2e-2
    absolute in bf16, 3e-2 in fp16 (probabilities round to the pool's type
    against each warp's running max over its rows of a rank's tiles in the
    kernel, against one max over all committed pages in the plain version);
    2e-5 in f32, plus one bf16 step of the value (at most 2^-7 of it: both
    round an f32 result to the bf16 output), with ``K6_F32_EQUAL_SHARE`` of
    the output bitwise equal and the rest one step apart or within 2e-5; on
    f32 the kernel over the pool rounded to bf16 (what a bf16 read of it
    would give) must fail that bar. At each shape two calls must give the
    same bits, and with the pool pages past each slot's committed span and
    the staging rows from its offset on set to NaN the output must be finite
    and bitwise equal to the run with those rows zero. Each shape prints its
    time, SDPA's, the bound, the split the wrapper picked, the error and the
    bitwise equal share."""
    import torch

    from wrinklefree_tpu_torch.bench import flash_decode as bench
    from wrinklefree_tpu_torch.ops import cuda_lib
    from wrinklefree_tpu_torch.ops import flash_attention as fa

    L, NH, KV, D, ps, MP = bench.L, bench.NH, bench.KV, bench.D, bench.PS, bench.MP
    if (L, NH, KV, D) != (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim):
        fail("K6: the bench's shapes are not the model's")
    inp = bench.make_inputs(dev, seed=1, pool=pool)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bar = fa.POOL_BARS[pool]["k6"]
    tag = "" if pool == "bf16" else f" {pool}"
    rows, worst = [], 0.0
    for name, lens in bench.SHAPES.items():
        (q, kc, vc, main, stage), (pt, sl) = bench.case(inp, lens)
        B = len(lens)
        err, equal_share, bf16_read = 0.0, 1.0, 0.0
        rounded = [t.bfloat16().float() for t in (main, stage)] if pool == "f32" else None
        for layer in (0, L - 1):
            a = fa.flash_paged_decode(q, kc, vc, main, stage, layer, pt, sl)
            again = fa.flash_paged_decode(q, kc, vc, main, stage, layer, pt, sl)
            b = fa.flash_paged_decode_plain(q, kc, vc, main, stage, layer, pt, sl)
            torch.cuda.synchronize()
            ok, d, share = fa.meets_pool_bar(a, b, "k6", pool)
            if not (torch.isfinite(a).all() and ok):
                fail(f"K6{tag} {name} layer={layer}: max abs error {d}, {share} bitwise "
                     f"equal (bar {bar})")
            if not torch.equal(a, again):
                fail(f"K6{tag} {name} layer={layer}: two calls differ")
            err, equal_share = max(err, d), min(equal_share, share)
            if pool == "f32":
                r16 = fa.flash_paged_decode(q, kc, vc, *rounded, layer, pt, sl)
                ok16, d16, share16 = fa.meets_pool_bar(r16, b, "k6", pool)
                if ok16:
                    fail(f"K6{tag} {name} layer={layer}: the bar passes the kernel over a "
                         "bf16-rounded pool")
                bf16_read = max(bf16_read, share16)
        del rounded
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
                    fail(f"K6{tag} {name} layer={layer}: the NaN rows past the valid tokens "
                         "changed the output")
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
        ks = torch.zeros((n_l, B, KV, Tm, D), dtype=main.dtype, device=dev)
        vs = torch.zeros_like(ks)
        for li in range(n_l):
            for bi, n in enumerate(lens):
                full, off = n // ps * ps, n % ps
                pages = pt[bi, :full // ps].long()
                kk = main[pages, li].reshape(full, KV, D)
                vv = main[pages, L + li].reshape(full, KV, D)
                ks_ = torch.cat([kk, stage[bi, :off, li].reshape(off, KV, D),
                                 kc[bi][None].to(main.dtype)])
                vs_ = torch.cat([vv, stage[bi, :off, L + li].reshape(off, KV, D),
                                 vc[bi][None].to(main.dtype)])
                ks[li, bi, :, :n + 1] = ks_.permute(1, 0, 2)
                vs[li, bi, :, :n + 1] = vs_.permute(1, 0, 2)
        mask = (torch.arange(Tm, device=dev)[None, :] <= sl[:, None])[:, None, None, :]
        cyc = Cycle(n_l)

        qd = q[:, :, None].to(main.dtype)

        def lib():
            i = cyc()
            return sdpa(qd, ks[i], vs[i], attn_mask=mask, enable_gqa=True)

        lib_ms, _ = cuda_ms(lib)
        del ks, vs
        tokens = sum(n + 1 for n in lens)
        # QK and PV, 2 * NH * D operations a token each, at the card's peak
        # for their operands: a bf16 query and fp16 keys meet exactly only in
        # TF32; f32 (not TF32, which truncates) on the CUDA cores
        dots = 2 * NH * D * tokens
        ops = {"bf16": {"bf16": 2 * dots}, "fp16": {"tf32": dots, "fp16": dots},
               "f32": {"f32": 2 * dots}}[pool]
        b_ms, b_by = bound(bench.nbytes(lens, pool), ops)
        split = fa.flash_decode_split(B, KV, MP * ps, cuda_lib.sm_count(dev))
        rows.append(dict(shape=f"decode {name} B={B} ps={ps} MP={MP} seq_lens={lens} "
                               f"pool={pool}", ms=ms,
                         call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         library="SDPA over contiguous histories", bound_ms=b_ms, bound_by=b_by,
                         split=split, max_abs_err=err, bitwise_equal_share=equal_share,
                         deterministic=True, nan_rows_unread=True,
                         **({"bf16_read_equal_share": bf16_read} if pool == "f32" else {})))
        worst = max(worst, err)
    for r in rows:
        print("kernels: K6 " + json.dumps(r))
    results["flash_paged_decode" + ("" if pool == "bf16" else f"/{pool}")] = dict(
        rows[0], max_abs_err=worst)


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
    128, in bf16 and f32, timed; then, checked only, S 512 over T 1024 at
    q_offset 100 (not a multiple of 64: the tiles' boundaries fall inside the
    rows' diagonals) and at q_offset 128 read from a device tensor. The
    kernel walks 64-key tiles whatever the blocks, so its plain version is
    held with 64-key blocks (the same running maxima where p is rounded):
    f32 within 2e-5 (FMA sums in another order), bf16 within 2e-2 (a bf16
    ulp of p or of the output). Every output is finite and two calls are
    bitwise equal."""
    import torch

    from wrinklefree_tpu_torch.ops import flash_attention as fa

    NH, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out, worst = [], {}
    for dt, kind, tol in ((torch.bfloat16, "bf16", 2e-2), (torch.float32, "f32", 2e-5)):
        for S, T, off, timed in ((512, 512, 0, True), (512, 1024, 128, True),
                                 (512, 1024, 100, False), (512, 1024, "dev128", False)):
            q = torch.randn((1, S, NH, D), generator=g, device=dev).to(dt)
            k = torch.randn((1, T, KV, D), generator=g, device=dev).to(dt)
            v = torch.randn((1, T, KV, D), generator=g, device=dev).to(dt)
            on_dev = off == "dev128"
            if on_dev:
                off = 128
            qoff = torch.tensor([off], dtype=torch.int32, device=dev) if on_dev else off
            a = fa.flash_prefill(q, k, v, qoff)
            again = fa.flash_prefill(q, k, v, qoff)
            b = fa.flash_prefill_plain(q, k, v, off, block_k=64)
            torch.cuda.synchronize()
            d = (a.float() - b.float()).abs().max().item()
            where = f"K9 {kind} S={S} T={T} q_offset={off}{' on the device' if on_dev else ''}"
            if not (torch.isfinite(a).all() and d <= tol):
                fail(f"{where}: max abs error {d}")
            if not torch.equal(a, again):
                fail(f"{where}: two calls differ")
            worst[kind] = max(worst.get(kind, 0.0), d)
            if not timed:
                print(f"kernels: K9 {where}: max abs error {d} (bar {tol}), deterministic")
                continue
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
    - per mode, the bench's captured window (``captured_window``) from that
      run's start state: tokens and cache equal to the eager window's, the
      capture's launch counts, a k = 1 window that must repair;
    - the int8 head's bf16 copy timed alone (once per token in the head);
    - per mode, the bench itself (its captured window: a warm replay, the
      best of 3 replays of 64 steps), the eager window timed as the bench
      would time it uncaptured, and the device's busy share over one
      eager window under the profiler, side by side with the replay's.
    Returns the launches of each mode's counted (eager) run."""
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

    # the exact head against the bf16 head, every step; launch counts; the
    # captured window against the eager one
    clean = {k: v for k, v in qparams.items() if not k.startswith("lm_head_")}
    launches, states, mode_toks, captured = {}, {}, {}, {}
    for mode, kernels in BATCH1_MODES.items():
        klf, _ = linear_fns(mode)
        pm = mode_params(qparams, cfg, mode)
        checks, fell_back = [], []

        def checked_head(hidden, p):
            tok, certified = greedy_exact_topk(hidden, p, cfg, k=bd.EXACT_HEAD_K)
            checks.append(tok == torch.argmax(compute_logits(hidden, clean, cfg), -1))
            fell_back.append(not certified)
            return tok[:, None]

        tok, cache = bd.prefill(pm, cfg, klf, prompt, T)
        pos = torch.full((1,), prompt_len, dtype=torch.int32, device=dev)
        start = (tok.clone(), KVCache(cache.k.clone(), cache.v.clone()), pos.clone())
        torch.cuda.synchronize()
        for cnt in counters:
            cnt.launches = 0
        toks, tok, cache, pos = bd.decode_window(pm, cfg, klf, tok, cache, pos, steps,
                                                 checked_head)
        torch.cuda.synchronize()
        launches[mode] = {cnt.__name__: cnt.launches for cnt in counters}
        captured[mode] = captured_window(pm, cfg, klf, mode, kernels, start, toks, cache,
                                         counters)
        states[mode] = (pm, klf)
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
              f"exact head == bf16 argmax at {len(checks)}/{steps} steps (its certificate failed "
              f"at {sum(fell_back)}: the full head decided), launches per decode "
              f"step {json.dumps(per_step)}")
    if not torch.equal(mode_toks["split"], mode_toks["default"]):
        fail("batch1 split: the 64 greedy tokens differ from the default run's")
    same = next((i for i, (a, b) in enumerate(zip(mode_toks["layer_mega"].tolist(),
                                                  mode_toks["default"].tolist())) if a != b), steps)
    print(f"batch1: split's {steps} greedy tokens equal the default's; layer_mega's equal the "
          f"default's on the first {same}/{steps}")

    head = bd.exact_head(cfg)
    copy_dev, copy_call = cuda_ms(lambda: qparams["lm_head_q"].to(torch.bfloat16))
    copy_bytes = qparams["lm_head_q"].numel() * 3  # int8 read, bf16 written
    print(f"batch1: the int8 head's bf16 copy (compute_logits, once per token): {copy_dev} device "
          f"ms per token ({copy_call} ms by CUDA events), bound {bound(copy_bytes, 0, 'bf16')[0]} "
          f"ms ({copy_bytes / 1e9} GB moved)")
    for mode in BATCH1_MODES:
        res = bd.run("bitnet2b", prompt_len, steps, dev, split=mode == "split",
                     layer_mega=mode == "layer_mega")
        if not res["captured"]:
            fail(f"batch1 {mode}: the bench's window was not captured")
        print("batch1: bench " + json.dumps(res))
        # the eager window as the bench ran it before its capture (a warm
        # step, the best of 3 windows), then one more under the profiler
        pm, klf = states[mode]
        tok, cache = bd.prefill(pm, cfg, klf, prompt, T)
        pos = torch.full((1,), prompt_len, dtype=torch.int32, device=dev)
        _, tok, cache, pos = bd.decode_window(pm, cfg, klf, tok, cache, pos, 1, head)
        eager_ms = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            _, tok, cache, pos = bd.decode_window(pm, cfg, klf, tok, cache, pos, steps, head)
            eager_ms = min(eager_ms, (time.perf_counter() - t0) / steps * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, tok, cache, pos = bd.decode_window(pm, cfg, klf, tok, cache, pos, steps, head)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.device_time_total for e in evs) / 1e3 / steps
        print(f"batch1 {mode}: eager window {eager_ms} ms per token ({1e3 / eager_ms} tok/s, best "
              f"of 3 windows of {steps}); {dev_ms} ms of device time per token, "
              f"{dev_ms / eager_ms} of the eager token; device busy {dev_ms * steps / 1e3 / dt} of "
              f"{dt} s under the profiler; device ms per token by kernel: "
              + json.dumps(by_kernel(device_events(prof), steps)))
        print(f"batch1 {mode}: side by side, ms per token: eager {eager_ms}, captured "
              f"{res['ms_per_token']} (the bench, best of 3 windows of {steps}); device ms per "
              f"token: eager {dev_ms} (profiler, summed), captured "
              f"{res['replay_device_ms_per_token']} (CUDA events over the bench's best replay), "
              f"captured {captured[mode]['busy_ms_per_token']} (profiler busy over one replay of "
              f"the graph alone); repaired steps {res['repaired_steps']} in the bench's 4 windows")
    return launches


def by_kernel(evs, steps, n=8):
    """The n largest device times per token by kernel name (cut to 60
    characters; events of one cut name summed)."""
    out = {}
    for e in evs:
        out[e.name[:60]] = out.get(e.name[:60], 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:n])


def captured_window(pm, cfg, klf, mode, kernels, start, toks, cache, counters):
    """The bench's captured window (``bench.decode.DecodeGraph``) against the
    eager window ``toks``/``cache`` from the same start state (token, cache,
    position): the 64-step window captured once, the capture recording the
    mode's kernels once per layer and step and no other batch-1 kernel; its
    replay's tokens and cache equal the eager window's. Then one profiled
    replay of the graph alone (a report: its kernels and busy time), and a
    window captured with a one-candidate shortlist (k = 1), which must
    repair and still give the eager tokens and cache. Returns the replay's
    numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wrinklefree_tpu_torch.bench import decode as bd
    from wrinklefree_tpu_torch.models.bitnet import KVCache

    tok0, cache0, pos0 = start
    steps = len(toks)

    def window(k):
        gcache = KVCache(cache0.k.clone(), cache0.v.clone())
        graph = bd.DecodeGraph(pm, cfg, klf, gcache, steps, k=k)
        graph.warm_up(tok0, pos0)
        torch.cuda.synchronize()
        for cnt in counters:
            cnt.launches = 0
        t0 = time.perf_counter()
        graph.capture(tok0, pos0)
        capture_s = time.perf_counter() - t0
        recorded = {cnt.__name__: cnt.launches for cnt in counters}
        for name, n in recorded.items():
            want = cfg.num_layers * steps if name in kernels else 0
            if n != want:
                fail(f"batch1 {mode}: the capture (k = {k}) recorded {name} {n} times, "
                     f"expected {want}")
        got, last, _, nxt, repaired = graph.run(tok0, pos0)
        torch.cuda.synchronize()
        if not torch.equal(got, toks):
            bad = (got != toks).nonzero()[:, 0].tolist()
            fail(f"batch1 {mode}: the captured window's tokens (k = {k}) differ from the eager "
                 f"window's at steps {bad}")
        if not (torch.equal(gcache.k, cache.k) and torch.equal(gcache.v, cache.v)):
            fail(f"batch1 {mode}: the captured window's cache (k = {k}) differs from the eager "
                 "window's")
        return graph, last, nxt, repaired, capture_s, recorded

    graph, last, nxt, repaired, capture_s, recorded = window(bd.EXACT_HEAD_K)
    print(f"batch1 {mode}: captured {steps}-step window (k = {bd.EXACT_HEAD_K}): tokens and cache "
          f"equal the eager window's; capture {capture_s} s recorded "
          f"{json.dumps({k: v for k, v in recorded.items() if v})} launches (the other batch-1 "
          f"kernels 0); repaired_steps {repaired}; replay {graph.replay_ms / steps} device ms per "
          "token (CUDA events)")
    # the graph replayed once more from the window's end, under the profiler
    # (a report: the replay alone, without the repair that ends a run)
    graph.tok.copy_(last)
    graph.pos.copy_(nxt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.graph.replay()
        torch.cuda.synchronize()
    evs = device_events(prof)
    busy = busy_us(evs) / 1e3 / steps
    print(f"batch1 {mode}: a profiled replay of the graph: {busy} busy device ms per token over "
          f"{len(evs)} device events; device ms per token by kernel (a report): "
          f"{json.dumps(by_kernel(evs, steps))}")
    out = {"replay_ms_per_token": graph.replay_ms / steps, "busy_ms_per_token": busy,
           "repaired_steps": repaired}
    del graph
    graph, _, _, repaired1, _, _ = window(1)
    if repaired1 < 1:
        fail(f"batch1 {mode}: the k = 1 window repaired no step")
    print(f"batch1 {mode}: captured window with k = 1: repaired_steps {repaired1}, tokens and "
          "cache equal the eager window's")
    del graph
    torch.cuda.empty_cache()
    return out


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


def phase_preempt(params, cfg, dev, counters):
    """Retraction on a dry KV pool at 2B width: eight 200-token prompts, 64
    greedy tokens each, 8 slots at page size 16 with ``decode_burst`` 20.
    Admission gives each request the pages of its budget (264 tokens: 17
    pages); the fourth burst, from position 260, needs an 18th. A pool of
    137 pages (136 usable = 8 x 17) admits all eight and is dry at that
    top-up, so the engine retracts requests, which re-prefill later (their
    full pages come back from the radix cache). The same requests on a
    roomy pool (1024 pages) give the reference tokens. Gates: every request
    finishes by length with 64 tokens, at least one retraction, each
    request's on_token stream equals its output_ids, every request never
    retracted has the roomy run's tokens, and every kernel in ``counters``
    (zeroed just before the contended run) launches. For a retracted request
    the count of leading tokens equal to the roomy run is printed: its
    re-prefill runs its history through K1's GEMM and K4 instead of the
    decode path, so bf16 rounding may move a late token. Returns the
    contended run's launches."""
    import numpy as np
    import torch

    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams

    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, 200).tolist() for _ in range(8)]
    sp = SamplingParams(max_new_tokens=64, temperature=0.0)
    runs = {}
    for tag, pages in (("roomy", 1024), ("contended", 137)):
        eng = Engine(params, cfg, EngineConfig(max_batch_slots=8, page_size=16,
                                               num_pages=pages, max_context=2048,
                                               prefill_buckets=(32, 128, 512),
                                               decode_burst=20), device=dev)
        retracted = set()
        preempt = eng._preempt
        eng._preempt = lambda r, preempt=preempt: (retracted.add(r.rid), preempt(r))[1]
        streams = [[] for _ in prompts]
        if tag == "contended":
            for c in counters:
                c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, sp, on_token=lambda t, fin, i=i: streams[i].append(t))
                for i, p in enumerate(prompts)]
        while any(not r.finished for r in reqs):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        for r, s in zip(reqs, streams):
            if r.finish_reason != "length" or len(r.output_ids) != 64:
                fail(f"preempt ({tag}): a request finished {r.finish_reason!r} with "
                     f"{len(r.output_ids)} tokens")
            if s != r.output_ids:
                fail(f"preempt ({tag}): request {r.rid}'s on_token stream differs from its "
                     "output_ids (a token emitted twice or lost)")
        runs[tag] = (eng, reqs, retracted, wall)
        del eng
    (_, roomy, _, roomy_wall), (eng, reqs, retracted, wall) = runs["roomy"], runs["contended"]
    n = eng.stats.get("preemptions", 0)
    if n < 1 or runs["roomy"][0].stats.get("preemptions", 0):
        fail(f"preempt: {n} retractions on the dry pool (and "
             f"{runs['roomy'][0].stats.get('preemptions', 0)} on the roomy one)")
    agree = {}
    for i, (r, w) in enumerate(zip(reqs, roomy)):
        lead = next((k for k, (a, b) in enumerate(zip(r.output_ids, w.output_ids)) if a != b),
                    64)
        if r.rid in retracted:
            agree[i] = lead
        elif lead != 64:
            fail(f"preempt: request {i} was never retracted but parts from the roomy run at "
                 f"token {lead} (a result that depends on the batch)")
    zero = [k for k, v in launches.items() if v == 0]
    if zero:
        fail(f"preempt: kernels not launched: {zero}")
    print(f"preempt: 8 x (200 + 64) tokens, 137 pages: {n} retractions of {len(retracted)} "
          f"requests, all finished by length; the {8 - len(retracted)} never retracted equal "
          f"the roomy run (1024 pages); the retracted agree with it on their leading tokens "
          f"{json.dumps(agree)} of 64; prefill tokens {eng.stats['prefill_tokens']} (roomy "
          f"{runs['roomy'][0].stats['prefill_tokens']}), radix hit tokens "
          f"{eng.stats['radix_hit_tokens']}; wall {wall} s (roomy {roomy_wall} s); launches "
          f"{json.dumps(launches)}")
    return launches


def phase_features(params, cfg, dev, counters, smi):
    """The request features at 2B width and depth (the engine phase's
    EngineConfig, random weights from seed 0, the byte tokenizer's pieces for
    the 128256 ids), each on 200-token prompts so every variant's prefill
    runs K1's GEMM and K4 and its decode K1, K2 and K3; every counter in
    ``counters`` must grow in each variant (zeroed before each):

    - the draws: ``per_request_keys`` and ``random_bits`` for 64 (seed,
      counter) pairs on the card bit-equal to the CPU's, the Gumbel floats
      within 1e-6;
    - logprobs: a greedy ``logprobs_k=4`` request whose top-1 id is the
      emitted token and whose chosen logprob is the top-1's (<= 0) at every
      step, its tokens those of the same request without logprobs; a decode
      window of 8 slots with logprobs timed beside the plain one;
    - json_mode: the text a JSON prefix under the validator, finished by stop
      or length, ms per constrained token; GBNF ``root ::= "yes" | "no"``
      ending in one of the two; a json_schema request whose text parses when
      it ends by stop;
    - mirostat: a seeded ``mirostat=2`` request, the same tokens alone and
      beside three other requests;
    - snapshot/restore: a snapshot after two bursts of four seeded sampled and
      two greedy requests holds each request's emitted tokens and
      ``counter_base`` = their count; restored on a fresh engine alone and
      behind three other requests it continues every request to its length
      with the same tokens both times. The restore re-prefills the history
      (K1's GEMM and K4) where the uninterrupted run wrote it in decode steps
      (the GEMV and the plain attention), and on random 30-layer weights that
      rounding moves the logits enough to part a stream. So where a restored
      stream parts from the uninterrupted one (at step j), the logits of both
      runs there (recorded by ``LogitsRecorder``) must lie within twice the
      bound, the largest distance between each request's decode logits at 16
      tokens and its prompt + 16 tokens prefilled afresh, while the
      uninterrupted run's logits one step earlier (a history short of its
      last token) must lie further; each run's token must be its own logits'
      pick under the draw for step j, at a near-tie (``near_tie``). The
      exact continuation is held on the CPU (``tests/test_torch_snapshot.py``,
      the full tiny model).
    Returns the launches summed over the variants."""
    import numpy as np
    import torch

    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.engine.gbnf import GbnfValidator
    from wrinklefree_tpu_torch.engine.json_constraint import JsonPrefixValidator
    from wrinklefree_tpu_torch.engine.schema_to_gbnf import schema_to_gbnf
    from wrinklefree_tpu_torch.ops import sampling
    from wrinklefree_tpu_torch.server.http import ByteTokenizer

    t_phase = time.perf_counter()
    # the draws: the card's words against the CPU's
    rng = np.random.default_rng(18)
    seeds = torch.from_numpy(np.concatenate([
        [0, 1, 2**31 - 1, 2**32 - 1], rng.integers(0, 2**32, 60, dtype=np.uint64)]).astype(np.int64))
    ctrs = torch.from_numpy(np.concatenate([[0, 1, 2**20 - 1, 2**20],
                                            rng.integers(0, 2**20, 60)]).astype(np.int64))
    keys = sampling.per_request_keys(seeds, ctrs)
    keys_dev = sampling.per_request_keys(seeds.to(dev), ctrs.to(dev))
    bits_equal = (torch.equal(keys, keys_dev.cpu()) and torch.equal(
        sampling.random_bits(keys, 256), sampling.random_bits(keys_dev, 256).cpu()))
    if not bits_equal:
        fail("features: the card's per_request_keys/random_bits words differ from the CPU's")
    g_cpu, g_dev = sampling.gumbel(keys, 256), sampling.gumbel(keys_dev, 256).cpu()
    # relative to max(|g|, 1): an ulp of a Gumbel draw near 16 is 2e-6
    g_err = float(((g_cpu - g_dev).abs() / g_cpu.abs().clamp_min(1.0)).max())
    g_same = float((g_cpu == g_dev).float().mean())
    if g_err > 1e-6:
        fail(f"features: the card's Gumbel floats differ from the CPU's by {g_err} (relative)")

    ecfg = EngineConfig(max_batch_slots=8, page_size=16, num_pages=1024, max_context=2048,
                        prefill_buckets=(32, 128, 512))
    pieces = [ByteTokenizer().decode([i]) for i in range(cfg.vocab_size)]

    def engine(**over):
        eng = Engine(params, cfg, dataclasses.replace(ecfg, **over), device=dev)
        eng.token_pieces = pieces
        return eng

    def prompt():
        return rng.integers(1, cfg.vocab_size, 200).tolist()

    def run(eng, jobs):
        reqs = [eng.submit(p, sp) for p, sp in jobs]
        while any(not r.finished for r in reqs):
            eng.step()
        torch.cuda.synchronize()
        return reqs

    total = {c.__name__: 0 for c in counters}
    grown = {}

    def variant(name, fn):
        for c in counters:
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {c.__name__: c.launches for c in counters}
        zero = [k for k, v in got.items() if v == 0]
        if zero:
            fail(f"features ({name}): kernels not launched: {zero}")
        for k, v in got.items():
            total[k] += v
        grown[name] = got
        return out

    eng = engine()
    text = lambda ids: "".join(pieces[t] for t in ids)  # noqa: E731

    # logprobs
    p_lp = prompt()
    (lp,) = variant("logprobs", lambda: run(eng, [(p_lp, SamplingParams(max_new_tokens=40,
                                                                         logprobs_k=4))]))
    eng.reset_prefix_cache()
    (plain,) = run(eng, [(p_lp, SamplingParams(max_new_tokens=40))])
    eng.reset_prefix_cache()
    if lp.output_ids != plain.output_ids or len(lp.logprobs_seq) != 40:
        fail(f"features: logprobs stream {lp.output_ids} vs plain {plain.output_ids}, "
             f"{len(lp.logprobs_seq)} logprob entries")
    for tok, (chosen, tops) in zip(lp.output_ids, lp.logprobs_seq):
        if tops[0][0] != tok or chosen != tops[0][1] or chosen > 0 or len(tops) != 4:
            fail(f"features: logprobs entry {(chosen, tops)} for token {tok}")
    # decode windows of 8 slots (17-token prompts, 48 decode steps), plain
    # and with logprobs in turns: wall ms per step, then one profiled window
    # each for the device's ms per step
    from torch.profiler import ProfilerActivity, profile

    windows = {"plain": [], "logprobs": []}
    device_ms = {}
    for tag in ("plain", "logprobs", "logprobs", "plain", "plain", "logprobs"):
        profiled = len(windows[tag]) == 2
        batch = [eng.submit(rng.integers(1, cfg.vocab_size, 17).tolist(),
                            SamplingParams(max_new_tokens=49,
                                           logprobs_k=4 if tag == "logprobs" else 0))
                 for _ in range(8)]
        eng.step()
        torch.cuda.synchronize()
        steps0, t1 = eng.stats["decode_steps"], time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) if profiled else contextlib.nullcontext() as prof:
            while any(not r.finished for r in batch):
                eng.step()
            torch.cuda.synchronize()
        steps = eng.stats["decode_steps"] - steps0
        if profiled:
            device_ms[tag] = busy_us(device_events(prof)) / 1e3 / steps
        else:
            windows[tag].append((time.perf_counter() - t1) / steps * 1e3)

    # constrained: json_mode, GBNF, json_schema
    def constrained():
        js = run(eng, [(prompt(), SamplingParams(max_new_tokens=48, json_mode=True))])[0]
        yn = run(eng, [(prompt(), SamplingParams(max_new_tokens=8,
                                                 grammar='root ::= "yes" | "no"'))])[0]
        schema = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                                   "n": {"type": "integer"}},
                  "required": ["ok", "n"]}
        sc = run(eng, [(prompt(), SamplingParams(max_new_tokens=48, temperature=0.7, seed=5,
                                                 grammar=schema_to_gbnf(schema)))])[0]
        return js, yn, sc, schema

    js, yn, sc, schema = variant("constrained", constrained)
    if (JsonPrefixValidator().advance(text(js.output_ids)) not in ("ok", "complete")
            or js.finish_reason not in ("stop", "length")):
        fail(f"features: json_mode text {text(js.output_ids)!r} ({js.finish_reason})")
    if js.finish_reason == "stop":
        json.loads(text(js.output_ids))
    constrained_ms = (js.finish_t - js.first_token_t) / max(len(js.output_ids) - 1, 1) * 1e3
    if text(yn.output_ids) not in ("yes", "no") or yn.finish_reason != "stop":
        fail(f"features: GBNF yes/no gave {text(yn.output_ids)!r} ({yn.finish_reason})")
    sc_status = GbnfValidator(schema_to_gbnf(schema)).advance(text(sc.output_ids))
    if sc_status == "dead" or (sc.finish_reason == "stop" and not isinstance(
            json.loads(text(sc.output_ids)), dict)):
        fail(f"features: json_schema text {text(sc.output_ids)!r} ({sc.finish_reason})")

    # mirostat: alone and beside three other requests
    p_miro = prompt()
    miro = SamplingParams(max_new_tokens=40, temperature=1.0, seed=77, mirostat=2)

    def mirostat():
        eng.reset_prefix_cache()
        (alone,) = run(eng, [(p_miro, miro)])
        eng.reset_prefix_cache()
        others = [(prompt(), SamplingParams(max_new_tokens=40, temperature=t, seed=i))
                  for i, t in enumerate((0.0, 0.8, 1.2))]
        beside = run(eng, [others[0], (p_miro, miro), *others[1:]])[1]
        return alone, beside

    alone, beside = variant("mirostat", mirostat)
    if alone.output_ids != beside.output_ids or len(alone.output_ids) != 40:
        fail(f"features: mirostat alone {alone.output_ids} beside others {beside.output_ids}")

    # snapshot after two bursts; a fresh engine's restore
    jobs = [(prompt(), SamplingParams(max_new_tokens=64, temperature=t, seed=100 + i,
                                      top_p=0.95 if t else 1.0))
            for i, t in enumerate((0.7, 1.0, 0.9, 1.2, 0.0, 0.0))]
    rec = LogitsRecorder()

    def snapshot_restore():
        with rec.on(engine()) as eng0:
            want = run(eng0, jobs)
        # the bound: each request's history of prompt + 16 tokens prefilled
        # afresh, against the uninterrupted run's decode step there
        with rec.on(engine()) as eng0:
            run(eng0, [(p + w.output_ids[:16], dataclasses.replace(sp, max_new_tokens=1))
                       for (p, sp), w in zip(jobs, want)])
        eng1 = engine()
        reqs = [eng1.submit(p, sp) for p, sp in jobs]
        while eng1.stats["decode_steps"] < 2 * ecfg.decode_burst:
            eng1.step()
        snap = eng1.snapshot()
        emitted = [list(r.output_ids) for r in reqs]
        del eng1, reqs
        restores = []
        for extra in (0, 3):  # restored alone, and behind three other requests
            eng2 = engine()
            others = [eng2.submit(prompt(), SamplingParams(max_new_tokens=20, temperature=0.9,
                                                           seed=i)) for i in range(extra)]
            with rec.on(eng2 if not extra else None):
                restored = eng2.restore(snap)
                while any(not r.finished for r in restored + others):
                    eng2.step()
            restores.append([(r.output_ids, r.finish_reason) for r in restored])
        torch.cuda.synchronize()
        return want, snap, emitted, restores

    want, snap, emitted, restores = variant("snapshot_restore", snapshot_restore)
    if restores[0] != restores[1]:
        fail("features: the snapshot restored alone and behind three other requests gave "
             "different tokens")
    # runs recorded: 0 the uninterrupted one, 1 the bound's prefills, 2 the
    # restored one
    runs = rec.runs
    bound = max(float((runs[1][(sp.seed, len(p) + 16)] - runs[0][(sp.seed, len(p) + 16)])
                      .abs().max()) for p, sp in jobs)
    agree, apart, wrong = [], [], []
    for (p, sp), w, d, e, (ids, why) in zip(jobs, want, snap["requests"], emitted,
                                            restores[0]):
        if (d["output_ids"] != e or d["counter_base"] != len(e) or not e
                or d["max_new_tokens"] != 64 - len(e)):
            fail(f"features: snapshot entry {d['output_ids']}, counter_base "
                 f"{d['counter_base']}, for the {len(e)} tokens emitted")
        if len(ids) != 64 - len(e) or why != "length":
            fail(f"features: a restored request ended {why!r} after {len(ids)} more tokens")
        got = d["output_ids"] + ids
        j = next((i for i, (a, b) in enumerate(zip(got, w.output_ids)) if a != b), len(got))
        agree.append(j)
        if j < len(e):
            fail(f"features: the interrupted run parted from the uninterrupted one at step {j}, "
                 f"before the snapshot")
        if j == len(got):
            continue
        # where the restored stream parts from the uninterrupted one: its
        # logits there lie within 2x the bound of the uninterrupted run's
        # (a history missing its last token lies further), and each token is
        # its own run's pick under the draw for step j at a near-tie
        l_dec, l_res = runs[0][(sp.seed, len(p) + j)], runs[2][(sp.seed, len(p) + j)]
        dist = float((l_res - l_dec).abs().max())
        off = float((l_res - runs[0][(sp.seed, len(p) + j - 1)]).abs().max())
        apart.append(dist)
        wrong.append(off)
        if dist > 2 * bound or off <= 2 * bound:
            fail(f"features: restored logits at step {j} {dist} from the uninterrupted "
                 f"run's (the bound {bound}; a history short of its last token {off})")
        why = near_tie(sampling, l_dec, l_res, sp, j, w.output_ids[j], got[j], dist)
        if why:
            fail(f"features: the restored stream parts at step {j}: {why}")
    print(f"features: 2B, {cfg.num_layers} layers ({smi}): draws on the card bit-equal to the "
          f"CPU's (64 keys, 64 x 256 words; Gumbel floats max relative diff {g_err}, "
          f"{g_same} bit-equal); logprobs: 40 steps, top-1 = emitted, stream = plain; decode window, 8 "
          f"slots, in turns: plain {windows['plain']} ms per step ({device_ms['plain']} device ms), "
          f"logprobs_k=4 {windows['logprobs']} ms per step ({device_ms['logprobs']} device ms); "
          f"json_mode {len(js.output_ids)} tokens ({js.finish_reason}) at "
          f"{constrained_ms} ms per constrained token, text {text(js.output_ids)!r}; GBNF yes/no "
          f"-> {text(yn.output_ids)!r}; json_schema -> {text(sc.output_ids)!r} "
          f"({sc.finish_reason}); mirostat alone = beside three others (40 tokens); "
          f"snapshot after {2 * ecfg.decode_burst} decode steps of 6 requests "
          f"({[len(d['output_ids']) for d in snap['requests']]} tokens each, counter_base "
          f"equal), restored on a fresh engine alone and behind three other requests: the same "
          f"tokens, each to its length; the uninterrupted run agrees on {agree} of 64 tokens; "
          f"where they part the restored logits lie {apart} from the uninterrupted run's "
          f"(bound: prefill vs decode at 16 tokens {bound}, doubled; a history short of its "
          f"last token {wrong}), each token its run's pick at a near-tie; launches per "
          f"variant {json.dumps(grown)}; {time.perf_counter() - t_phase} s")
    return total


def phase_heads_kv(params, cfg, dev, counters, default_toks, results, smi):
    """The engine's heads, the native host runtime, quantized KV pools, the
    token-major layout and the sliding window at 2B width and depth (the
    engine phase's EngineConfig and six greedy prompts of 17..700 tokens, 32
    new tokens each, random weights from seed 0). Every check is required:

    - the default engine's run, its logits recorded (``LogitsRecorder``),
      gives the engine phase's tokens;
    - exact head (``exact_head_k=64``): greedy streams equal the default
      run's, or part where the default run's bf16 logits hold both tokens
      within 1e-2 (the rescore's f32 einsum and cuBLAS sum in other orders);
      a sampled and a penalised request sharing bursts give the default
      engine's tokens; an 8-slot greedy decode window beside the plain one:
      device ms per step, certificate failures per step;
    - ``int8_logits``: every program's params hold the int8 head and
      ``paged_forward``'s own head runs on them; every token is the argmax
      of the int8 head's logits that this check computes from the hidden
      rows that head was given and the engine's params; the agreement of
      that argmax with the bf16 head's on the same rows is printed;
    - native runtime: the engines run it; eight 110-token prompts sharing 48
      tokens, 48 tokens each, on a 60-page pool with bursts of 20 (radix hits
      and retractions): tokens, radix hits and retractions equal a
      ``use_native_runtime=False`` engine's;
    - quantized pools (int8, fp8_e4m3, fp8_e5m2; token and layer layouts):
      after a first 64-token chunk the pool's rows and scales equal
      ``quantize_kv`` of the bf16 pool's, bit for bit; logits of 24 decode
      steps after a 200-token prompt, teacher-forced on the bf16 run's
      tokens, against a bf16 run of the same layout on the same (plain)
      attention: the prompt's logits bit-equal, the minimum cosine at
      least 0.985 (bf16 kernels), 0.98 (int8), 0.97 (fp8_e4m3), 0.95
      (fp8_e5m2) (on random 30-layer weights the bf16 kernel path's own
      rounding reads 0.9925, so the reference's 0.998 is held one level
      down): each layer's decode attention over the quantized history
      against the bf16 history's, cosine >= 0.998 for int8 and fp8_e4m3,
      fp8_e5m2's printed; each quantized run's written history after the
      24 steps is ``quantize_kv`` of the K/V rows that run wrote, bytes
      and scales, each value within half a quantization step; each
      dtype's pool bytes; engines on int8 (token) and fp8_e5m2 (layer) pools
      with ``flash_decode`` launch K1 and K2 and never K3, K4 or K6;
    - token layout, bf16: K3's token-major writes (8 decode rows, a
      512-token chunk) bit-equal to its plain version, timed; a 512-token
      chunk over a 1024-token table launches K4's contiguous form once per
      layer, its output within 3e-2 of the plain version at layers 0 and 29,
      timed; the engine's streams equal the default run's or part at a
      near-tie (``near_tie``; the two runs' logits within 1.0 there);
    - window: ``attn_window=2048`` (>= max_context) gives the tokens of the
      same engine with ``attention_fn=_paged_attention_dual`` or parts at a
      near-tie; a 256-token window on four 700-token prompts runs, its
      gathered pages per row, layer and decode step printed beside the
      table's width.
    - fp16 and f32 pools: the engine on each, on the layer layout with
      ``flash_decode`` (K3, K4 over the pool and K6, each launched) and on
      the token layout (K3 and K4's contiguous form launched); streams equal
      the bf16 default run's (layer) and the bf16 token layout's, or part
      at a near-tie (``near_tie``; the two runs' logits within 1.0 there).
    Returns each engine's launches: the bf16 token layout's (``"token"``)
    and those of the fp16 and f32 pools (``"layer fp16"``, ...)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wrinklefree_tpu_torch.bench import flash_prefill as fp_bench
    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams, programs
    from wrinklefree_tpu_torch.kv import paged
    from wrinklefree_tpu_torch.kv.paged import PagedKV
    from wrinklefree_tpu_torch.kv.quantized import quantize_kv
    from wrinklefree_tpu_torch.models.bitnet import compute_logits
    from wrinklefree_tpu_torch.ops import flash_attention as fa
    from wrinklefree_tpu_torch.ops import kv_update_cuda as kvu
    from wrinklefree_tpu_torch.ops import sampling

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize
    ecfg = EngineConfig(max_batch_slots=8, page_size=16, num_pages=1024, max_context=2048,
                        prefill_buckets=(32, 128, 512))
    L, V = cfg.num_layers, cfg.vocab_size
    lens = (17, 64, 200, 333, 512, 700)
    rng = np.random.default_rng(0)  # the engine phase's prompts
    prompts = [rng.integers(1, V, n).tolist() for n in lens]
    rng = np.random.default_rng(19)
    greedy = SamplingParams(max_new_tokens=32, temperature=0.0)
    attn_kernels = [kvu.kv_write, fa.flash_paged_prefill, fa.flash_paged_decode]
    everything = {c.__name__: c for c in (*counters, fa.flash_paged_decode)}
    out = {}

    def engine(**over):
        af = over.pop("attention_fn", None)
        eng = Engine(params, cfg, dataclasses.replace(ecfg, **over), device=dev,
                     attention_fn=af)
        if not eng.native_runtime:
            fail("heads_kv: the engine runs the Python allocator and radix cache, not the "
                 "native runtime")
        return eng

    def run(eng, jobs):
        reqs = [eng.submit(p, sp) for p, sp in jobs]
        while any(not r.finished for r in reqs):
            eng.step()
        sync()
        for r in reqs:
            if r.finish_reason != "length" or len(r.output_ids) != r.sampling.max_new_tokens:
                fail(f"heads_kv: a request finished {r.finish_reason!r} with "
                     f"{len(r.output_ids)} tokens")
        return reqs

    def zero():
        for c in everything.values():
            c.launches = 0

    def launches():
        return {n: c.launches for n, c in everything.items()}

    def first_part(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)

    def parted_at_near_tie(what, prompt, got, want, run_got, run_want):
        """Where ``got`` parts from ``want`` (greedy), both runs' recorded
        logits there lie within 1.0 and the two tokens are a near-tie."""
        j = first_part(got.output_ids, want.output_ids)
        if j is None:
            return 32
        key = (want.seed, len(prompt) + j)
        l_w, l_g = run_want[key], run_got[(got.seed, len(prompt) + j)]
        dist = float((l_g - l_w).abs().max())
        why = near_tie(sampling, l_w, l_g, want.sampling, j, want.output_ids[j],
                       got.output_ids[j], dist)
        if dist > 1.0 or why:
            fail(f"heads_kv ({what}): a request of {len(prompt)} tokens parts at token {j}: "
                 f"logits {dist} apart; {why}")
        return j

    # the default engine, recorded: the reference run of every comparison
    rec = LogitsRecorder()
    with rec.on(engine()) as eng:
        base = run(eng, [(p, greedy) for p in prompts])
    if [r.output_ids for r in base] != default_toks:
        fail("heads_kv: the recorded default run's tokens differ from the engine phase's")
    base_logits = rec.runs[0]
    del eng

    # ---- the exact head
    zero()
    ex = engine(exact_head_k=64)
    exact = run(ex, [(p, greedy) for p in prompts])
    ex_launch = launches()
    exact_parts = []
    for p, r, b in zip(prompts, exact, base):
        j = first_part(r.output_ids, b.output_ids)
        if j is None:
            exact_parts.append(32)
            continue
        lg = base_logits[(b.seed, len(p) + j)]
        gap = float(lg[b.output_ids[j]] - lg[r.output_ids[j]])
        if int(lg.argmax()) != b.output_ids[j] or gap > 1e-2:
            fail(f"heads_kv: the exact head parts from the bf16 head at token {j} of a "
                 f"{len(p)}-token prompt, the bf16 logits {gap} apart")
        exact_parts.append((j, gap))
    mix = [(rng.integers(1, V, 200).tolist(),
            SamplingParams(max_new_tokens=32, temperature=0.8, top_p=0.95, seed=5)),
           (rng.integers(1, V, 200).tolist(),
            SamplingParams(max_new_tokens=32, repetition_penalty=1.3, presence_penalty=0.2))]
    ex_mix = [r.output_ids for r in run(engine(exact_head_k=64), mix)]
    if ex_mix != [r.output_ids for r in run(engine(), mix)]:
        fail("heads_kv: a sampled and a penalised request under the exact head differ from "
             "the default engine's")
    window_prompts = [rng.integers(1, V, 17).tolist() for _ in range(8)]

    def window(eng):
        """Device ms, wall ms and certificate failures per decode step of 8
        greedy slots (48 steps after the first), profiled."""
        batch = [eng.submit(p, SamplingParams(max_new_tokens=49)) for p in window_prompts]
        eng.step()
        sync()
        steps0, fb0, t0 = eng.stats["decode_steps"], int(eng.exact_fallbacks), time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            while any(not r.finished for r in batch):
                eng.step()
            sync()
        steps = eng.stats["decode_steps"] - steps0
        return dict(device_ms=busy_us(device_events(prof)) / 1e3 / steps,
                    profiled_wall_ms=(time.perf_counter() - t0) / steps * 1e3,
                    cert_failures_per_step=(int(eng.exact_fallbacks) - fb0) / steps,
                    tokens=[r.output_ids for r in batch])
    win = {"plain": window(engine()), "exact": window(ex)}
    del ex
    out["exact"] = dict(parts=exact_parts, windows={k: {x: v[x] for x in v if x != "tokens"}
                                                    for k, v in win.items()})

    # ---- int8_logits: each token the argmax of the int8 head's logits,
    # computed here from the hidden rows paged_forward's own head was given
    # and the engine's params, and its agreement with the bf16 head
    forward, head = programs.paged_forward, paged.compute_logits
    e8 = engine(int8_logits=True)
    calls, heads_seen = [], []

    def recording_head(hidden, p_, cfg_):
        heads_seen.append(hidden.detach().clone())
        return head(hidden, p_, cfg_)

    def probed(p_, cfg_, tokens, pools, pt, sl, nl, **kw):
        heads_seen.clear()
        res = forward(p_, cfg_, tokens, pools, pt, sl, nl, **kw)
        ns = len(e8.slots)
        keys = [(e8.slots[slot].seed, n) if slot < ns and e8.slots[slot] is not None else None
                for slot, n in zip(kw["slot_ids"].tolist(), (sl + nl).tolist())]
        calls.append(("lm_head_q" in p_, list(heads_seen), keys))
        return res

    programs.paged_forward, paged.compute_logits = probed, recording_head
    try:
        i8 = run(e8, [(p, greedy) for p in prompts])
    finally:
        programs.paged_forward, paged.compute_logits = forward, head
    if not calls or not all(has_q and len(h) == 1 for has_q, h, _ in calls):
        fail("heads_kv: an int8_logits program ran without the int8 head in its params or "
             "without paged_forward's own head")
    probe = {}
    clean_params = programs._clean_head(e8.params)
    for _, (hidden,), keys in calls:
        int8_top = compute_logits(hidden, e8.params, cfg).argmax(-1).tolist()
        bf16_top = compute_logits(hidden, clean_params, cfg).argmax(-1).tolist()
        for key, a, b in zip(keys, int8_top, bf16_top):
            if key is not None:
                probe[key] = (a, b)
    del calls
    for p, r in zip(prompts, i8):
        want = [probe[(r.seed, len(p) + k)][0] for k in range(len(r.output_ids))]
        if r.output_ids != want:
            fail(f"heads_kv: int8_logits tokens {r.output_ids} are not the int8 head's argmax "
                 f"{want}")
    agree = float(np.mean([a == b for a, b in probe.values()]))
    out["int8_logits"] = dict(
        argmax_agrees_with_bf16=agree, steps=len(probe),
        leading_tokens_equal_to_bf16=[
            32 if (j := first_part(r.output_ids, b.output_ids)) is None else j
            for r, b in zip(i8, base)])
    del e8

    # ---- the native runtime against the Python classes
    shared = rng.integers(1, V, 48).tolist()
    jobs = [(shared + rng.integers(1, V, 62).tolist(), SamplingParams(max_new_tokens=48))
            for _ in range(8)]
    native = []
    for use in (True, False):
        eng = Engine(params, cfg, dataclasses.replace(ecfg, num_pages=60, decode_burst=20,
                                                      use_native_runtime=use), device=dev)
        if eng.native_runtime is not use:
            fail(f"heads_kv: use_native_runtime={use} ran native_runtime={eng.native_runtime}")
        reqs = run(eng, jobs)
        native.append(([r.output_ids for r in reqs], eng.stats["radix_hit_tokens"],
                       eng.stats.get("preemptions", 0)))
        del eng
    if native[0] != native[1] or not native[0][1] or not native[0][2]:
        fail(f"heads_kv: native runtime (radix hits {native[0][1]}, retractions "
             f"{native[0][2]}) against the Python classes (radix hits {native[1][1]}, "
             f"retractions {native[1][2]}): tokens equal {native[0][0] == native[1][0]}")
    out["native"] = dict(radix_hit_tokens=native[0][1], retractions=native[0][2])

    # ---- quantized pools: stored bytes after a first chunk, decode logits
    def pools_for(layout, dt, pages):
        if layout == "layer":
            return PagedKV.zeros_dual(cfg, pages, 16, 1, dt, device=dev)
        return PagedKV.zeros(cfg, pages, 16, dt, device=dev)

    def rows(pools, layout, n):
        def flat(t):
            t = t[1:1 + n // 16]
            if layout == "layer":
                t = t.transpose(1, 2)
            return t.reshape(n, *t.shape[2:])
        return flat(pools.kv), None if pools.scale is None else flat(pools.scale)

    i32 = dict(device=dev, dtype=torch.int32)
    one = torch.ones(1, **i32)
    slot0 = torch.zeros(1, **i32)
    chunk = torch.as_tensor(rng.integers(1, V, (1, 64)), device=dev)
    quant = {}
    for layout in ("token", "layer"):
        stored = {}
        for dt in ("bf16", "int8", "fp8_e4m3", "fp8_e5m2"):
            pools = pools_for(layout, dt, 16)
            _, pools = paged.paged_forward(params, cfg, chunk, pools,
                                           torch.arange(1, 9, **i32)[None], 0 * one, 64 * one,
                                           slot_ids=slot0)
            stored[dt] = rows(pools, layout, 64)
        kvh, hd = cfg.num_kv_heads, cfg.head_dim
        for dt in ("int8", "fp8_e4m3", "fp8_e5m2"):
            q, s = quantize_kv(stored["bf16"][0].reshape(64, 2 * L, kvh, hd), dt)
            if not (torch.equal(stored[dt][0].view(torch.uint8),
                                q.reshape(stored[dt][0].shape).view(torch.uint8))
                    and torch.equal(stored[dt][1], s.reshape(stored[dt][1].shape))):
                fail(f"heads_kv: the {layout} {dt} pool's rows or scales after a first chunk "
                     f"are not quantize_kv of the bf16 pool's")
    # decode logits teacher-forced on the bf16 kernel path's tokens; the
    # quantized pools take the plain attention, so they are held against bf16
    # pools on that attention ("bf16"). Their first logits (the prompt's
    # chunk, which reads no history) must be the bf16 run's bit for bit. On
    # random 30-layer weights any rounding grows through the layers (the
    # bf16 kernel path against "bf16" reads 0.9925), so the cosines are held
    # to floors below the card's readings, and the reference's 0.998 bar is
    # held where the quantization acts: each layer's
    # decode attention over the quantized history (quantize_kv of the bf16
    # pool's rows) against the same attention over the bf16 history, on the
    # bf16 run's own queries (``attn_cos``).
    prompt = torch.zeros((1, 256), dtype=torch.long, device=dev)
    prompt[0, :200] = torch.as_tensor(rng.integers(1, V, 200), device=dev)
    table = torch.arange(1, 33, **i32)[None]  # 512 tokens: (512 + 256) % 128 == 0
    plain_attn = {"token": paged._paged_attention_token, "layer": paged._paged_attention_dual}
    kvh, hd = cfg.num_kv_heads, cfg.head_dim

    def quantized_copy(t, dt):
        """A pool tensor [..., KV*D] as quantize_kv stores it: (values, [..., KV])."""
        q, s = quantize_kv(t.reshape(*t.shape[:-1], kvh, hd), dt)
        return q.reshape(t.shape), s[..., 0]

    def half_steps(x, stored, scale, dt):
        """The largest |dequantized - x| of the stored rows, in half
        quantization steps of each value (int8: the scale; fp8: the
        format's spacing at x / scale, subnormals included)."""
        y = x.float() / scale
        if dt == "int8":
            step = torch.ones_like(y)
        else:
            mbits, emin = {"fp8_e4m3": (3, -6), "fp8_e5m2": (2, -14)}[dt]
            step = torch.exp2(torch.floor(torch.log2(y.abs().clamp_min(2.0 ** emin))) - mbits)
        err = (stored.float() * scale - x.float()).abs()
        return float((err / (scale * step / 2 * (1 + 1e-5) + x.float().abs() * 1e-6)).max())

    attn_cos, written = {}, {}
    quantize_fn = paged.quantize_kv
    for layout in ("token", "layer"):
        runs, forced = {}, None
        for name, dt, af in (("bf16 kernels", "bf16", None), ("bf16", "bf16", plain_attn[layout]),
                             ("int8", "int8", None), ("fp8_e4m3", "fp8_e4m3", None),
                             ("fp8_e5m2", "fp8_e5m2", None)):
            pools = pools_for(layout, dt, 40)
            fed = []  # the K/V rows this run's paged_forward quantizes, per call
            paged.quantize_kv = lambda x, d: fed.append(x.detach().clone()) or quantize_fn(x, d)
            logits, pools = paged.paged_forward(params, cfg, prompt, pools, table, 0 * one,
                                                200 * one, slot_ids=slot0, attention_fn=af)
            steps, toks = [logits[0]], []
            for k in range(24):
                toks.append(forced[k] if forced else int(steps[-1].argmax()))
                step_af = af
                if name == "bf16" and k < 8:
                    # the quantized histories of this bf16 pool, and each
                    # layer's attention over them beside the bf16 one
                    qpools = {d: [quantized_copy(t, d) for t in pools if t is not None]
                              for d in ("int8", "fp8_e4m3", "fp8_e5m2")}

                    def step_af(q, kc, vc, hist, sc, layer, *rest, qpools=qpools):
                        want = af(q, kc, vc, hist, sc, layer, *rest)
                        for d, parts in qpools.items():
                            if layout == "layer":
                                (main, ms), (stg, ss) = parts
                                got = af(q, kc, vc, main, stg[slot0.long()], layer, *rest,
                                         main_scale=ms, staging_scale_b=ss[slot0.long()])
                            else:
                                ((rows_q, rows_s),) = parts
                                got = af(q, kc, vc, rows_q.view(-1, *rows_q.shape[2:]),
                                         rows_s.view(-1, *rows_s.shape[2:]), layer, *rest)
                            a, b = got.double().flatten(), want.double().flatten()
                            c = float(a @ b / (a.norm() * b.norm()))
                            key = f"{layout} {d}"
                            attn_cos[key] = min(attn_cos.get(key, 1.0), c)
                        return want
                logits, pools = paged.paged_forward(
                    params, cfg, torch.tensor([[toks[-1]]], device=dev), pools, table,
                    (200 + k) * one, one, slot_ids=slot0, attention_fn=step_af)
                steps.append(logits[0])
            sync()
            paged.quantize_kv = quantize_fn
            forced = forced or toks
            runs[name] = torch.stack(steps).double()
            if dt != "bf16":
                # the whole history this run wrote (the prompt's first chunk,
                # then 24 decode rows through staging and two page flushes on
                # the layer layout) against its own rows: quantize_kv's bytes
                # and scales, and each value within half a quantization step
                own = torch.cat([fed[0][0, :200]] + [f[0] for f in fed[1:]])  # [224, 2L, KV, D]
                vals, scales = rows(pools, layout, 224)
                q, sc = quantize_fn(own, dt)
                exact = (torch.equal(vals.view(torch.uint8),
                                     q.reshape(vals.shape).view(torch.uint8))
                         and torch.equal(scales, sc.reshape(scales.shape)))
                worst = half_steps(own, vals.reshape(own.shape), scales[..., None], dt)
                written[f"{layout} {name}"] = dict(bytes_equal=exact, half_steps=worst)
                if not exact or worst > 1.0:
                    fail(f"heads_kv: the {layout} {name} pool after 24 decode steps does not "
                         f"hold its own K/V rows: bytes equal {exact}, {worst} half steps")
        del pools
        ref = runs["bf16"]
        for name in ("bf16 kernels", "int8", "fp8_e4m3", "fp8_e5m2"):
            got = runs[name]
            if name != "bf16 kernels" and not torch.equal(got[0], ref[0]):
                fail(f"heads_kv: the {layout} {name} pool's prompt logits differ from the bf16 "
                     "pool's (the chunk reads no history)")
            cos = (got * ref).sum(-1) / (got.norm(dim=-1) * ref.norm(dim=-1))
            quant[f"{layout} {name}"] = dict(
                min_cos=float(cos.min()), max_abs=float((got - ref).abs().max()),
                top1_agree=float((got.argmax(-1) == ref.argmax(-1)).double().mean()))
    pool_bytes = {}
    for dt in ("bf16", "int8", "fp8_e4m3", "fp8_e5m2"):
        for layout in ("layer", "token"):
            p = (PagedKV.zeros_dual(cfg, 1024, 16, 8, dt, device=dev) if layout == "layer"
                 else PagedKV.zeros(cfg, 1024, 16, dt, device=dev))
            pool_bytes[f"{layout} {dt}"] = p.nbytes
            del p
    no_attn = {}
    for dt, layout in (("int8", "auto"), ("fp8_e5m2", "layer")):
        zero()
        eng = engine(kv_dtype=dt, kv_layout=layout, flash_decode=True)
        run(eng, [(rng.integers(1, V, 512).tolist(), SamplingParams(max_new_tokens=24)),
                  (rng.integers(1, V, 300).tolist(), SamplingParams(max_new_tokens=24))])
        got = launches()
        no_attn[f"{eng.kv_layout} {dt}"] = got
        if any(got[c.__name__] for c in attn_kernels):
            fail(f"heads_kv: K3, K4 or K6 launched on a {dt} pool: {json.dumps(got)}")
        if not all(got[c.__name__] for c in counters if c not in attn_kernels):
            fail(f"heads_kv: K1's GEMV and GEMM and K2 did not all launch on a {dt} pool: "
                 f"{json.dumps(got)}")
        del eng
    out["quantized"] = dict(attention_cosine=attn_cos, logits_cosine=quant,
                            pool_bytes=pool_bytes, launches=no_attn, written=written)
    low = {k: v for k, v in attn_cos.items() if v < 0.998 and "e5m2" not in k}
    if low or len(attn_cos) != 6:
        fail(f"heads_kv: decode attention over quantized KV against bf16 below the "
             f"reference's cosine 0.998: {attn_cos}")
    # the teacher-forced logits end to end: floors below this card's readings
    # (bf16 kernels 0.9925, int8 0.9880, fp8_e4m3 0.9816, fp8_e5m2 0.9657 on
    # random 30-layer weights); a fault in a quantized write or its scales
    # takes the cosine far lower
    floors = {"bf16 kernels": 0.985, "int8": 0.98, "fp8_e4m3": 0.97, "fp8_e5m2": 0.95}
    low = {k: v["min_cos"] for k, v in quant.items() if v["min_cos"] < floors[k.split(" ", 1)[1]]}
    if low or len(quant) != 8 or len(written) != 6:
        fail(f"heads_kv: teacher-forced decode logits against bf16 below their cosine floors "
             f"{floors}: {low}")

    # ---- the token-major layout, bf16: K3 and K4's contiguous form
    tpool = PagedKV.zeros(cfg, 1024, 16, "bf16", device=dev).kv
    two_l, kvd = 2 * L, cfg.num_kv_heads * cfg.head_dim
    k3 = []
    for n in (8, 512):
        sets = []
        for _ in range(8):
            pos = torch.randperm(1023 * 16, device=dev)[:n] + 16
            sets.append((torch.randn(n, two_l, kvd, device=dev).to(torch.bfloat16),
                         (pos // 16).to(torch.int32), (pos % 16).to(torch.int32)))
        vals, ids, offs = sets[0]
        a = kvu.kv_write(tpool.clone(), vals, ids, offs)
        if not torch.equal(a, kvu.kv_write_plain(tpool.clone(), vals, ids, offs)):
            fail(f"heads_kv: K3's token-major write of {n} rows differs from its plain version")
        del a
        cyc = Cycle(8)
        flat = tpool.view(1024 * 16, -1)

        def arg():
            return sets[cyc()]

        def lib():
            v, i, o = arg()
            return flat.index_copy_(0, i.long() * 16 + o.long(), v.view(v.shape[0], -1))

        ms = graph_ms(lambda: kvu.kv_write(tpool, *arg()))
        plain_ms, _ = cuda_ms(lambda: kvu.kv_write_plain(tpool, *arg()))
        lib_ms, _ = cuda_ms(lib)
        b_ms, b_by = bound(2 * vals.numel() * 2 + 8 * n, 0, "bf16")
        k3.append(dict(shape=f"token-major pool [1024, 16, {two_l}, {kvd}], {n} rows",
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       library="index_copy_", bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0))
        del sets
    del tpool
    # a 512-token chunk after 512 tokens over a 1024-token table (64 pages)
    tpools = PagedKV.zeros(cfg, 80, 16, "bf16", device=dev)
    table = torch.arange(1, 65, **i32)[None]
    seen = []
    k4_fn = paged.flash_paged_prefill
    paged.flash_paged_prefill = lambda *a, **k: seen.append((a, k)) or k4_fn(*a, **k)
    try:
        per_chunk = []
        for c in range(2):
            toks = torch.as_tensor(rng.integers(1, V, (1, 512)), device=dev)
            n0 = fa.flash_paged_prefill.launches
            paged.paged_forward(params, cfg, toks, tpools, table, 512 * c * one, 512 * one,
                                slot_ids=slot0)
            sync()
            per_chunk.append(fa.flash_paged_prefill.launches - n0)
    finally:
        paged.flash_paged_prefill = k4_fn
    if per_chunk != [L, L] or len(seen) != 2 * L:
        fail(f"heads_kv: K4's contiguous form launched {per_chunk} times per 512-token chunk "
             f"on the token layout, expected {L}")
    k4_err = 0.0
    for layer in (0, L - 1):
        (q, kf, vf, kvv, nl), kw = seen[L + layer]
        a, b = fa.flash_paged_prefill(q, kf, vf, kvv, nl, **kw), fa.flash_paged_prefill_plain(
            q, kf, vf, kvv, nl, **kw)
        k4_err = max(k4_err, float((a.float() - b.float()).abs().max()))
    if k4_err > 3e-2:
        fail(f"heads_kv: K4's contiguous form on the token layout is {k4_err} from its plain "
             "version (bar 3e-2)")
    (q, kf, vf, kvv, nl), kw = seen[L]
    T = kw["hist_len"]
    ms = graph_ms(lambda: fa.flash_paged_prefill(q, kf, vf, kvv, nl, **kw))
    plain_ms, _ = cuda_ms(lambda: fa.flash_paged_prefill_plain(q, kf, vf, kvv, nl, **kw),
                          iters=5, warmup=1)
    col = torch.arange(T + 512, device=dev)
    rowi = torch.arange(512, device=dev)[:, None]
    mask = torch.where(col[None] < T, col[None] < 512, (col - T)[None] <= rowi)[None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = q.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2)
    lib_ms, _ = cuda_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True))
    b_ms, b_by = fp_bench.bound(512, [512], [512])
    k4 = dict(shape=f"contiguous form on the token layout: S=512 after 512, table {T} tokens",
              ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library="SDPA",
              bound_ms=b_ms, bound_by=b_by, max_abs_err=k4_err)
    del seen, tpools, q, kf, vf, qs, ks, vs
    # the engine on the token layout against the default run
    zero()
    trec = LogitsRecorder()
    with trec.on(engine(kv_layout="token")) as eng:
        if eng.kv_layout != "token":
            fail("heads_kv: kv_layout='token' resolved to " + eng.kv_layout)
        tok_run = run(eng, [(p, greedy) for p in prompts])
    tok_launch = launches()
    del eng
    if not (tok_launch["kv_write"] and tok_launch["flash_paged_prefill"]):
        fail(f"heads_kv: the token layout's engine did not launch K3 and K4: {tok_launch}")
    token_parts = [parted_at_near_tie("token layout", p, r, b, trec.runs[0], base_logits)
                   for p, r, b in zip(prompts, tok_run, base)]
    results["kv_write/token"] = dict(k3[1], launches=tok_launch["kv_write"])
    results["flash_paged_prefill/contiguous"] = dict(k4, launches=tok_launch["flash_paged_prefill"])

    # ---- fp16 and f32 pools: the layer layout with flash_decode (K3, K4
    # over the pool, K6) against the default run, the token layout (K3, K4's
    # contiguous form) against the bf16 token layout's
    wide, wide_launch = {}, {}
    for dt in ("fp16", "f32"):
        for layout, over, want, want_logits in (
                ("layer", dict(flash_decode=True), base, base_logits),
                ("token", {}, tok_run, trec.runs[0])):
            zero()
            wrec = LogitsRecorder()
            with wrec.on(engine(kv_dtype=dt, kv_layout=layout, **over)) as eng:
                if eng.kv_layout != layout or eng.pools.kv_dtype_name != dt:
                    fail(f"heads_kv: kv_dtype={dt} kv_layout={layout} built "
                         f"{eng.pools.kv_dtype_name} on {eng.kv_layout}")
                got = run(eng, [(p, greedy) for p in prompts])
            del eng
            got_launch = launches()
            need = attn_kernels if layout == "layer" else attn_kernels[:2]
            if not all(got_launch[c.__name__] for c in need):
                fail(f"heads_kv: the {layout} layout's engine on a {dt} pool did not launch "
                     f"{[c.__name__ for c in need]}: {json.dumps(got_launch)}")
            wide[f"{layout} {dt}"] = [
                parted_at_near_tie(f"{layout} {dt} pool", p, r, b, wrec.runs[0], want_logits)
                for p, r, b in zip(prompts, got, want)]
            wide_launch[f"{layout} {dt}"] = got_launch
            del wrec
    out["wide"] = dict(leading_tokens_equal=wide, launches=wide_launch)

    # ---- the window
    wrec = LogitsRecorder()
    with wrec.on(engine(attention_fn=paged._paged_attention_dual)) as eng:
        full = run(eng, [(p, greedy) for p in prompts])
    with wrec.on(engine(attn_window=2048)) as eng:
        if getattr(eng._attention_fn, "window", None) != 2048:
            fail("heads_kv: attn_window=2048 did not install the window attention")
        wide = run(eng, [(p, greedy) for p in prompts])
    del eng
    window_parts = [parted_at_near_tie("window >= max_context", p, r, b, wrec.runs[1],
                                       wrec.runs[0])
                    for p, r, b in zip(prompts, wide, full)]
    weng = engine(attn_window=256)
    batch = [weng.submit(rng.integers(1, V, 700).tolist(), SamplingParams(max_new_tokens=24))
             for _ in range(4)]
    while not all(r.output_ids for r in batch):
        weng.step()
    g0, s0 = weng._attention_fn.gathered_pages, weng.stats["decode_steps"]
    while not all(r.finished for r in batch):
        weng.step()
    sync()
    pages_per = ((weng._attention_fn.gathered_pages - g0)
                 / (L * (weng.stats["decode_steps"] - s0) * len(weng.slots)))
    table_width = weng._mp_bucket
    if not all(len(r.output_ids) == 24 for r in batch) or not pages_per < table_width:
        fail(f"heads_kv: the 256-token window gathered {pages_per} pages per row, layer and "
             f"step of a {table_width}-page table")
    del weng
    print(f"heads_kv: 2B, {L} layers ({smi}): exact head (k 64): {json.dumps(out['exact'])}; "
          f"sampled + penalised under the exact head = default; int8_logits "
          f"{json.dumps(out['int8_logits'])}; native runtime = Python classes "
          f"{json.dumps(out['native'])}; quantized pools {json.dumps(out['quantized'])}; "
          f"token layout: K3 {json.dumps(k3)}, K4 contiguous {json.dumps(k4)}, streams agree "
          f"with the layer layout's for {token_parts} of 32 tokens, launches "
          f"{json.dumps(tok_launch)}; fp16 and f32 pools (layer layout with flash_decode "
          f"against the default run, token layout against the bf16 token layout's): "
          f"{json.dumps(out['wide'])}; window 2048 agrees with the full dual attention for "
          f"{window_parts} of 32 tokens; window 256 on 700-token prompts: {pages_per} pages "
          f"gathered per row, layer and decode step of a {table_width}-page table; "
          f"{time.perf_counter() - t_phase} s")
    return {"token": tok_launch, **wide_launch}


def phase_spec(params, cfg, dev, counters, smi):
    """Speculative decoding at 2B width and depth: the engine phase's
    EngineConfig with ``speculative_k=4``, ``decode_burst=16`` and the
    adaptive cutoff off (``spec_min_accept=0``, so every burst speculates),
    beside the same engine without speculation, on eight greedy requests of
    48 tokens (five prompts looping a 16-token pattern, of which two end
    where a 5-token window would cross a page and is clamped; three random).
    Every check is required:

    - exact: on the weights with the o and down projections set to ternary
      zeros (the logits depend on the current token alone, so the verify's
      rounding against the decode step's cannot part them) the spec streams
      equal the plain streams token for token; drafts are accepted; the
      emitted tokens match the spec counters (each drafted step emits its
      accepted drafts + 1, a finishing request drops at most k of them);
      from the first step after every prompt is prefilled to the last, the
      plain burst launches no K1 GEMM and the spec burst launches K1's GEMM
      (8 slots x 5 rows) and K3; device ms (profiled) and wall per burst step
      of both, and tokens per step;
    - full weights: where a spec stream parts from the plain stream, each
      token is its own run's pick and the two runs' logits there lie within
      twice the decode-against-verify bound (the largest distance between
      the two runs' logits at the positions before any parting, where both
      ran on the same tokens), at a near-tie (``near_tie``); the first
      parting per request is printed;
    - batch 1: ``spec_decode_window`` (k 4, 16 steps) on the fused kernels
      (``make_linear_fused()``, as ``bench/decode.py --spec``) after a
      64-token prompt: each step's 5-row verify launches K1 at 5 rows (the
      GEMV) twice and K2 once per layer, and no K1 GEMM.
    Returns the spec run's launches per serving kernel."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.models.bitnet import KVCache, forward
    from wrinklefree_tpu_torch.models.spec_decode import spec_decode_window
    from wrinklefree_tpu_torch.ops import sampling
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize
    K, k, n_new = 16, 4, 48
    ecfg = EngineConfig(max_batch_slots=8, page_size=16, num_pages=1024, max_context=2048,
                        prefill_buckets=(32, 128, 512), decode_burst=K, spec_min_accept=0.0)
    L, V = cfg.num_layers, cfg.vocab_size
    rng = np.random.default_rng(20)
    pat = rng.integers(1, V, 16).tolist()
    # first decode positions 128, 71, 30 (a 2-token window), 45 (3), 60
    prompts = [pat * 8, pat * 4 + pat[:7], (pat * 2)[:30], (pat * 3)[:45], pat[:12] * 5,
               rng.integers(1, V, 17).tolist(), rng.integers(1, V, 200).tolist(),
               rng.integers(1, V, 94).tolist()]
    greedy = SamplingParams(max_new_tokens=n_new)
    everything = {c.__name__: c for c in counters}
    k1_tiled = "ternary_matmul_stacked_fused/tiled"

    def zero():
        for c in everything.values():
            c.launches = 0

    def launches():
        return {n: c.launches for n, c in everything.items()}

    def run(p, spec_k, rec=None, timed=False):
        """The eight requests on a fresh engine; with ``timed``, the decode
        steps after every prompt is prefilled profiled and counted."""
        eng = Engine(p, cfg, dataclasses.replace(ecfg, speculative_k=spec_k), device=dev)
        with rec.on(eng) if rec is not None else contextlib.nullcontext():
            reqs = [eng.submit(pr, greedy) for pr in prompts]
            while any(r.slot < 0 or r.pending for r in reqs):
                eng.step()
            sync()
            steps0, toks0, t0 = (eng.stats["decode_steps"], eng.stats["decode_tokens"],
                                 time.perf_counter())
            zero()
            with profile(activities=[ProfilerActivity.CUDA]) if timed else \
                    contextlib.nullcontext() as prof:
                while any(not r.finished for r in reqs):
                    eng.step()
                sync()
        wall = time.perf_counter() - t0
        for r in reqs:
            if r.finish_reason != "length" or len(r.output_ids) != n_new:
                fail(f"spec: a request finished {r.finish_reason!r} with {len(r.output_ids)} "
                     "tokens")
        steps = eng.stats["decode_steps"] - steps0
        out = dict(tokens=[r.output_ids for r in reqs], seeds=[r.seed for r in reqs],
                   stats=dict(eng.stats), steps=steps,
                   launches=launches(), wall_ms=wall / steps * 1e3,
                   tokens_per_step=(eng.stats["decode_tokens"] - toks0) / steps)
        if timed:
            out["device_ms"] = busy_us(device_events(prof)) / 1e3 / steps
        return out

    # ---- exact: the o and down projections zeroed
    layers = dict(params["layers"])
    for name in ("o_qw", "down_qw"):
        layers[name] = torch.full_like(layers[name], 0x55)
    zeroed = {**params, "layers": layers}
    plain = run(zeroed, 0, timed=True)
    spec = run(zeroed, k, timed=True)
    del zeroed, layers
    if spec["tokens"] != plain["tokens"]:
        j = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
             for x, y in zip(spec["tokens"], plain["tokens"])]
        fail(f"spec: on the zeroed o/down weights the spec streams part from the plain ones at "
             f"{j}")
    st = spec["stats"]
    drafted, accepted, emitted = st["spec_drafted"], st["spec_accepted"], st["decode_tokens"]
    if accepted <= 0:
        fail("spec: no draft was accepted on the looping streams")
    if emitted != sum(len(t) for t in spec["tokens"]) - len(prompts) or not (
            emitted <= drafted + accepted <= emitted + len(prompts) * k):
        fail(f"spec: {emitted} tokens emitted by the bursts against {drafted} drafted steps and "
             f"{accepted} accepted drafts")
    if plain["launches"][k1_tiled] != 0 or spec["launches"][k1_tiled] <= 0 or \
            spec["launches"]["kv_write"] <= 0:
        fail(f"spec: decode launches plain {plain['launches']}, spec {spec['launches']}: the "
             "verify must run K1's GEMM and K3, the plain burst no GEMM")

    # ---- full weights: partings at near-ties only
    rec = LogitsRecorder()
    full_p = run(params, 0, rec)
    full_s = run(params, k, rec)
    l_plain, l_spec = rec.runs
    parts = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
             for x, y in zip(full_s["tokens"], full_p["tokens"])]
    if full_s["seeds"] != full_p["seeds"]:
        fail("spec: the two runs' requests have different seeds")
    seeds = full_p["seeds"]
    # the decode-against-verify bound: both runs' logits on the same tokens
    shared = [float((l_spec[(sd, len(pr) + i)] - l_plain[(sd, len(pr) + i)]).abs().max())
              for pr, sd, j in zip(prompts, seeds, parts)
              for i in range(1, n_new if j is None else j)]
    if not shared:
        fail("spec: no decode position before the partings to measure the bound on")
    bound_fv = max(shared)
    apart = []
    for pr, sd, j, got, want in zip(prompts, seeds, parts, full_s["tokens"], full_p["tokens"]):
        if j is None:
            continue
        lp, ls = l_plain[(sd, len(pr) + j)], l_spec[(sd, len(pr) + j)]
        dist = float((ls - lp).abs().max())
        why = near_tie(sampling, lp, ls, greedy, j, want[j], got[j], dist)
        apart.append(dist)
        if dist > 2 * bound_fv or why:
            fail(f"spec: on the full weights a {len(pr)}-token prompt's spec stream parts at token "
                 f"{j}: logits {dist} apart (bound {bound_fv}); {why}")
    del rec, l_plain, l_spec

    # ---- batch 1: the 5-row verify on the fused kernels
    lf = tc.make_linear_fused()
    T = 64 + 16 * (k + 1) + 8
    cache = KVCache.zeros(cfg, 1, T, device=dev)
    prompt = torch.ones((1, 64), dtype=torch.long, device=dev)
    logits, cache = forward(params, cfg, prompt, cache, torch.zeros(1, dtype=torch.int32,
                                                                    device=dev),
                            linear_fn=lf, logits_all=False)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    hist = torch.zeros((1, T), dtype=torch.int32, device=dev)
    hist[:, :64] = 1
    hist[0, 64] = tok[0]
    b1 = [tc.ternary_matmul_stacked_fused, tc.mlp_block_megakernel]
    for c in b1:
        c.launches = 0
    tc.ternary_matmul_stacked_fused.tiled_launches = 0
    sync()
    t0 = time.perf_counter()
    _, counts, *_ = spec_decode_window(params, cfg, tok, cache, torch.full(
        (1,), 64, dtype=torch.int32, device=dev), hist, steps=16, k=k, linear_fn=lf)
    b1_tokens = int(counts.sum())  # the window's one host read
    b1_ms = (time.perf_counter() - t0) * 1e3
    b1_launch = {c.__name__: c.launches for c in b1}
    if (b1_launch["ternary_matmul_stacked_fused"] != 2 * L * 16
            or b1_launch["mlp_block_megakernel"] != L * 16
            or tc.ternary_matmul_stacked_fused.tiled_launches != 0):
        fail(f"spec: the batch-1 window launched {b1_launch} (K1 GEMM "
             f"{tc.ternary_matmul_stacked_fused.tiled_launches}); 16 steps of 5 rows want K1 "
             f"{2 * L * 16} times at 5 rows, K2 {L * 16}")
    del cache, hist
    print(f"spec: 2B, {L} layers ({smi}), 8 greedy requests x {n_new} tokens, k {k}, bursts of "
          f"{K}: zeroed o/down: spec streams = plain streams; {drafted} drafted steps, {accepted} "
          f"accepted drafts ({accepted / (drafted * k)} per drafted token), {emitted} tokens "
          f"emitted; after the last prefill, per burst step: plain {plain['device_ms']} device "
          f"ms, {plain['wall_ms']} ms wall (profiled), {plain['tokens_per_step']} tokens over "
          f"all slots; spec {spec['device_ms']} device ms, {spec['wall_ms']} ms wall, "
          f"{spec['tokens_per_step']} tokens; decode launches "
          f"plain {json.dumps(plain['launches'])}, spec {json.dumps(spec['launches'])}; full "
          f"weights: first parting per request {parts} of {n_new}, the parted logits {apart} "
          f"apart (decode-against-verify bound {bound_fv}, doubled), each a near-tie; spec "
          f"accepted {full_s['stats']['spec_accepted']} of {full_s['stats']['spec_drafted']} "
          f"drafted steps; batch 1: 16 steps of 5 rows on the fused kernels emitted {b1_tokens} "
          f"tokens in {b1_ms} ms wall, launches {json.dumps(b1_launch)}; "
          f"{time.perf_counter() - t_phase} s")
    return spec["launches"]


def phase_sparsity(cfg, dev, smi):
    """Activation and attention sparsity at 2B width and depth: a 512-token
    prefill ``forward`` on unfused random weights (seed 0) under
    ``inference_safe`` activation sparsity (top-k, 30% zeroed) with each
    attention mode (none; top_k 64; threshold 1e-3; window 256 with 1 global
    token and stride 64, ``configs/attention/window.yaml``; dynamic 0.1-0.5,
    ``configs/attention/dynamic.yaml``), through ``make_linear()``'s K7 (the
    GEMM at 512 rows) and through the plain linear
    (``make_linear(ternary_matmul_plain)``) on the card. K7 equals its plain
    version bit for bit and the rest of the forward is the same code, so the
    bar is equality: the two runs' logits must be bit-equal. K7 must launch
    (7 linears x 30 layers per mode). Each mode's cosine to the dense forward
    is printed only: on random weights it says nothing of quality."""
    import torch

    from wrinklefree_tpu_torch.models.bitnet import KVCache, forward, init_params
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.activation_sparsity import ActivationSparsityConfig
    from wrinklefree_tpu_torch.ops.sparse_attention import (AttentionSparsityConfig,
                                                            AttentionSparsityMode)

    t_phase = time.perf_counter()
    S = 512
    params = init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(21)
    toks = torch.randint(1, cfg.vocab_size, (1, S), generator=g, device=dev)
    act = ActivationSparsityConfig.inference_safe()
    M = AttentionSparsityMode
    modes = {"none": None,
             "top_k": AttentionSparsityConfig(mode=M.TOP_K),
             "threshold": AttentionSparsityConfig(mode=M.THRESHOLD),
             "window": AttentionSparsityConfig(mode=M.WINDOW, window_size=256, global_tokens=1,
                                               stride=64),
             "dynamic": AttentionSparsityConfig(mode=M.DYNAMIC, min_keep_frac=0.1,
                                                max_keep_frac=0.5)}
    kernel, plain = tc.make_linear(), tc.make_linear(tc.ternary_matmul_plain)

    def run(lf, act_cfg, attn_cfg):
        cache = KVCache.zeros(cfg, 1, S, device=dev)
        out, _ = forward(params, cfg, toks, cache, torch.zeros(1, dtype=torch.int32, device=dev),
                         linear_fn=lf, act_sparsity=act_cfg, attn_sparsity=attn_cfg)
        return out[0]

    def cosine(a, b):
        return float((a * b).sum() / (a.norm() * b.norm()))

    dense = run(kernel, None, None)
    cos, k7 = {}, {}
    for name, attn in modes.items():
        tc.ternary_matmul_stacked.launches = tc.ternary_matmul_stacked.tiled_launches = 0
        ker = run(kernel, act, attn)
        k7[name] = (tc.ternary_matmul_stacked.launches, tc.ternary_matmul_stacked.tiled_launches)
        pla = run(plain, act, attn)
        if k7[name] != (7 * cfg.num_layers,) * 2:
            fail(f"sparsity ({name}): K7 launched {k7[name]} times (GEMM), want "
                 f"{7 * cfg.num_layers} at {S} rows")
        if not torch.isfinite(ker).all() or not torch.equal(ker, pla):
            fail(f"sparsity ({name}): the K7 logits differ from the plain linear's by "
                 f"{float((ker - pla).abs().max())} (bar: bit-equal)")
        cos[name] = cosine(ker, dense)
        del ker, pla
    torch.cuda.synchronize()
    print(f"sparsity: 2B, {cfg.num_layers} layers ({smi}), a {S}-token prefill under "
          f"inference_safe activation sparsity: K7 logits bit-equal to the plain linear's in "
          f"every attention mode, K7 launches (all, GEMM) {json.dumps(k7)}; cosine to the dense "
          f"forward (printed only) {json.dumps(cos)}; {time.perf_counter() - t_phase} s")
    return sum(n for n, _ in k7.values())


class LogitsRecorder:
    """Records, while ``on(eng)``, the logits the serving programs compute
    for ``eng``'s requests: ``runs[-1][(seed, n)]`` is the f32 row [V] after
    n tokens of the request with that seed (the logits its token n is drawn
    from). It wraps ``programs.paged_forward`` and reads each call's slots and
    lengths on the host; ``on(None)`` records nothing. A speculative verify
    ([B, S, V] logits) records each of a row's ``new_len`` positions; a later
    window overwrites the rows that followed a rejected draft, so the last
    row kept for n is the one computed on the emitted tokens."""

    def __init__(self):
        self.runs = []

    @contextlib.contextmanager
    def on(self, eng):
        from wrinklefree_tpu_torch.engine import programs

        forward = programs.paged_forward
        run = {}

        def recorded(params, cfg, tokens, pools, page_table, seq_len, new_len, **kw):
            logits, pools = forward(params, cfg, tokens, pools, page_table, seq_len, new_len,
                                    **kw)
            ns = len(eng.slots)
            for b, (slot, sl, nl) in enumerate(zip(kw["slot_ids"].tolist(), seq_len.tolist(),
                                                   new_len.tolist())):
                req = eng.slots[slot] if slot < ns else None
                if req is None:
                    continue
                if logits.dim() == 2:
                    run[(req.seed, sl + nl)] = logits[b].float().clone()
                else:
                    for j in range(nl):
                        run[(req.seed, sl + j + 1)] = logits[b, j].float().clone()
            return logits, pools

        if eng is not None:
            programs.paged_forward = recorded
            self.runs.append(run)
        try:
            yield eng
        finally:
            programs.paged_forward = forward


def near_tie(sampling, l_a, l_b, sp, step, tok_a, tok_b, dist):
    """Why ``tok_a`` (drawn from logits ``l_a``) and ``tok_b`` (from ``l_b``,
    ``dist`` apart at most) are not two picks of one near-tie, or "": each
    must be its logits' pick under the request's draw for ``step``, and the
    two must lie within 2 ``dist`` of each other in ``l_a`` (the sampler's
    noise goes by candidate rank, and a rounding can trade their ranks), or
    the two best perturbed scores of ``l_a`` (masked logits / T + noise)
    within 2 ``dist`` / T."""
    import numpy as np
    import torch

    T = sp.temperature
    c = min(sampling.NUCLEUS_CANDIDATES, l_a.shape[0])
    noise = None
    if T > 0:
        keys = sampling.per_request_keys(torch.tensor([sp.seed], device=l_a.device),
                                         torch.tensor([step], device=l_a.device))
        noise = sampling.gumbel(keys, c)
    kw = dict(temperature=T, top_p=sp.top_p, top_k=sp.top_k, min_p=sp.min_p,
              typical_p=sp.typical_p, tfs_z=sp.tfs_z)
    picks = [int(sampling.sample_token(lg[None], noise, **kw)[0]) for lg in (l_a, l_b)]
    if picks != [tok_a, tok_b]:
        return f"the picks under the draw are {picks}, the runs' tokens {[tok_a, tok_b]}"
    if abs(float(l_a[tok_a] - l_a[tok_b])) <= 2 * dist:
        return ""
    if T > 0:
        masked, _ = sampling._filtered_candidates(
            l_a[None], np.asarray([T], np.float32), sp.top_p, sp.top_k, sp.min_p,
            sp.typical_p, sp.tfs_z, c)
        top2 = torch.topk(masked + noise, 2).values[0]
        if float(top2[0] - top2[1]) <= 2 * dist / T:
            return ""
    return f"{tok_a} and {tok_b} are no near-tie at distance {dist}"


def write_hf_dir(params, cfg, path):
    """The port's unfused params as an HF BitNet directory, written with the
    port's safetensors writer: projections ``uint8 [out/4, in]`` (the out
    axis in four planes, value + 1 in bits 2i..2i+1) with an f32
    ``weight_scale`` each, bf16 norms and embedding, and a ``config.json``
    from ``cfg``. Returns the directory."""
    import numpy as np
    import torch

    from wrinklefree_tpu_torch.convert.safetensors_io import BF16, save_file
    from wrinklefree_tpu_torch.models.loader import NORMS, PROJS
    from wrinklefree_tpu_torch.ops.ternary import unpack_ternary

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta, "max_position_embeddings": cfg.max_position,
        "tie_word_embeddings": cfg.tie_word_embeddings, "hidden_act": cfg.mlp_act,
        "model_type": "bitnet" if cfg.sub_norms else "llama"}, indent=2))

    def bits(t):
        return t.to(torch.bfloat16).cpu().view(torch.int16).numpy().view(BF16)

    lay = params["layers"]
    t = {"model.embed_tokens.weight": bits(params["embed"]),
         "model.norm.weight": bits(params["final_norm"])}
    if "lm_head" in params:
        t["lm_head.weight"] = bits(params["lm_head"])
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        for short, sub in NORMS.items():
            t[f"{p}.{sub}"] = bits(lay[short][i])
        for short, sub in PROJS.items():
            w = unpack_ternary(lay[f"{short}_qw"][i]).T  # [out, in] int8
            n, k = w.shape
            e = (w + 1).to(torch.uint8).reshape(4, n // 4, k)
            t[f"{p}.{sub}.weight"] = (e[0] | (e[1] << 2) | (e[2] << 4)
                                      | (e[3] << 6)).cpu().numpy()
            t[f"{p}.{sub}.weight_scale"] = np.asarray(
                [lay[f"{short}_scale"][i].item()], np.float32)
    save_file(t, path / "model.safetensors")
    return path


def same_config(got, want) -> bool:
    """Equal configs, float fields compared in f32 (a GGUF stores them so)."""
    import dataclasses

    import numpy as np

    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    return a.keys() == b.keys() and all(
        np.float32(a[k]) == np.float32(b[k]) if isinstance(b[k], float) else a[k] == b[k]
        for k in b)


def tensor_diffs(got, want, prefix=""):
    """Names of the tensors of ``want`` that ``got`` lacks or holds with
    other bits (dtype, shape or values)."""
    import torch

    out = [] if sorted(got) == sorted(want) else [f"{prefix}keys"]
    for k, w in want.items():
        g = got.get(k)
        if isinstance(w, dict):
            out += tensor_diffs(g or {}, w, f"{prefix}{k}.")
        elif not (isinstance(g, torch.Tensor) and g.dtype == w.dtype and torch.equal(g, w)):
            out.append(prefix + k)
    return out


def phase_load(cfg, dev, counters, smi):
    """Loading weights at 2B width and depth: seed-made params (``init_params``,
    unfused) written under a temporary directory of ``build/`` (removed
    afterwards) as (a) an HF BitNet directory (``write_hf_dir``), (b) the
    packed cache, ``convert_and_save`` of (a), and (c) an i2_s GGUF,
    ``convert_hf_to_gguf`` of (a); each loaded onto the card with the
    port's loaders. Gates: (a) and (b) load bit-equal (``torch.equal``,
    dtype included) to the in-memory params; (c) bit-equal to the in-memory
    params with their norms and embedding passed through f16, which is how
    the GGUF stores every non-projection tensor (the count of values f16
    moved is printed); an ``Engine`` under the engine phase's configuration
    on each loaded set gives the greedy tokens of one on the params it must
    equal, for prompts of 17 and 512 tokens; K1 (with its GEMM), K2, K3 and
    K4 launch in the loaded runs (counters zeroed just before them). Prints
    each format's bytes on disk, its write and load seconds, and the card."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.convert.convert import convert_and_save
    from wrinklefree_tpu_torch.convert.gguf import convert_hf_to_gguf, load_params_gguf
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.models.loader import load_params

    params = init_params(cfg, seed=0, device=dev)  # unfused, as a loader returns them
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (17, 512)]
    ecfg = EngineConfig(max_batch_slots=8, page_size=16, num_pages=1024, max_context=2048,
                        prefill_buckets=(32, 128, 512))

    def tokens(p, c=cfg):
        eng = Engine(p, c, ecfg, device=dev)
        out = [eng.generate(q, SamplingParams(max_new_tokens=16, temperature=0.0)).output_ids
               for q in prompts]
        del eng
        torch.cuda.empty_cache()
        return out

    def f16_stored(p):  # what the GGUF keeps of a non-projection tensor
        return p.float().half().float().to(p.dtype)

    gguf_want = {k: (v if k == "layers" else f16_stored(v)) for k, v in params.items()}
    gguf_want["layers"] = {k: (v if k.endswith(("_qw", "_scale")) else f16_stored(v))
                           for k, v in params["layers"].items()}
    moved = sum(int((f16_stored(v) != v).sum()) for v in
                [params[k] for k in params if k != "layers"]
                + [v for k, v in params["layers"].items() if not k.endswith(("_qw", "_scale"))])
    want_toks = tokens(params)
    gguf_toks = want_toks if moved == 0 else tokens(gguf_want)

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="load_phase_", dir=root))
    report = {}
    try:
        fmts = {}
        t0 = time.perf_counter()
        fmts["hf"] = write_hf_dir(params, cfg, tmp / "hf")
        written = {"hf": time.perf_counter() - t0}
        t0 = time.perf_counter()
        fmts["packed"] = convert_and_save(fmts["hf"], tmp / "packed")
        written["packed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fmts["gguf"] = convert_hf_to_gguf(fmts["hf"], tmp / "model.gguf", quant_type="i2_s")
        written["gguf"] = time.perf_counter() - t0
        for c in counters:
            c.launches = 0
        for name, path in fmts.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "gguf":
                loaded, lcfg = load_params_gguf(path, device=dev)
            else:
                loaded, lcfg = load_params(path, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if not same_config(lcfg, cfg):
                fail(f"load ({name}): config {lcfg} differs from {cfg}")
            bad = tensor_diffs(loaded, gguf_want if name == "gguf" else params)
            if bad:
                fail(f"load ({name}): tensors not bit-equal to the in-memory params: {bad[:8]}")
            got = tokens(loaded, lcfg)
            if got != (gguf_toks if name == "gguf" else want_toks):
                fail(f"load ({name}): greedy tokens differ from the in-memory params'")
            size = sum(f.stat().st_size for f in (path.rglob("*") if path.is_dir() else [path])
                       if f.is_file())
            report[name] = {"bytes": size, "write_s": written[name], "load_s": secs}
            del loaded
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {c.__name__: c.launches for c in counters}
    zero = [k for k, v in launches.items() if v == 0]
    if zero:
        fail(f"load: kernels not launched on the loaded weights: {zero}")
    print(f"load: {cfg.num_layers} layers at H {cfg.hidden_size} ({smi}): (a) HF directory, "
          f"(b) packed cache, (c) i2_s GGUF, each bit-equal to the in-memory params (the "
          f"GGUF's f16 storage moved {moved} values of the norms and embedding, held against "
          f"the same f16 round trip) and giving their greedy tokens for prompts of 17 and 512 "
          f"tokens: {json.dumps(report)}; launches {json.dumps(launches)}")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_server(dev, counters):
    """The port's HTTP server (``server.http.create_server("synth:bitnet_2b")``
    with the engine phase's EngineConfig: BitNet-2B at full width and depth,
    random weights from seed 0, the byte tokenizer), served on a free
    127.0.0.1 port in a thread and driven by the port's own client and
    urllib: /health, /v1/models, /tokenize and /detokenize round trip; a
    greedy /v1/completions whose token ids equal ``Engine.generate`` on the
    same ids (prefix cache reset between them: a radix hit changes tokens on
    random weights, ROADMAP queue 3); the same request streamed, the same
    text; a chat completion; a stop string that trims; /v1/embeddings of
    unit norm and equal to the plain masked mean (``embedding_vs_plain``);
    /metrics; a greedy chat request with logprobs answered 200 with one
    ``choices[0].logprobs.content`` entry per token (16);
    ``run_server_benchmark`` with 16 requests at concurrency 8. Every
    counter in ``counters`` (zeroed just before) must launch. Returns the
    launches."""
    import urllib.request

    import numpy as np
    import torch

    from wrinklefree_tpu_torch.bench.runner import run_server_benchmark
    from wrinklefree_tpu_torch.client import InferenceClient
    from wrinklefree_tpu_torch.client.client import _sse_data
    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.server._web import ServerThread
    from wrinklefree_tpu_torch.server.http import ByteTokenizer, build_app, create_server

    t0 = time.perf_counter()
    ecfg = EngineConfig(max_batch_slots=8, page_size=16, num_pages=1024, max_context=2048,
                        prefill_buckets=(32, 128, 512))
    server = create_server("synth:bitnet_2b", engine_config=ecfg, device=dev)
    eng = server.async_engine.engine
    reqs = []
    submit = eng.submit

    def record(*a, **kw):
        reqs.append(submit(*a, **kw))
        return reqs[-1]

    eng.submit = record
    for c in counters:
        c.launches = 0
    st = ServerThread(build_app(server))
    try:
        url = st.url
        client = InferenceClient(url, timeout=600)

        def post(path, body):
            req = urllib.request.Request(f"{url}{path}", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            return urllib.request.urlopen(req, timeout=600)

        def reset():
            with post("/admin/reset-cache", {}) as r:
                return json.loads(r.read())["dropped_pages"]

        if not client.health() or client.models() != ["synth:bitnet_2b"]:
            fail("server: /health or /v1/models")
        ids = client.tokenize("hello world")
        if client.detokenize(ids) != "hello world" or ids != ByteTokenizer().encode("hello world"):
            fail(f"server: tokenize/detokenize round trip gave {ids}")
        # 600 bytes: a 512-token chunk (the flash prefill) and a 128-token one
        prompt = "".join(chr(33 + (i * 7919) % 90) for i in range(600))
        body = {"model": "m", "prompt": prompt, "max_tokens": 32, "temperature": 0.0,
                "ignore_eos": True}
        reset()
        with post("/v1/completions", body) as r:
            full = json.loads(r.read())
        served = reqs[-1]
        text = full["choices"][0]["text"]
        if (full["choices"][0]["finish_reason"] != "length"
                or full["usage"]["completion_tokens"] != 32 or len(served.output_ids) != 32):
            fail(f"server: greedy completion {full['choices'][0]}, usage {full['usage']}")
        reset()
        want = eng.generate(served.prompt_ids, served.sampling).output_ids
        if want != served.output_ids:
            fail(f"server: served tokens {served.output_ids} differ from Engine.generate's {want}")
        reset()
        with post("/v1/completions", {**body, "stream": True}) as r:
            events = [json.loads(d) for d in _sse_data(r) if d != b"[DONE]"]
        streamed = "".join(e["choices"][0]["text"] for e in events)
        if streamed != text or reqs[-1].output_ids != want:
            fail(f"server: streamed text {streamed!r} differs from the non-streamed {text!r}")
        stop = text[5:8]
        reset()
        with post("/v1/completions", {**body, "stop": stop}) as r:
            cut = json.loads(r.read())["choices"][0]
        if cut["text"] != text[: text.index(stop)] or cut["finish_reason"] != "stop":
            fail(f"server: stop string {stop!r} gave {cut}")
        chat = client.chat([{"role": "user", "content": "hello"}], max_tokens=16,
                           temperature=0.0, ignore_eos=True)
        if len(reqs[-1].output_ids) != 16 or not isinstance(chat, str):
            fail("server: chat completion")
        (emb,) = client.embeddings("hello world")
        norm = float(np.linalg.norm(np.asarray(emb)))
        if len(emb) != 2560 or abs(norm - 1.0) > 1e-3:
            fail(f"server: embedding of {len(emb)} values, norm {norm}")
        emb_check = embedding_vs_plain(post, eng, ByteTokenizer().encode(prompt)[:40])
        with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
            metrics = r.read().decode()
        if "wf_requests_total" not in metrics or "wf_ttft_seconds" not in metrics:
            fail("server: /metrics")
        with post("/v1/chat/completions", {"model": "m", "messages": [
                {"role": "user", "content": "hello"}], "max_tokens": 16, "temperature": 0.0,
                "ignore_eos": True, "logprobs": True, "top_logprobs": 2}) as r:
            lp_content = json.loads(r.read())["choices"][0]["logprobs"]["content"]
        if (len(lp_content) != 16 or reqs[-1].output_ids[0] != reqs[-1].logprobs_seq[0][1][0][0]
                or any(len(e["top_logprobs"]) != 2 or e["logprob"] > 0 for e in lp_content)):
            fail(f"server: logprobs chat gave {len(lp_content)} entries: {lp_content[:2]}")
        bench = run_server_benchmark(url, num_requests=16, max_tokens=32, concurrency=8)
        if bench["total_tokens"] <= 0 or not bench["tokens_per_s"] > 0:
            fail(f"server: run_server_benchmark {bench}")
    finally:
        st.stop()
        server.async_engine.shutdown()
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    zero = [n for n, v in launches.items() if v == 0]
    if zero:
        fail(f"server: kernels not launched on the server path: {zero}")
    stats = {k: v for k, v in eng.stats.items() if k in ("requests", "decode_tokens",
                                                          "prefill_tokens")}
    print(f"server: 2B, {eng.cfg.num_layers} layers: health, models, tokenize round trip; greedy /v1/completions "
          f"of 600 + 32 tokens equal to Engine.generate's; streamed text equal; stop string "
          f"{stop!r} trims; chat; embedding norm {norm}; {emb_check}; /metrics; "
          f"logprobs chat -> 16 logprobs.content entries; "
          f"run_server_benchmark 16 requests x 32 tokens at concurrency 8: "
          f"{bench['tokens_per_s']} tok/s, TTFT p50 {bench['ttft_p50_s']} s; engine {stats}; "
          f"launches {json.dumps(launches)}; {time.perf_counter() - t0} s")
    return launches


# the served embedding against the plain masked mean: cosine and max
# |difference| per component of the unit vectors (the CPU tests' bar)
EMBED_COS, EMBED_TOL = 0.999, 2e-2


def embedding_vs_plain(post, eng, ids):
    """/v1/embeddings of the token ids ``ids`` (40 ids: the 64-token bucket,
    24 padded rows) against the plain masked mean: ``forward(...,
    head_fn=identity)`` on the unpadded ids with the engine's linear, the
    f32 mean of the hidden rows, L2-normalized. Fails past ``EMBED_COS`` /
    ``EMBED_TOL``; reports both and, to show the bar sees the mask, the
    cosine of the mean taken over the padded bucket's 64 rows."""
    import torch

    from wrinklefree_tpu_torch.models.bitnet import KVCache, forward

    with post("/v1/embeddings", {"input": ids}) as r:
        served = torch.tensor(json.loads(r.read())["data"][0]["embedding"])
    cfg, dev = eng.cfg, eng.device

    def pooled(toks, rows):
        cache = KVCache.zeros(cfg, 1, len(toks), device=dev)
        with torch.no_grad():
            hidden, _ = forward(eng.params, cfg, torch.tensor([toks], dtype=torch.int32,
                                                               device=dev), cache,
                                torch.zeros((1,), dtype=torch.int32, device=dev),
                                logits_all=True, head_fn=lambda h, p: h,
                                linear_fn=eng._linear_fn)
        s = hidden[0, :rows].float().mean(0).cpu()
        return s / s.norm()

    want = pooled(ids, len(ids))
    unmasked = pooled(ids + [0] * (64 - len(ids)), 64)
    cos = float(served @ want)
    err = float((served - want).abs().max())
    if not (cos >= EMBED_COS and err <= EMBED_TOL):
        fail(f"server: embedding vs the plain masked mean: cosine {cos}, max abs {err} "
             f"(bars {EMBED_COS}, {EMBED_TOL})")
    return (f"embedding of {len(ids)} ids vs the plain masked mean: cosine {cos}, "
            f"max abs {err} (bars {EMBED_COS}, {EMBED_TOL}; unmasked mean's cosine "
            f"{float(served @ unmasked)})")


def phase_serving_bench(dev, counters):
    """``python -m wrinklefree_tpu_torch.bench.serving`` at a reduced
    scenario (16 streams x 128 prompt x 32 new tokens on 8 slots), in
    process: its JSON line, no kernel build or new program inside its
    measured window, every counter in ``counters`` (zeroed just before)
    launched. Returns the launches."""
    import torch

    from wrinklefree_tpu_torch.bench import serving

    t0 = time.perf_counter()
    for c in counters:
        c.launches = 0
    rep = serving.main(["--streams", "16", "--prompt-len", "128", "--new-tokens", "32",
                        "--slots", "8", "--device", str(dev)])
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    zero = [n for n, v in launches.items() if v == 0]
    if zero:
        fail(f"serving bench: kernels not launched: {zero}")
    if rep["in_window_compiles"] != 0:
        fail(f"serving bench: {rep['in_window_compiles']} builds or new programs in the window")
    if not (rep["decode_tok_s"] > 0 and rep["decode_steps"] > 0):
        fail(f"serving bench: {rep}")
    print(f"serving bench: launches {json.dumps(launches)}; {time.perf_counter() - t0} s")
    return launches


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
    phase_preempt(params, cfg, dev, serving)
    phase_features(params, cfg, dev, serving, smi.splitlines()[0])
    engines = phase_heads_kv(params, cfg, dev, serving, toks, results, smi.splitlines()[0])
    launches["kv_write/token"] = engines["token"]["kv_write"]
    launches["flash_paged_prefill/contiguous"] = engines["token"]["flash_paged_prefill"]
    for dt in ("fp16", "f32"):
        launches[f"flash_paged_prefill/{dt}"] = engines[f"layer {dt}"]["flash_paged_prefill"]
        launches[f"flash_paged_decode/{dt}"] = engines[f"layer {dt}"]["flash_paged_decode"]
        launches[f"flash_paged_prefill/contiguous/{dt}"] = (
            engines[f"token {dt}"]["flash_paged_prefill"])
    torch.cuda.empty_cache()
    phase_spec(params, cfg, dev, serving, smi.splitlines()[0])
    del params
    torch.cuda.empty_cache()
    phase_sparsity(cfg, dev, smi.splitlines()[0])
    torch.cuda.empty_cache()
    phase_load(cfg, dev, serving, smi.splitlines()[0])
    torch.cuda.empty_cache()
    phase_server(dev, serving)
    torch.cuda.empty_cache()
    phase_serving_bench(dev, serving)
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
