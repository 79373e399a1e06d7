#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wrinklefree_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``wrinklefree_tpu_torch/csrc`` and runs eighteen phases at
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
               K6 again on fp16 pools (on the tensor cores: K4 on f16 mma,
               K6's scores on TF32 mma) and f32 pools (TF32 mma on split
               operands: 3xTF32 products, K6's keys in three pieces), and
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
15. longctx  — (in a spawned process of its own: torch.profiler sessions
               late in this long process have come back empty) long
               context (``engine/long_context.py``: ring prefill and
               context-parallel decode) on an NCCL group of one, every
               projection through K7's exact int32 mode: K7 at 16384 rows
               bitwise against its plain version and beside torch._int_mm;
               an ``Engine`` (max_context 2048) serving a 16384-token bf16
               prompt and 16 greedy tokens through the ring path, 210 K7
               launches per forward pass; the f32 model's 4096-token prompt
               against the dense ``forward`` through ``longctx_f32_gate``:
               every layer's attention, the logits against the dense forward
               run with the ring's attention, an exact-attention witness of
               how far rounding moves the logits, and two controls that
               must fail;
16. tp       — tensor parallelism (``phase_tp``): K7 at one rank's shapes;
               2B at tp 2 and 4 with every rank on this card over gloo
               (integer gates and two controls that fail them, greedy
               requests through ``Engine(mesh=...)`` held to the token gate
               against the single device, near-ties only and a
               teacher-forced logit distance under ``TP_DIST_CAP``, with a
               planted control at tp 2 that must fail it; K3, K4, K6 and K7
               launched on every rank, a profiled 8-slot burst (tp 2), four HTTP
               completions at tp 2), Llama-3-8B ternary at 4 layers on
               head-sharded pools, a mesh of one on NCCL;
17. pp_ep    — pipeline and expert parallelism (``phase_pp_ep``), in the tp
               phase's gloo worlds of 2 and 4 ranks after their TP job, held
               to the same functions at one stage / one expert rank on the
               NCCL mesh of one: ``make_pp_forward`` on 2B at 2 stages (2 and
               4 microbatches, B 8, a 256-token prompt, 8 greedy steps) and
               on Llama-3-8B ternary at full depth on 4 stages, every stage's
               logits and cache shard bitwise equal to one stage's, K7
               launched 7 x L/S x M times a stage a forward, the greedy rows
               against ``forward`` on the microbatches' rows under
               ``tp_token_gate``, a planted control
               (stage 1 a tick stale) that must fail both; layer 0's experts
               of the MoE configuration on 1024 tokens at ep 2 and 4
               (``make_ep_moe``: y bitwise ep 1's, within ``EP_REL_BAR`` of
               the dense ``moe_ffn``, a tight-capacity control outside it; the
               dense ``moe_ffn(ep_axis=)`` within the bar); K7 at their shapes;
18. calibrate — (run right after the kernels phase)
               ``bench.calibrate.calibrate()`` (the stream-touch kernel
               chained in CUDA graphs) and the device's busy share of its
               window (median of 5 traced replays, kernel time over the same
               replay's device span), at least 90%.

Each phase prints its wall (``<phase>: phase wall <s> s``). It exits
non-zero on any failure (nothing is caught, nothing falls back) and when
CUDA or the package is missing. The line before the last is a
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

# the H100's published memory rate and dense peaks (tensor cores for int8,
# bf16, fp16 and TF32, CUDA cores for f32), which main() reads from the port's
# one table, wrinklefree_tpu_torch/bench/roofline.py::GPU_SPECS["h100"]
HBM_BYTES_PER_S = None
PEAK_OPS = {}

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
    # K4 and K6 on fp16 and f32 pools (the heads_kv phase's engines): fp16
    # on the tensor cores (k4_prefill<__half> on f16 mma; k6_decode<__half>,
    # its bf16 x fp16 scores on TF32 mma, which holds both exactly, PV on
    # f16 mma), f32 on TF32 mma with each f32 operand split into TF32 pieces
    # (k4_prefill_f32: 3xTF32 products; k6_decode_f32: the bf16 query times
    # each key's three pieces, exact, PV in 3xTF32);
    # K4's pool form on the layer layout, its contiguous form on the token
    # layout
    **{f"{name}/{dt}": {"source": f"wrinklefree_tpu_torch/csrc/{src}",
                        "replaces": f"wrinklefree_tpu/ops/flash_attention.py:{line}"}
       for dt in ("fp16", "f32")
       for name, src, line in (("flash_paged_prefill", "flash_paged_prefill.cu", 219),
                               ("flash_paged_prefill/contiguous", "flash_paged_prefill.cu", 219),
                               ("flash_paged_decode", "flash_decode.cu", 382))},
}


# the unquantized pool types K4 and K6 take (their bars: flash_attention.POOL_BARS)
POOL_TYPES = ("bf16", "fp16", "f32")
# the batch-1 phase's eager window under the profiler: its steps
PROFILED_STEPS = 16
# a plain twin's timing (a few calls: its time is no yardstick)
PLAIN = dict(iters=3, warmup=1)


@contextlib.contextmanager
def phase_wall(name: str):
    """Prints ``<name>: phase wall <s> s`` when the phase ends."""
    t0 = time.perf_counter()
    yield
    print(f"{name}: phase wall {time.perf_counter() - t0} s")


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
    # epilogue; so the GEMM against the GEMV). At 2-7 rows it is checked, not
    # timed (its times follow the row count as at 1 and 8).
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
            if 1 < rows < 8:
                k1_mid.append(dict(shape=f"{name} {k}->{n} rows={rows}",
                                   max_abs_err=d.max().item()))
                continue
            ms, call_ms = cuda_ms(
                lambda: tc.ternary_matmul_stacked_fused(x, qw, lay(), sw, nw, act=act))
            nbytes = rows * kin * 2 + k // 4 * n + n * 4 + k * 2 + rows * n * 2
            b_ms, b_by = bound(nbytes, 2 * rows * k * n, "int8")
            plain_ms, _ = cuda_ms(
                lambda: tc.ternary_matmul_stacked_fused_plain(x, qw, lay(), sw, nw, act=act),
                **PLAIN)
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
    for r in k1_mid:  # checked, not timed
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
            lambda: tc.mlp_block_megakernel_plain(h, gw, dw, lay(), gs, ds, pl, fs), **PLAIN)
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
        plain_ms, _ = cuda_ms(lambda: kvu.kv_write_plain(*set_args()), **PLAIN)
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
    pool of type ``pool`` (all on the tensor cores, f32 in 3xTF32 products;
    q, the chunk and the output of the pool's type too): over contiguous keys
    (a 512-token chunk over a 512-slot history, kv_valid 400, new_len 500:
    the kernels phase's first K4 shape) and over the pool at the engine's
    widest table (page size 16, 128 pages per row): one row of a 512-token
    chunk after 1024 tokens, and four rows of 128-token chunks after
    0/320/1024/1904 tokens; pool shapes at layers 0 and 29. Bar
    (``POOL_BARS``, ``meets_pool_bar``) on each real query row: 3e-2
    absolute in bf16 and fp16 (the kernel rounds probabilities to the pool's
    type against its running max, the plain softmax after normalization),
    on fp16 with ``FP16_EQUAL_SHARE`` of the row bitwise equal, and the
    kernel over the keys rounded to bf16 (an inexact read of them) must fail
    that bar on some row; 2e-5 in f32 (nothing rounds; the f32 sums' order
    differs, and the products are 3xTF32), and the kernel over the keys and
    values rounded to TF32 (one pass, no lo pieces) must fail it on some row.
    At each shape two calls must give
    the same bits, and with NaN in every row the kernel may not read
    (history from kv_valid or seq_lens on, chunk keys from new_len on) the
    real rows must be finite and bitwise equal to the run with zeros there.
    Each shape prints its time, SDPA's over contiguous copies, the plain
    version's, the bound (on f32 the 3xTF32 one and, beside it, the bound on
    f32 FMAs), the query tokens per block and the error."""
    import torch

    from wrinklefree_tpu_torch.bench import flash_prefill as bench
    from wrinklefree_tpu_torch.ops import flash_attention as fa

    L, NH, KV, D, ps = bench.L, bench.NH, bench.KV, bench.D, bench.PS
    if (L, NH, KV, D) != (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim):
        fail("K4: the bench's shapes are not the model's")
    inp = bench.make_inputs(dev, seed=1, pool=pool)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bar = fa.POOL_BARS[pool]["k4"]
    bq = bench.block_q(fa, pool)
    tag = "" if pool == "bf16" else f" {pool}"
    # the control's read of a key (or, on f32, value) array: fp16 keys at
    # bf16, f32 keys and values rounded to TF32 once
    ctl = ((lambda t: t.bfloat16().to(t.dtype)) if pool == "fp16"
           else fa.tf32_round if pool == "f32" else (lambda t: t))
    ctl_v = ctl if pool == "f32" else (lambda t: t)
    control_key = {"fp16": "keys_bf16_equal_share", "f32": "tf32_read_equal_share"}

    def checked(name, run, plain, poisoned, new_lens, keys_bf16):
        """(max abs error, least bitwise equal share) of run() against
        plain() on the real rows, and the most equal share of keys_bf16()
        (fp16: the kernel over the keys rounded to bf16; f32: over the keys
        and values rounded to TF32; each must fail the bar), after the
        determinism and poison checks."""
        name += tag
        a, again, b = run(), run(), plain()
        torch.cuda.synchronize()
        oks, errs, shares = zip(*(fa.meets_pool_bar(a[i, :n], b[i, :n], "k4", pool)
                                  for i, n in enumerate(new_lens)))
        err = max(errs)
        if not (all(torch.isfinite(a[i, :n]).all() for i, n in enumerate(new_lens))
                and all(oks)):
            fail(f"K4 {name}: max abs error {err}, {min(shares)} bitwise equal (bar {bar})")
        if not torch.equal(a, again):
            fail(f"K4 {name}: two calls differ")
        control = None
        if pool != "bf16":
            r16 = keys_bf16()
            oks16, _, shares16 = zip(*(fa.meets_pool_bar(r16[i, :n], b[i, :n], "k4", pool)
                                       for i, n in enumerate(new_lens)))
            if all(oks16):
                fail(f"K4 {name}: the bar passes the kernel over "
                     f"{'keys rounded to bf16' if pool == 'fp16' else 'a TF32-rounded read'}")
            control = max(shares16)
        z, nan = (r() for r in poisoned)
        for i, n in enumerate(new_lens):
            if not (torch.isfinite(nan[i, :n]).all() and torch.equal(nan[i, :n], z[i, :n])
                    and torch.equal(a[i, :n], z[i, :n])):
                fail(f"K4 {name}: the NaN rows past the valid keys changed the output")
        return err, min(shares), control

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
    err, share, keys_bf16 = checked(
        "contiguous", lambda: fa.flash_paged_prefill(q, kf, vf, kvv, nl, hist_len=T),
        lambda: fa.flash_paged_prefill_plain(q, kf, vf, kvv, nl, hist_len=T),
        [lambda f=f: fa.flash_paged_prefill(q, *f, kvv, nl, hist_len=T) for f in fills],
        [c["new_len"]],
        lambda: fa.flash_paged_prefill(q, ctl(kf), ctl_v(vf), kvv, nl, hist_len=T))
    del fills
    ms, call_ms = cuda_ms(lambda: fa.flash_paged_prefill(q, kf, vf, kvv, nl, hist_len=T))
    plain_ms, _ = cuda_ms(lambda: fa.flash_paged_prefill_plain(q, kf, vf, kvv, nl, hist_len=T),
                          **PLAIN)
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
                     **bench.fma_bound(S, [c["kv_valid"]], [c["new_len"]], pool),
                     bq=bq, max_abs_err=err, bitwise_equal_share=share,
                     deterministic=True, nan_rows_unread=True,
                     **({control_key[pool]: keys_bf16} if pool != "bf16" else {})))
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
        err, share, keys_bf16 = 0.0, 1.0, 0.0
        for layer in (0, L - 1):
            def poisoned(fill, layer=layer, kv_=None):
                for i, n in enumerate(sl):
                    pm[pt[i, n // ps:].long()] = fill
                return fa.flash_paged_prefill_pool(q, *kv_, pm, layer, pt, slt, nlt)

            def rounded(layer=layer):  # the layer's rows and the chunk's, read as ctl does
                pm[:, layer] = ctl(main[:, layer])
                pm[:, L + layer] = ctl_v(main[:, L + layer])
                out = fa.flash_paged_prefill_pool(q, ctl(kc), ctl_v(vc), pm, layer, pt, slt, nlt)
                pm[:, layer], pm[:, L + layer] = main[:, layer], main[:, L + layer]
                return out

            e, sh, c16 = checked(
                f"{name} layer={layer}",
                lambda: fa.flash_paged_prefill_pool(q, kc, vc, main, layer, pt, slt, nlt),
                lambda: fa.flash_paged_prefill_pool_plain(q, kc, vc, main, layer, pt, slt, nlt),
                [lambda f=f, k=k: poisoned(f, kv_=k)
                 for f, k in zip((0.0, float("nan")), curs)], nls, rounded)
            err, share, keys_bf16 = max(err, e), min(share, sh), max(keys_bf16, c16 or 0.0)
        del pm, curs
        lay = Cycle(L)
        ms, call_ms = cuda_ms(
            lambda: fa.flash_paged_prefill_pool(q, kc, vc, main, lay(), pt, slt, nlt))
        plain_ms, _ = cuda_ms(
            lambda: fa.flash_paged_prefill_pool_plain(q, kc, vc, main, lay(), pt, slt, nlt),
            **PLAIN)
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
                         **bench.fma_bound(S, sl, nls, pool),
                         bq=bq, max_abs_err=err, bitwise_equal_share=share,
                         deterministic=True, nan_rows_unread=True,
                         **({control_key[pool]: keys_bf16} if pool != "bf16" else {})))
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
                **PLAIN)

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
    kernel, against one max over all committed pages in the plain version)
    with ``FP16_EQUAL_SHARE`` of the output bitwise equal; 2e-5 in f32, plus
    one bf16 step of the value (at most 2^-7 of it: both round an f32
    result to the bf16 output), with ``K6_F32_EQUAL_SHARE`` of the output
    bitwise equal and the rest one step apart or within 2e-5. The kernel
    over the pool rounded to bf16 (f32: what a bf16 read of it would give;
    fp16: the keys only, what a bf16 product with the query would take)
    must fail that bar. At each shape two calls must give the
    same bits, and with the pool pages past each slot's committed span and
    the staging rows from its offset on set to NaN the output must be finite
    and bitwise equal to the run with those rows zero. The CUDA runtime's
    occupancy count must be ``DECODE_BLOCKS_PER_SM`` blocks of the type's kernel an SM, the split
    rule's assumption. Each shape prints its time, SDPA's, the bound (on f32
    also the bound on f32 FMAs), the split the wrapper picked, the error and
    the bitwise equal share."""
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
    # the split rule's assumption, from the CUDA runtime: this type's kernel at its
    # shared memory fits DECODE_BLOCKS_PER_SM blocks on an SM
    occupancy = fa.decode_occupancy(inp["main"].dtype, dev)
    if occupancy != (fa.DECODE_SMEM_BYTES[pool], fa.DECODE_BLOCKS_PER_SM):
        fail(f"K6{tag}: (shared memory, blocks per SM) {occupancy}, the split rule assumes "
             f"{(fa.DECODE_SMEM_BYTES[pool], fa.DECODE_BLOCKS_PER_SM)}")
    rows, worst = [], 0.0
    for name, lens in bench.SHAPES.items():
        (q, kc, vc, main, stage), (pt, sl) = bench.case(inp, lens)
        B = len(lens)
        err, equal_share, bf16_read = 0.0, 1.0, 0.0
        rounded = None
        if pool == "f32":
            rounded = [t.bfloat16().float() for t in (main, stage)]
        elif pool == "fp16":  # the key rows (layers 0..L-1) at bf16
            rounded = [main.clone(), stage.clone()]
            rounded[0][:, :L] = main[:, :L].bfloat16().half()
            rounded[1][:, :, :L] = stage[:, :, :L].bfloat16().half()
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
            if rounded is not None:
                r16 = fa.flash_paged_decode(q, kc, vc, *rounded, layer, pt, sl)
                ok16, d16, share16 = fa.meets_pool_bar(r16, b, "k6", pool)
                if ok16:
                    fail(f"K6{tag} {name} layer={layer}: the bar passes the kernel over a "
                         f"bf16-rounded {'pool' if pool == 'f32' else 'key set'}")
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
            lambda: fa.flash_paged_decode_plain(q, kc, vc, main, stage, lay(), pt, sl), **PLAIN)
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
        # for the products the kernel runs: a bf16 query and fp16 keys meet
        # exactly in TF32; on f32 three TF32 products each (the key's three
        # pieces; 3xTF32 for PV); beside it the f32 pool's bound on f32 FMAs
        dots = 2 * NH * D * tokens
        ops = {"bf16": {"bf16": 2 * dots}, "fp16": {"tf32": dots, "fp16": dots},
               "f32": {"tf32": 6 * dots}}[pool]
        b_ms, b_by = bound(bench.nbytes(lens, pool), ops)
        fma = ({"bound_f32_fma_ms": bound(bench.nbytes(lens, pool), 2 * dots, "f32")[0]}
               if pool == "f32" else {})
        split = fa.flash_decode_split(B, KV, MP * ps, cuda_lib.sm_count(dev))
        rows.append(dict(shape=f"decode {name} B={B} ps={ps} MP={MP} seq_lens={lens} "
                               f"pool={pool}", ms=ms,
                         call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         library="SDPA over contiguous histories", bound_ms=b_ms, bound_by=b_by,
                         **fma, split=split, blocks_per_sm=occupancy[1], max_abs_err=err, bitwise_equal_share=equal_share,
                         deterministic=True, nan_rows_unread=True,
                         **({"bf16_read_equal_share": bf16_read} if pool == "f32" else {}),
                         **({"keys_bf16_equal_share": bf16_read} if pool == "fp16" else {})))
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
            shape = f"{name} {k}->{n} ({scale} scale, {mode}) rows={rows}"
            if 1 < rows < 8:  # checked, not timed
                mid.append(shape)
                continue
            ms, call_ms = cuda_ms(lambda: ker(*args(lay())))
            out_bytes = 4 if mode == "int32" else 2
            sw_bytes = 0 if mode == "int32" else (n * 4 if scale == "column" else 4)
            nbytes = rows * k + (0 if mode == "int32" else rows * 4) + k4 * n + sw_bytes \
                + rows * n * out_bytes
            b_ms, b_by = bound(nbytes, 2 * rows * k * n, "int8")
            plain_ms, _ = cuda_ms(lambda: pla(*args(lay())), **PLAIN)
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
    for r in rows_out:
        print("kernels: K7 " + json.dumps(r))
    print(f"kernels: K7 bitwise equal to its plain version in {checks}/{checks} checks (rows 1-8 "
          f"in bf16, f32 and int32 at every shape; checked, not timed, at {len(mid)} shapes of "
          "2-7 rows)")
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
                                             cos, sin), **PLAIN)
            lib_ms, _ = cuda_ms(lambda: _layer_library(cfg, wls, h, ck, cv, lay, pos))
            b_ms, b_by = _block_bytes_ops(st, cfg, pos)
            rows8.append(dict(shape=f"decode layer T={T} pos={pos}", ms=ms, call_ms=call_ms,
                              plain_ms=plain_ms, library_ms=lib_ms,
                              library="K5's and K2's library calls", bound_ms=b_ms,
                              bound_by=b_by))
            if T == 328 and pos == T - 1:  # the bench's shape
                ms, call_ms = cuda_ms(lambda: k5_static(h, ck, cv, lay(), p, cos, sin))
                plain_ms, _ = cuda_ms(lambda: k5_static(
                    h, ck, cv, lay(), p, cos, sin, tc.attn_block_megakernel_static_plain), **PLAIN)
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
                              **PLAIN)
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
            plain_ms, _ = cuda_ms(lambda: fa.flash_prefill_plain(q, k, v, off), **PLAIN)
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
    plain_ms, _ = cuda_ms(lambda: cal.touch_plain(h, gw, dw, lay(), cs), **PLAIN)

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
        # step, then one window), then 16 steps under the profiler
        pm, klf = states[mode]
        tok, cache = bd.prefill(pm, cfg, klf, prompt, T)
        pos = torch.full((1,), prompt_len, dtype=torch.int32, device=dev)
        _, tok, cache, pos = bd.decode_window(pm, cfg, klf, tok, cache, pos, 1, head)
        t0 = time.perf_counter()
        _, tok, cache, pos = bd.decode_window(pm, cfg, klf, tok, cache, pos, steps, head)
        eager_ms = (time.perf_counter() - t0) / steps * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, tok, cache, pos = bd.decode_window(pm, cfg, klf, tok, cache, pos, PROFILED_STEPS,
                                                  head)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.device_time_total for e in evs) / 1e3 / PROFILED_STEPS
        print(f"batch1 {mode}: eager window {eager_ms} ms per token ({1e3 / eager_ms} tok/s, "
              f"one window of {steps}); {dev_ms} ms of device time per token "
              f"({PROFILED_STEPS} profiled steps), {dev_ms / eager_ms} of the eager token; device "
              f"busy {dev_ms * PROFILED_STEPS / 1e3 / dt} of {dt} s under the profiler; device ms "
              f"per token by kernel: " + json.dumps(by_kernel(device_events(prof),
                                                              PROFILED_STEPS)))
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
                            SamplingParams(max_new_tokens=25, temperature=0.0))
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
    # decode windows of 8 slots (17-token prompts, one 16-step burst: a
    # logprobs burst does not shorten, so the plain one keeps its length), plain
    # and with logprobs in turns: wall ms per step, then one profiled window
    # each for the device's ms per step
    from torch.profiler import ProfilerActivity, profile

    windows = {"plain": [], "logprobs": []}
    device_ms = {}
    for tag in ("plain", "logprobs", "logprobs", "plain"):
        profiled = len(windows[tag]) == 1
        batch = [eng.submit(rng.integers(1, cfg.vocab_size, 17).tolist(),
                            SamplingParams(max_new_tokens=33,
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
        greedy slots (one 8-step burst after the first step), profiled."""
        batch = [eng.submit(p, SamplingParams(max_new_tokens=25)) for p in window_prompts]
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

    def recording_head(hidden, p_, cfg_, tp_axis=None):
        heads_seen.append(hidden.detach().clone())
        return head(hidden, p_, cfg_, tp_axis=tp_axis)

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
        # 20 calls: at 3, a session in this phase recorded no device time (twice)
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
    ``EMBED_TOL``, and if the planted control passes them: the mean taken
    over the padded bucket's 64 rows (the bar must see the mask)."""
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
    cos_u = float(served @ unmasked)
    if cos_u >= EMBED_COS and float((served - unmasked).abs().max()) <= EMBED_TOL:
        fail(f"server: the control (the unmasked mean, cosine {cos_u}) passes the bars")
    return (f"embedding of {len(ids)} ids vs the plain masked mean: cosine {cos}, "
            f"max abs {err} (bars {EMBED_COS}, {EMBED_TOL}; the control, the unmasked "
            f"mean's cosine {cos_u}, fails them)")


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


# The f32 gate of the long-context path against the dense forward
# (phase_longctx (b), tests/test_torch_cuda.py). The ring path computes the
# dense model's function with its attention in another f32 order, and its
# projections' int8 activation codes follow from the attention's output: a
# rounding-sized change of that output flips the codes that sit at a
# rounding point, each flip moves its projection by a step of the code, and
# the later layers carry that on, far past rounding in the logits. So the
# gate holds the ring path to the dense forward where rounding stays
# rounding, and measures what it does past that:
# - every layer's attention, prefill and decode, within LONGCTX_ATTN_TOL of
#   the dense _attention on the same q, k and v (the dense forward run with
#   the ring's attention in its place: the hybrid);
# - the ring engine's logits, teacher-forced on the dense tokens, bitwise
#   the hybrid's at every step (LONGCTX_HYBRID_TOL): the same operations on
#   the same values;
# - the witness: the dense forward with its attention exact (f64, rounded
#   to f32) moves the logits too; the ring's distance to the dense logits
#   may be LONGCTX_WITNESS_MARGIN times the witness's, scaled by the ratio
#   of the two attentions' errors (more codes flip with a larger error);
#   the int8 codes that differ at layer 0's projections are counted;
# - greedy tokens equal the dense forward's or part where the teacher-forced
#   logits already do: each greedy token is the argmax of the teacher-forced
#   ring logits of its step, up to the first parting;
# - controls must fail the gate: on a group of one, a decode that drops the
#   prefix key its query weights most (the attention check) and a decode
#   whose prefix V is one position out of step with its K (the hybrid
#   check); on a ring of more ranks, the last rank's prefix block dropped
#   from the decode's merge (the attention check), the fault that only a
#   ring of several ranks can have. Each control's fault is in every decode
#   step, so it runs LONGCTX_CONTROL_STEPS forward passes: the prefill and
#   the first decode step.
LONGCTX_ATTN_TOL = 1e-5
LONGCTX_HYBRID_TOL = 0.0
LONGCTX_WITNESS_MARGIN = 2.0
LONGCTX_CONTROL_STEPS = 2


def longctx_f32_gate(lce, params, cfg, prompt, steps, linear, generate=None):
    """The f32 gate above for ``LongContextEngine`` ``lce`` against
    ``models.bitnet.forward`` on the same unfused ``params`` and ``linear``
    (K7 on the card): ``prompt`` [t0] ids, ``steps`` tokens. On a group of P
    > 1 ranks (a tensor-parallel engine's ring; P must divide t0) every rank
    calls it: the dense forward and the witness run the whole prompt on each
    rank, the hybrid runs this rank's shard of it with the ring's attention
    (its prefill logits those of the shard that holds the last row), and its
    control drops the last rank's prefix block from the decode's merge (in
    place of the group of one's two). ``generate``: the call that gives the engine's greedy tokens
    (``lce.generate`` by default). Returns (report dict, failures: a list of
    what failed, empty if none). Runs on any device (the plain versions on
    the CPU)."""
    import copy

    import torch
    import torch.distributed as tdist

    from wrinklefree_tpu_torch.engine.long_context import _NEVER, LongContextEngine
    from wrinklefree_tpu_torch.models import bitnet
    from wrinklefree_tpu_torch.ops.ternary import quantize_activations

    dev, t0, NB = prompt.device, prompt.numel(), lce.decode_buf
    P, rank = lce.P, lce.rank
    if t0 % P or t0 < 8 * P:
        raise ValueError(f"the gate's prompt of {t0} tokens does not split over {P} ranks")
    lo, hi = rank * t0 // P, (rank + 1) * t0 // P  # this rank's rows of the prompt
    dense_attention = bitnet._attention

    def gather(x):
        """[1, s_loc, ...] shards of every rank, along dim 1 in rank order."""
        if P == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(P)]
        tdist.all_gather(parts, x.contiguous(), group=lce.group)
        return torch.cat(parts, dim=1)

    def exact_attention(errs):
        def attention(q, kc, vc, q_pos, cfg_, attn_sparsity=None):
            B, S, NH, D = q.shape
            T, KV = kc.shape[1], kc.shape[2]
            sc = torch.einsum("bskgd,btkd->bkgst", q.double().reshape(B, S, KV, NH // KV, D),
                              kc.double()) / math.sqrt(D)
            key = torch.arange(T, device=q.device)
            hidden = ~(key[None, None, None, None, :] <= q_pos[:, None, None, :, None])
            pr = torch.softmax(sc.masked_fill_(hidden, float("-inf")), dim=-1)
            got = torch.einsum("bkgst,btkd->bskgd", pr, vc.double()).reshape(B, S, NH, D)
            got = got.to(q.dtype)
            errs.append(float((got - dense_attention(q, kc, vc, q_pos, cfg_)).abs().max()))
            return got
        return attention

    def ring_order(eng, errs):
        """The ring's attention on the dense forward's q and cache (this
        rank's rows of the prompt, ``dense_run(sharded=True)``): the
        prefill's q-chunked ring attention over this rank's keys, the
        decode's prefix shard + buffer; each held to the dense attention
        over every rank's keys (the prompt's, gathered once a layer)."""
        layer, prefix = [0], {}

        def attention(q, kc, vc, q_pos, cfg_, attn_sparsity=None):
            layer[0] = layer[0] % cfg.num_layers + 1
            if q.shape[1] > 1:
                k, v = kc[:, lo:hi], vc[:, lo:hi]
                got = eng._prefill_attention(q, k, v)
                kf, vf = prefix[layer[0]] = gather(k), gather(v)
            else:
                t = int(q_pos[0, 0]) - t0  # the decode step: its buffer row
                kb = torch.zeros((1, NB) + tuple(kc.shape[2:]), dtype=kc.dtype, device=dev)
                vb = torch.zeros_like(kb)
                kb[:, :t + 1] = kc[:, t0:t0 + t + 1]
                vb[:, :t + 1] = vc[:, t0:t0 + t + 1]
                b = torch.arange(NB, device=dev)
                b_pos = torch.where(b <= t, t0 + b, torch.full_like(b, _NEVER))
                got = eng._attend(q, kc[:, lo:hi], vc[:, lo:hi], kb, vb,
                                  torch.arange(lo, hi, device=dev), b_pos)
                kp, vp = prefix[layer[0]]
                kf = torch.cat([kp, kc[:, t0:t0 + t + 1]], dim=1)
                vf = torch.cat([vp, vc[:, t0:t0 + t + 1]], dim=1)
            errs.append(float((got - dense_attention(q, kf, vf, q_pos, cfg_)).abs().max()))
            return got
        return attention

    def dense_run(attention, feed=None, codes=None, sharded=False):
        """forward with ``attention`` as its _attention: greedy, or fed
        ``feed``; (tokens, each step's logits [V]); ``codes`` receives the
        int8 activation codes of layer 0's seven projections at the
        prefill. ``sharded``: the prefill runs this rank's rows of the
        prompt (at their positions), and its logits are the last rank's,
        summed with zeros from the others in f32 (exact), as the ring
        engine replicates the last row's hidden state."""
        def lin(x, qw, scale, out_dtype=torch.bfloat16):
            if codes is not None and len(codes) < 7:
                codes.append(quantize_activations(x)[0])
            return linear(x, qw, scale, out_dtype=out_dtype)

        cache = bitnet.KVCache.zeros(cfg, 1, t0 + steps, device=dev)
        tok, start = prompt[None], torch.zeros((1,), dtype=torch.int32, device=dev)
        if sharded:
            tok, start = prompt[lo:hi][None], start + lo
        toks, logits = [], []
        bitnet._attention = attention
        try:
            for i in range(steps if feed is None else len(feed)):
                lg, cache = bitnet.forward(params, cfg, tok, cache, start, linear_fn=lin,
                                           logits_all=False)
                if sharded and i == 0 and P > 1:
                    lg = lg.float() if rank == P - 1 else torch.zeros_like(lg, dtype=torch.float32)
                    tdist.all_reduce(lg, op=tdist.ReduceOp.SUM, group=lce.group)
                logits.append(lg[0])
                toks.append(int(lg[0].argmax()) if feed is None else feed[i])
                start = torch.full((1,), t0 + i, dtype=torch.int32, device=dev)
                tok = torch.tensor([[toks[-1]]], device=dev)
        finally:
            bitnet._attention = dense_attention
        return toks, logits

    def ring_run(eng, feed, shift=False):
        """The ring engine's prefill and decode, teacher-forced on ``feed``
        (``shift``: the decode reads each prefix V one position late, out of
        step with its K)."""
        logits0, pk, pv = eng._prefill(prompt[lo:hi][None], t0)
        if shift:
            pv = pv.roll(1, dims=2)
        rest = []
        eng._decode(pk, pv, torch.tensor(feed[0], device=dev), t0, len(feed) - 1,
                    feed=feed[1:], logits_out=rest)
        return [logits0[0]] + [lg[0] for lg in rest]

    def dist(a, b):
        return [float((x - y).abs().max()) for x, y in zip(a, b)]

    codes_dense, codes_hyb, codes_wit = [], [], []
    want, dense = dense_run(dense_attention, codes=codes_dense)
    gaps = [float(v[0] - v[1]) for v in (torch.topk(lg, 2).values for lg in dense)]
    wit_errs, errs = [], []
    _, wit = dense_run(exact_attention(wit_errs), feed=want, codes=codes_wit)
    _, hyb = dense_run(ring_order(lce, errs), feed=want, codes=codes_hyb, sharded=True)
    codes_dense = [c[..., lo:hi, :] for c in codes_dense]  # this rank's rows
    codes_wit = [c[..., lo:hi, :] for c in codes_wit]
    ring = ring_run(lce, want)
    got = generate() if generate is not None else lce.generate(prompt.tolist(), steps)
    ring_dist, wit_dist = dist(ring, dense), dist(wit, dense)
    attn_err, wit_attn_err = max(errs), max(wit_errs)
    cap = (LONGCTX_WITNESS_MARGIN * max(wit_dist)
           * max(1.0, attn_err / max(wit_attn_err, 1e-30)))
    part = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    names = ("q", "k", "v", "o", "gate", "up", "down")
    report = dict(
        ranks=P, tokens=got, dense_tokens=want, part=part, dense_top2_gaps=gaps,
        attn_err=attn_err, hybrid_err=max(dist(ring, hyb)), ring_logit_dist=ring_dist,
        witness_logit_dist=wit_dist, witness_attn_err=wit_attn_err, cap=cap,
        layer0_code_flips={n: int((a != b).sum()) for n, a, b in
                           zip(names, codes_dense, codes_hyb)},
        layer0_code_flips_witness={n: int((a != b).sum()) for n, a, b in
                                   zip(names, codes_dense, codes_wit)},
        layer0_codes={n: c.numel() for n, c in zip(names, codes_dense)})

    def checks(attn_err, hybrid_err, ring_dist, tokens, ring_logits):
        out = []
        if not attn_err <= LONGCTX_ATTN_TOL:
            out.append(f"a layer's ring attention differs from the dense one by {attn_err}")
        if not hybrid_err <= LONGCTX_HYBRID_TOL:
            out.append(f"the ring engine's logits differ from the hybrid's by {hybrid_err}")
        if not max(ring_dist) <= cap:
            out.append(f"the ring logits are {max(ring_dist)} from the dense ones (cap {cap})")
        first = next((i for i, (a, b) in enumerate(zip(tokens, want)) if a != b), steps - 1)
        if tokens[:first + 1] != [int(lg.argmax()) for lg in ring_logits[:first + 1]]:
            out.append(f"greedy tokens {tokens} are not the teacher-forced logits' argmax")
        return out

    failures = checks(attn_err, report["hybrid_err"], ring_dist, got, ring)
    # the controls, each of which must fail the gate
    drop = copy.copy(lce)

    def drop_top_key(q, k_loc, v_loc, kb, vb, k_pos_m, b_pos_m):
        G = q.shape[2] // k_loc.shape[2]
        sc = torch.einsum("hd,thd->ht", q[0, 0].float(),
                          k_loc[0].float().repeat_interleave(G, dim=1))
        j = sc.masked_fill(k_pos_m[None] == _NEVER, float("-inf")).amax(dim=0).argmax()
        k_pos_m = k_pos_m.clone()
        k_pos_m[j] = _NEVER
        return LongContextEngine._attend(drop, q, k_loc, v_loc, kb, vb, k_pos_m, b_pos_m)

    ctl = want[:LONGCTX_CONTROL_STEPS]
    if P == 1:
        drop._attend = drop_top_key
        errs_d = []
        _, hyb_d = dense_run(ring_order(drop, errs_d), feed=ctl, sharded=True)
        ring_d = ring_run(drop, ctl)
        ring_s = ring_run(lce, ctl, shift=True)
        report["controls"] = {
            "drop_top_key": checks(max(errs_d), max(dist(ring_d, hyb_d)), dist(ring_d, dense),
                                   drop.generate(prompt.tolist(), LONGCTX_CONTROL_STEPS), ring_d),
            "shifted_prefix": checks(attn_err, max(dist(ring_s, hyb)), dist(ring_s, dense),
                                     [int(lg.argmax()) for lg in ring_s], ring_s)}
        report["control_attn_err"] = {"drop_top_key": max(errs_d)}
        report["control_logit_dist"] = {"drop_top_key": max(dist(ring_d, dense)),
                                        "shifted_prefix": max(dist(ring_s, dense))}
    else:  # the last rank's prefix block leaves the decode's merge
        blk = copy.copy(lce)

        def drop_block(q, k_loc, v_loc, kb, vb, k_pos_m, b_pos_m):
            if rank == P - 1:
                k_pos_m = torch.full_like(k_pos_m, _NEVER)
            return LongContextEngine._attend(blk, q, k_loc, v_loc, kb, vb, k_pos_m, b_pos_m)

        blk._attend = drop_block
        errs_b = []
        _, hyb_b = dense_run(ring_order(blk, errs_b), feed=ctl, sharded=True)
        ring_b = ring_run(blk, ctl)
        report["controls"] = {"dropped_block": checks(
            max(errs_b), max(dist(ring_b, hyb_b)), dist(ring_b, dense),
            [int(lg.argmax()) for lg in ring_b], ring_b)}
        report["control_attn_err"] = {"dropped_block": max(errs_b)}
        report["control_logit_dist"] = {"dropped_block": max(dist(ring_b, dense))}
    failures += [f"the control {name} passes the gate"
                 for name, caught in report["controls"].items() if not caught]
    return report, failures


def phase_longctx(dev, smi):
    """15. longctx — the long-context path (``engine/long_context.py``: ring
    prefill and context-parallel decode) at BitNet b1.58-2B's full width and
    depth, random ternary weights drawn on the card from seed 0, on an NCCL
    group of one (``group_of_one``), every projection through K7's exact
    int32 mode:

    (c) K7 at 16384 rows, the 2B gate/up (2560->6912) and down
        (6912->2560) shapes: bitwise equal to its plain version over every
        row (compared in 4096-row chunks), timed beside ``torch._int_mm`` on
        the same codes (checked equal) and its bound;
    (a) an ``Engine`` (the engine phase's configuration, max_context 2048)
        given the group serves a 16384-token bf16 prompt and 16 greedy
        tokens through the ring path (s_loc 16384, 16 q-chunks): exactly 210
        K7 launches (7 projections x 30 layers) per forward pass, 16 passes,
        the prefill's 210 through the GEMM; no other kernel; prefill
        seconds, decode ms a token, peak device memory;
    (b) the f32 model and a 4096-token prompt (4 q-chunks), TF32 off:
        ``longctx_f32_gate`` (its comment above says what it holds) on 8
        greedy tokens, the dense ``forward`` on the same K7 projections.

    Returns K7's launches and its GEMM's in (a) and (b)."""
    import dataclasses

    import torch

    from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.engine.long_context import LongContextEngine, group_of_one
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.ternary import ternary_linear, unpack_ternary

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("longctx: TF32 is on; the f32 einsums must run in f32")
    group = group_of_one(dev)
    print(f"longctx: torch.distributed group of {torch.distributed.get_world_size(group)} "
          f"({torch.distributed.get_backend(group)}); {smi}")
    cfg = BitNetConfig.bitnet_2b()
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    g = torch.Generator(device=dev).manual_seed(16)

    # (c) K7's exact mode at 16384 rows
    rows = 16384
    for name, (k, n) in (("gate/up", (H, I)), ("down", (I, H))):
        xq = torch.randint(-128, 128, (rows, k), generator=g, device=dev, dtype=torch.int8)
        qw = torch.randint(0, 256, (k // 4, n), generator=g, device=dev, dtype=torch.uint8)
        got = tc.ternary_matmul(xq, qw)
        for r0 in range(0, rows, 4096):
            want = tc.ternary_matmul_plain(xq[r0:r0 + 4096], qw)
            if not torch.equal(got[r0:r0 + 4096], want):
                fail(f"longctx: K7 int32 {name} rows {r0}..{r0 + 4095} differs from its plain "
                     f"version by {(got[r0:r0 + 4096] - want).abs().max().item()}")
        w_nk = unpack_ternary(qw).to(torch.int8).t().contiguous()
        if not torch.equal(torch._int_mm(xq, w_nk.t()), got):
            fail(f"longctx: torch._int_mm is not K7's int32 {name} function")
        del got, want
        ms, call_ms = cuda_ms(lambda: tc.ternary_matmul(xq, qw), iters=10, warmup=2)
        plain_ms, _ = cuda_ms(lambda: tc.ternary_matmul_plain(xq, qw), **PLAIN)
        lib_ms, _ = cuda_ms(lambda: torch._int_mm(xq, w_nk.t()), iters=10, warmup=2)
        b_ms, b_by = bound(rows * k + k // 4 * n + rows * n * 4, 2 * rows * k * n, "int8")
        print("longctx: K7 " + json.dumps(dict(
            shape=f"{name} {k}->{n} (int32) rows={rows}", ms=ms, call_ms=call_ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library=INT_MM,
            tc_share=tc_share(2 * rows * k * n, ms), max_abs_err=0.0)))
        del xq, qw, w_nk
    print(f"longctx: K7 int32 at {rows} rows bitwise equal to its plain version over every row "
          "(gate/up and down)")
    torch.cuda.empty_cache()

    launches = {"ternary_matmul_stacked": 0, "ternary_matmul_stacked/tiled": 0}
    others = [tc.ternary_matmul_stacked_fused, tc.mlp_block_megakernel,
              tc.attn_block_megakernel, tc.layer_block_megakernel]

    def counted(fn):
        """Run fn with K7's counters from 0; add its launches to the phase's."""
        tc.ternary_matmul_stacked.launches = tc.ternary_matmul_stacked.tiled_launches = 0
        before = [k.launches for k in others]
        out = fn()
        torch.cuda.synchronize()
        if [k.launches for k in others] != before:
            fail("longctx: a kernel other than K7 launched on the long-context path")
        n, tiled = tc.ternary_matmul_stacked.launches, tc.ternary_matmul_stacked.tiled_launches
        launches["ternary_matmul_stacked"] += n
        launches["ternary_matmul_stacked/tiled"] += tiled
        return out, n, tiled

    # (a) serving a 16384-token prompt through the Engine's ring route
    params = init_params(cfg, seed=0, device=dev)
    eng = Engine(params, cfg, EngineConfig(max_batch_slots=8, page_size=16, num_pages=1024,
                                           max_context=2048, prefill_buckets=(32, 128, 512)),
                 long_context_mesh=group, device=dev)
    del params
    prompt = torch.randint(1, cfg.vocab_size, (16384,), generator=g, device=dev).tolist()
    eng.generate(prompt[:2048], SamplingParams(max_new_tokens=2))  # warm-up: the ring route's
    torch.cuda.synchronize()                                       # first prefill and collective
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    req, n, tiled = counted(lambda: eng.generate(prompt, SamplingParams(max_new_tokens=16,
                                                                        temperature=0.0)))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    lt = eng._long_ctx.last_timings
    per_pass = 7 * L
    if not (req.finished and len(req.output_ids) == 16 and req.finish_reason == "length"
            and all(0 <= t < cfg.vocab_size for t in req.output_ids)):
        fail(f"longctx: the 16K request ended {req.finish_reason} with {req.output_ids}")
    if (n, tiled) != (per_pass * 16, per_pass):
        fail(f"longctx: K7 launched {n} times ({tiled} through the GEMM) for 16 forward passes; "
             f"expected {per_pass * 16} ({per_pass})")
    print(f"longctx: Engine(max_context=2048) served a 16384-token bf16 prompt + 16 greedy "
          f"tokens through the ring path: prefill {lt['prefill_s']} s, decode "
          f"{lt['decode_s'] / lt['decode_tokens'] * 1e3} ms a token, wall {wall} s, peak "
          f"{peak / 1e9} GB allocated; K7 {n} launches = {n // 16} per forward pass x 16 "
          f"(the prefill's {tiled} through the GEMM at 16384 rows); tokens {req.output_ids}; "
          f"{smi}")
    del eng, req
    torch.cuda.empty_cache()

    # (b) exactness in f32 against the dense forward
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = init_params(cfg32, seed=0, device=dev)
    lce = LongContextEngine(p32, cfg32, group, device=dev)
    prompt = torch.randint(1, cfg.vocab_size, (4096,), generator=g, device=dev)
    k7 = {}

    def k7_linear(x, qw, scale, out_dtype=torch.bfloat16):
        return ternary_linear(x, qw, scale, out_dtype=out_dtype, kernel=tc.ternary_matmul)

    def generate():
        got, k7["n"], k7["tiled"] = counted(lambda: lce.generate(prompt.tolist(), 8))
        return got

    rep, failures = longctx_f32_gate(lce, p32, cfg32, prompt, 8, k7_linear, generate)
    print("longctx: f32 gate " + json.dumps(rep))
    if failures:
        fail("longctx: the f32 ring path fails its gate against the dense forward: "
             + "; ".join(failures))
    if (k7["n"], k7["tiled"]) != (per_pass * 8, per_pass):
        fail(f"longctx: the f32 ring path launched K7 {k7['n']} times ({k7['tiled']} through "
             "the GEMM)")
    part = rep["part"]
    outcome = ("equal" if part is None else
               f"part at step {part} (dense top-2 gap {rep['dense_top2_gaps'][part]}, "
               f"teacher-forced logit distance {rep['ring_logit_dist'][part]})")
    print(f"longctx: f32, 4096-token prompt (4 q-chunks), TF32 off: every layer's ring "
          f"attention within {rep['attn_err']} of the dense one (tolerance {LONGCTX_ATTN_TOL}); "
          f"ring logits within {rep['hybrid_err']} of the hybrid's (tolerance "
          f"{LONGCTX_HYBRID_TOL}); ring vs dense logits up to {max(rep['ring_logit_dist'])} "
          f"(cap {rep['cap']}), the exact-attention witness up to "
          f"{max(rep['witness_logit_dist'])}; layer 0's int8 codes that differ "
          f"{rep['layer0_code_flips']} (witness {rep['layer0_code_flips_witness']}); "
          f"first token's max logit difference {rep['ring_logit_dist'][0]}; ring tokens "
          f"{rep['tokens']}, dense forward {rep['dense_tokens']}: {outcome}; controls caught: "
          f"{rep['controls']}; {smi}")
    del lce, p32
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    print(f"longctx: phase wall {time.perf_counter() - t_phase} s")
    return launches


# ---------------------------------------------------------------------------
# 17. tp — tensor parallelism on torch.distributed (parallel/sharding.py,
# engine/lockstep.py): ranks spawned on this one card, on gloo groups that
# carry CUDA tensors (gloo copies them through the host; NCCL refuses two
# ranks on one GPU)
# ---------------------------------------------------------------------------

# the engine phase's configuration, with flash_decode (K6 under TP)
TP_ECFG = dict(max_batch_slots=8, page_size=16, num_pages=1024, max_context=2048,
               prefill_buckets=(32, 128, 512), flash_decode=True)
# the 700-token prompt, queued first, sets the first round's bucket: 512-token
# chunks (K4); eight new tokens make each burst eight steps (gloo carries each
# of a step's 182 collectives through the host: 0.8 s a step at tp 2, 2 s at 4)
TP_LENS = (700, 17, 200)
TP_NEW = 8
TP_NOISE = 0.665  # the 30-layer rounding noise of the 2B logits (ROADMAP.md section 3)
# the largest teacher-forced logit distance a TP run may have from the single
# device's (``tp_token_gate``): above the sound runs' largest reading (0.460,
# 2B at tp 4), below the planted control's (1.23); PERF.md section 6
TP_DIST_CAP = 0.5
TP_TEXTS = ["The capital of France is", "def fibonacci(n):", "Tensor parallel serving on",
            "1, 2, 3, 4,"]
# the dp x tp server's two concurrent long prompts, one a replica: 600 bytes,
# a 512-token chunk (K4) and a 128-token one
DP_TP_LONG = ["".join(chr(33 + (i * 7919 + k) % 90) for i in range(600)) for k in (0, 1)]


def _tp_counting_linear(shapes):
    """The stacked K7 linear whose matmul counts its launches by shape
    (rows, K, N) in ``shapes`` (the kernel's own counter counts too)."""
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc

    def matmul(x_q, qw, layer, *a, **kw):
        key = f"{x_q.numel() // x_q.shape[-1]}x{qw.shape[1] * 4}->{qw.shape[2]}"
        shapes[key] = shapes.get(key, 0) + 1
        return tc.ternary_matmul_stacked(x_q, qw, layer, *a, **kw)

    return tc.make_linear_stacked(matmul=matmul)


def _tp_layer0_inputs(params, cfg, dev, axis):
    """The inputs of layer 0's q, o, gate and down linears on a 64-token
    prompt (the single-device forward on the whole params, K7 linears),
    recorded on every rank and held equal across the ranks (pmax == pmin)."""
    import numpy as np
    import torch

    from wrinklefree_tpu_torch.models.bitnet import KVCache, forward
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc

    st = params["layers"]
    names = {id(st[f"{n}_qw"]): n for n in ("q", "o", "gate", "down")}
    seen = {}
    inner = tc.make_linear_stacked()

    def rec(x, qw, scale, layer, **kw):
        if layer == 0 and id(qw) in names:
            seen[names[id(qw)]] = x.detach().clone()
        return inner(x, qw, scale, layer, **kw)

    rec.stacked = True
    toks = torch.from_numpy(np.random.default_rng(7).integers(1, cfg.vocab_size, (1, 64))).to(dev)
    forward(params, cfg, toks, KVCache.zeros(cfg, 1, 64, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev), linear_fn=rec, logits_all=False)
    for n, x in seen.items():
        f = x.float()
        if not torch.equal(axis.pmax(f.clone()), axis.pmin(f.clone())):
            fail(f"tp: layer 0's {n} input differs across the ranks")
    return seen


def _tp_int_gates(params, sp, cfg, mesh, acts):
    """Integer gates on layer 0's real activations (the single-device K7
    int32 dot as the reference), with two controls that must fail them:
    each rank's K7 int32 output of q, gate and up equals its columns of the
    single-device output; the ranks' MAX-reduced act scales of the o and
    down inputs equal the single-device scales, and the SUM all-reduce of
    their int32 partials over the repacked shards equals the full int32 dot;
    a shard of the un-repacked o/down weights and the o input quantized
    without the MAX all-reduce fail them."""
    import torch

    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.ternary import quantize_activations

    ax, r, P = mesh.model, mesh.model.index, mesh.model.size
    out = {}
    for name, src in (("q", "q"), ("gate", "gate"), ("up", "gate")):
        codes, _ = quantize_activations(acts[src])
        full = tc.ternary_matmul(codes, params["layers"][f"{name}_qw"][0])
        local = tc.ternary_matmul(codes, sp["layers"][f"{name}_qw"][0])
        n = local.shape[-1]
        out[name] = bool(torch.equal(local, full[..., r * n:(r + 1) * n]))
    for name in ("o", "down"):
        x = acts[name]
        k = x.shape[-1] // P
        xs = x[..., r * k:(r + 1) * k]
        codes1, scale1 = quantize_activations(x)
        codes, scale = quantize_activations(xs, quant_axis=ax)
        full = tc.ternary_matmul(codes1, params["layers"][f"{name}_qw"][0])
        summed = ax.psum(tc.ternary_matmul(codes, sp["layers"][f"{name}_qw"][0]))
        out[f"{name} scales"] = bool(torch.equal(scale, scale1))
        out[f"{name} codes"] = bool(torch.equal(codes, codes1[..., r * k:(r + 1) * k]))
        out[f"{name} sum"] = bool(torch.equal(summed, full))
        # control 1: a contiguous K/4 slice of the matrix as packed for one device
        k4 = params["layers"][f"{name}_qw"].shape[1] // P
        bad = params["layers"][f"{name}_qw"][0][r * k4:(r + 1) * k4]
        out[f"{name} control: un-repacked shard sum"] = bool(torch.equal(
            ax.psum(tc.ternary_matmul(codes, bad)), full))
        # control 2: the rank's own absmax (no MAX all-reduce)
        _, local_scale = quantize_activations(xs)
        out[f"{name} control: local scales"] = bool(torch.equal(local_scale, scale1))
    # a gate holds when it holds on every rank: the ranks' flags, reduced with MIN
    flags = torch.tensor([int(v) for v in out.values()], dtype=torch.int32, device=mesh.device)
    return dict(zip(out, ax.pmin(flags).tolist()))


class _TPWindow:
    """Profiles, on every rank, the first decode burst that runs once
    ``requests`` requests were queued with every slot decoding (the stats
    and slots are the same on every rank, so every rank profiles the same
    burst): device busy ms, K7 launches by shape, collectives, decode steps
    and wall."""

    def __init__(self, eng, mesh, shapes, requests):
        self.eng, self.mesh, self.shapes = eng, mesh, shapes
        self.prof = self.report = None
        inner = eng._decode

        def decode():
            if (self.report is None and eng.stats["requests"] >= requests
                    and all(r is not None and not r.pending for r in eng.slots)):
                self._start()
                out = inner()
                self._stop()
                return out
            return inner()

        eng._decode = decode

    def _start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.s0 = (self.eng.stats["decode_steps"], dict(self.shapes),
                   dict(self.mesh.model.calls), time.perf_counter())
        self.prof = profile(activities=[ProfilerActivity.CUDA]
                            if torch.cuda.is_available() else [ProfilerActivity.CPU])
        self.prof.__enter__()

    def _stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - self.s0[3]
        self.prof.__exit__(None, None, None)
        steps = self.eng.stats["decode_steps"] - self.s0[0]
        busy = busy_us(device_events(self.prof)) / 1e3
        self.prof = None
        self.report = dict(
            decode_steps=steps, device_ms_per_step=busy / steps, wall_ms_per_step=wall * 1e3 / steps,
            k7_per_step={k: (v - self.s0[1].get(k, 0)) / steps for k, v in self.shapes.items()
                         if v != self.s0[1].get(k, 0)},
            collectives_per_step={k: (v - self.s0[2].get(k, 0)) / steps
                                  for k, v in self.mesh.model.calls.items()})


def _tp_model(job, dev):
    import dataclasses

    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.models.bitnet import init_params

    cfg = getattr(BitNetConfig, job["model"])()
    if job.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=job["layers"])
    return cfg, init_params(cfg, seed=0, device=dev)


def _tp_engine_run(eng, cfg, prompts, rec=None):
    """Submit the greedy prompts together and step until they finish;
    returns the requests."""
    from wrinklefree_tpu_torch.engine import SamplingParams

    sp = SamplingParams(max_new_tokens=TP_NEW, temperature=0.0)
    with (rec.on(eng) if rec is not None else contextlib.nullcontext()):
        reqs = [eng.submit(p, sp) for p in prompts]
        while not all(r.finished for r in reqs):
            eng.step()
    return reqs


def tp_job(job):
    """One rank's part of a tp world (every rank of the world runs it; the
    world's default group is gloo over this card). ``job``: model, layers
    (None: all), gates, window, http. Returns the rank's report; rank 0's
    also holds the comparison with the single-device engine."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine
    from wrinklefree_tpu_torch.ops import flash_attention as fa
    from wrinklefree_tpu_torch.ops import kv_update_cuda as kvu
    from wrinklefree_tpu_torch.ops import sampling
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.parallel.sharding import make_mesh, tp_kv_replicated

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(job.get("device", "cuda:0"))  # the CPU rehearses the job
    cuda = dev.type == "cuda"
    P, rank = dist.get_world_size(), dist.get_rank()
    t0 = time.perf_counter()
    report = {}
    if cuda:
        torch.cuda.set_device(dev)  # initializes CUDA in this fresh process
        if (job.get("k7_shapes") or job.get("pp_ep_k7")) and rank == 0:
            # the other ranks wait at make_mesh
            from wrinklefree_tpu_torch.bench.roofline import GPU_SPECS, peak_ops

            global HBM_BYTES_PER_S
            HBM_BYTES_PER_S = GPU_SPECS["h100"]["hbm_bw"]
            PEAK_OPS.update(peak_ops("h100"))
            start_profiler(dev)
            g = torch.Generator(device=dev)
            g.manual_seed(25)
            if job.get("k7_shapes"):
                report["k7_shapes"] = tp_k7_shapes(dev, g, TP_K7_SHAPES)
            if job.get("pp_ep_k7"):  # timed within the pp_ep phase's wall
                t1 = time.perf_counter()
                report["pp_ep_k7"] = tp_k7_shapes(dev, g, PP_EP_K7_SHAPES)
                report["pp_ep_k7_s"] = time.perf_counter() - t1
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, params = _tp_model(job, dev)
    mesh = make_mesh(1, P, device=dev, backend="gloo")
    rep = tp_kv_replicated(cfg, P)
    report.update(rank=rank, tp=P, model=job["model"], layers=cfg.num_layers,
                  backend=mesh.backend, kv_replicated=rep)
    shapes = {}
    eng = Engine(params, cfg, EngineConfig(**TP_ECFG), mesh=mesh,
                 linear_fn=_tp_counting_linear(shapes))
    if job.get("gates"):  # on the engine's shards (repacked, sliced)
        report["gates"] = _tp_int_gates(params, eng.params, cfg, mesh,
                                        _tp_layer0_inputs(params, cfg, dev, mesh.model))
    kernels = (tc.ternary_matmul_stacked, kvu.kv_write, fa.flash_paged_prefill,
               fa.flash_paged_decode)
    for c in kernels:
        c.launches = 0
    report["pool_kv_heads"] = eng.pools.kv.shape[-1] // cfg.head_dim
    report["pool_gb"] = eng.pools.nbytes / 1e9
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in TP_LENS]
    window = (_TPWindow(eng, mesh, shapes, len(TP_LENS) + 8) if job.get("window")
              else None)
    rec = LogitsRecorder() if rank == 0 else None
    if rank == 0:
        try:
            t1 = time.perf_counter()
            reqs = _tp_engine_run(eng, cfg, prompts, rec)
            report["requests_s"] = time.perf_counter() - t1
            if window is not None:  # eight 17-token prompts decoding together
                from wrinklefree_tpu_torch.engine import SamplingParams

                # 9 tokens: the prefill's, then one burst of 8 steps
                wr = [eng.submit(rng.integers(1, cfg.vocab_size, 17).tolist(),
                                 SamplingParams(max_new_tokens=9, temperature=0.0))
                      for _ in range(8)]
                while not all(r.finished for r in wr):
                    eng.step()
        finally:
            eng.stop_followers()
        report["tp_tokens"] = [r.output_ids for r in reqs]
    else:
        eng.follow()
    report["launches"] = {c.__name__: c.launches for c in kernels}
    report["window"] = window.report if window is not None else None
    report["lockstep_messages"] = eng._lockstep.messages
    report["stats"] = {k: eng.stats[k] for k in ("decode_steps", "prefill_tokens",
                                                   "decode_tokens", "requests")}
    report["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    del eng, window
    if cuda:
        torch.cuda.empty_cache()
    creqs = (_tp_control_run(params, cfg, mesh, prompts, rec) if job.get("control")
             else None)
    if rank == 0:
        # the single-device engine on the same params through the same K7
        # linear (it fuses q/k/v and gate/up: K7 computes the same integers)
        single = Engine(params, cfg, EngineConfig(**TP_ECFG), device=dev,
                        linear_fn=tc.make_linear_stacked())
        sreqs = _tp_engine_run(single, cfg, prompts, rec)
        report["single_tokens"] = [r.output_ids for r in sreqs]
        report["parts"], report["max_teacher_forced_dist"] = tp_compare(
            sampling, prompts, sreqs, reqs, rec.runs[-1], rec.runs[0])
        if creqs is not None:
            parts, d = tp_compare(sampling, prompts, sreqs, creqs, rec.runs[-1], rec.runs[1])
            report["control"] = dict(parts=parts, max_teacher_forced_dist=d,
                                     tokens=[r.output_ids for r in creqs])
        del single, rec
    if job.get("ring"):
        if cuda:
            torch.cuda.empty_cache()
        report["ring"] = _tp_ring(mesh, params, cfg, dev)
    if job.get("http"):
        if cuda:
            torch.cuda.empty_cache()
        report["http"] = _tp_http(job, dev)
    report["seconds"] = time.perf_counter() - t0
    if job.get("pp_ep"):  # after the TP job, its engines and params freed
        del params
        report["pp_ep"] = pp_ep_job(P, dev)
    return report


# the tp 4 job's depth: its gloo steps (3.8 s at 30 layers) are the tp
# phase's slowest; the tp 2 world keeps the whole depth
TP4_LAYERS = 10
# the ring on a TP engine: a prompt of twice max_context (2048) tokens
TP_RING_TOKENS = 4096
TP_RING_NEW = 8
TP_RING_ECFG = dict(TP_ECFG, num_pages=64)  # the paged pools stay idle on the ring route


def _tp_ring(mesh, params, cfg, dev):
    """(r) ``Engine(mesh=..., long_context_mesh=mesh.model.group)`` on every
    rank of the world: the leader's ``generate`` of a ``TP_RING_TOKENS``
    prompt (seed 27) through the lockstep, every rank running the ring on
    its half of the prompt. bf16 on ``params``: the tokens, the wall, each
    rank's K7 launches, and the ring's teacher-forced logits on its own
    tokens (for the group of one in the parent). f32 (the same seed's f32
    model): ``longctx_f32_gate`` on the engine's ring on every rank, its
    greedy tokens the engine's. Returns this rank's report."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.ternary import ternary_linear

    lead, P, r = mesh.model.index == 0, mesh.model.size, mesh.model.index
    cuda = dev.type == "cuda"
    t_ring = time.perf_counter()
    prompt = np.random.default_rng(27).integers(1, cfg.vocab_size, TP_RING_TOKENS).tolist()
    greedy = SamplingParams(max_new_tokens=TP_RING_NEW, temperature=0.0)
    out = {}

    def served(eng):
        """The leader's generate, the followers following it; (the tokens
        on every rank, the wall, this rank's K7 launches and its GEMM's)."""
        tc.ternary_matmul_stacked.launches = tc.ternary_matmul_stacked.tiled_launches = 0
        t0 = time.perf_counter()
        toks = None
        if lead:
            try:
                toks = eng.generate(prompt, greedy).output_ids
            finally:
                eng.stop_followers()
        else:
            eng.follow()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        box = [toks]
        dist.broadcast_object_list(box, src=mesh.leader, group=mesh.control)
        return (box[0], wall, tc.ternary_matmul_stacked.launches,
                tc.ternary_matmul_stacked.tiled_launches)

    eng = Engine(params, cfg, EngineConfig(**TP_RING_ECFG), mesh=mesh,
                 long_context_mesh=mesh.model.group)
    toks, wall, n, tiled = served(eng)
    lce = eng._long_ctx
    out["bf16"] = dict(tokens=toks, wall_s=wall, k7=n, k7_gemm=tiled,
                       prefill_s=lce.last_timings["prefill_s"],
                       decode_ms=lce.last_timings["decode_s"] * 1e3 / (TP_RING_NEW - 1))
    s_loc = TP_RING_TOKENS // P
    mine = torch.tensor([prompt[r * s_loc:(r + 1) * s_loc]], device=dev)
    logits0, pk, pv = lce._prefill(mine, TP_RING_TOKENS)
    rest = []
    lce._decode(pk, pv, torch.tensor(toks[0], device=dev), TP_RING_TOKENS, TP_RING_NEW - 1,
                feed=toks[1:], logits_out=rest)
    if lead:
        out["bf16"]["logits"] = torch.stack([logits0[0]] + [x[0] for x in rest]).float().cpu()
    del eng, lce, pk, pv, rest
    if cuda:
        torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = init_params(cfg32, seed=0, device=dev)
    eng = Engine(p32, cfg32, EngineConfig(**TP_RING_ECFG), mesh=mesh,
                 long_context_mesh=mesh.model.group)
    toks, wall, n, tiled = served(eng)
    out["f32"] = dict(tokens=toks, wall_s=wall, k7=n, k7_gemm=tiled)

    def k7_linear(x, qw, scale, out_dtype=torch.bfloat16):
        return ternary_linear(x, qw, scale, out_dtype=out_dtype, kernel=tc.ternary_matmul)

    t1 = time.perf_counter()
    rep, failures = longctx_f32_gate(eng._long_ctx, p32, cfg32, torch.tensor(prompt, device=dev),
                                     TP_RING_NEW, k7_linear, generate=lambda: toks)
    out["f32"].update(gate=rep, failures=failures, gate_s=time.perf_counter() - t1)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    out["seconds"] = time.perf_counter() - t_ring
    del eng, p32
    if cuda:
        torch.cuda.empty_cache()
    return out


def _tp_control_run(params, cfg, mesh, prompts, rec):
    """The planted control of the token gate: the TP engine with every
    sub-norm's mean square taken over the rank's own slice (its SUM over the
    ranks dropped) on every rank. Returns the leader's requests (None on the
    other ranks)."""
    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine
    from wrinklefree_tpu_torch.kv import paged

    sound = paged.tp_sub_norm
    paged.tp_sub_norm = lambda x, weight, eps, full_dim, tp_axis=None: sound(x, weight, eps,
                                                                            full_dim)
    try:
        eng = Engine(params, cfg, EngineConfig(**TP_ECFG), mesh=mesh)
        if mesh.model.index:
            eng.follow()
            return None
        try:
            return _tp_engine_run(eng, cfg, prompts, rec)
        finally:
            eng.stop_followers()
    finally:
        paged.tp_sub_norm = sound


def tp_compare(sampling, prompts, single, tp, run_single, run_tp):
    """A TP run's greedy requests against the single device's: per request
    the largest logit distance over the rows both computed on the same
    prefix (up to and with the first token where they part), and at that
    token ``near_tie``'s verdict. Returns (parts, the largest distance)."""
    parts, dists = [], []
    for p, a, b in zip(prompts, single, tp):
        j = next((i for i, (x, y) in enumerate(zip(a.output_ids, b.output_ids)) if x != y),
                 None)
        upto = TP_NEW if j is None else j + 1  # rows on the same prefix
        d = max(float((run_tp[(b.seed, len(p) + i)] - run_single[(a.seed, len(p) + i)])
                      .abs().max()) for i in range(upto))
        dists.append(d)
        if j is not None:
            why = near_tie(sampling, run_single[(a.seed, len(p) + j)],
                           run_tp[(b.seed, len(p) + j)], a.sampling, j,
                           a.output_ids[j], b.output_ids[j], d)
            parts.append(dict(prompt=len(p), token=j, dist=d, why=why))
    return parts, max(dists)


def tp_token_gate(parts, dist) -> str:
    """Why a TP run's tokens fail against the single device's, or "": a part
    that is no near-tie, or a teacher-forced logit distance over
    ``TP_DIST_CAP``."""
    bad = [p for p in parts if p["why"]]
    if bad:
        return f"tokens part beyond a near-tie: {bad}"
    if dist > TP_DIST_CAP:
        return f"teacher-forced logit distance {dist} over the cap {TP_DIST_CAP}"
    return ""


def _recorded(engines):
    """Keep every request the engines' ``submit`` is given: a list of
    (replica index, request)."""
    got = []
    for i, e in enumerate(engines):
        def rec(*a, _submit=e.submit, _i=i, **kw):
            got.append((_i, _submit(*a, **kw)))
            return got[-1][1]

        e.submit = rec
    return got


# over 2048 bytes: the byte tokenizer's 2048 tokens, max_context, the ring route
TP_LONG_TEXT = "".join(chr(33 + (i * 7919) % 90) for i in range(2100))


def _tp_http(job, dev):
    """``create_server("synth:<model>", tp=P, long_context=True)`` on every
    rank: rank 0 serves four concurrent greedy completions over HTTP through
    the port's client (its engine's requests recorded), held to the same
    prompts submitted to its engine together; one embedding, held to the
    single-device embedding of the leader's snapshot (fused, K1:
    ``embedding_vs_plain``), its K7 launches counted; one completion of
    2048 tokens through the ring on the model group, held to the engine's
    ``generate``. Then it shuts down (its followers' serve() returns). Every
    rank reports its memory after the build and its peak (the leader keeps
    the unsharded snapshot)."""
    import urllib.request
    from types import SimpleNamespace

    import torch

    from wrinklefree_tpu_torch.client.client import InferenceClient
    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import SamplingParams
    from wrinklefree_tpu_torch.models.bitnet import fuse_projections
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.server._web import ServerThread
    from wrinklefree_tpu_torch.server.http import (ByteTokenizer, FollowerServer, build_app,
                                                   create_server)

    import torch.distributed as dist

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    server = create_server(f"synth:{job['model']}", engine_config=EngineConfig(**TP_ECFG),
                           tp=dist.get_world_size(), long_context=True, device=dev,
                           tp_backend="gloo")
    mem = dict(built_gb=torch.cuda.memory_allocated(dev) / 1e9 if cuda else None)
    if isinstance(server, FollowerServer):
        server.serve()
        mem["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
        return dict(follower_steps=server.engine.stats["decode_steps"], memory=mem)
    import concurrent.futures

    st = ServerThread(build_app(server))
    eng = server.async_engine.engine
    greedy = SamplingParams(max_new_tokens=TP_NEW, temperature=0.0)
    served = _recorded([eng])
    try:
        client = InferenceClient(st.url, timeout=600)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(TP_TEXTS)) as pool:
            texts = list(pool.map(
                lambda t: client.generate(t, max_tokens=TP_NEW, temperature=0.0), TP_TEXTS))
        wall = time.perf_counter() - t0
        by_prompt = {tuple(r.prompt_ids): r.output_ids for _, r in served}
        ids = [by_prompt[tuple(server.tokenizer.encode(t))] for t in TP_TEXTS]
        # the same prompts submitted to the engine together (the scheduler
        # thread steps them)
        reqs = [eng.submit(server.tokenizer.encode(t), greedy) for t in TP_TEXTS]
        server.async_engine.wake(eng)
        while not all(r.finished for r in reqs):
            time.sleep(0.05)
        direct = [server.tokenizer.decode(r.output_ids) for r in reqs]

        def post(path, body):
            req = urllib.request.Request(f"{st.url}{path}", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            return urllib.request.urlopen(req, timeout=600)

        one = SimpleNamespace(cfg=eng.cfg, device=eng.device,
                              params=fuse_projections(eng._long_ctx_params, eng.cfg),
                              _linear_fn=tc.make_linear_fused())
        tc.ternary_matmul_stacked.launches = 0  # the served embedding's (K1 computes the mean)
        t1 = time.perf_counter()
        emb = embedding_vs_plain(post, one, ByteTokenizer().encode(TP_TEXTS[0])[:40])
        emb_s = time.perf_counter() - t1
        emb_k7 = tc.ternary_matmul_stacked.launches
        del one
        long_ids = server.tokenizer.encode(TP_LONG_TEXT)
        tc.ternary_matmul_stacked.launches = 0
        t1 = time.perf_counter()
        with post("/completion", {"prompt": TP_LONG_TEXT, "n_predict": 4,
                                  "temperature": 0.0}) as r:
            long_body = json.loads(r.read())
        long_s = time.perf_counter() - t1
        long_k7 = tc.ternary_matmul_stacked.launches
        long_direct = server.tokenizer.decode(eng.generate(
            long_ids, SamplingParams(max_new_tokens=4, temperature=0.0)).output_ids)
    finally:
        st.stop()
        server.async_engine.shutdown()
    mem["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    return dict(completions=len(texts), equal_to_generate=texts == direct, wall_s=wall,
                ids=ids, decode_steps=eng.stats["decode_steps"], embedding=emb,
                embedding_s=emb_s, embedding_k7=emb_k7, long=dict(
                    prompt_tokens=len(long_ids), max_context=eng.ecfg.max_context,
                    tokens=long_body.get("tokens_predicted"),
                    equal_to_generate=long_body.get("content") == long_direct,
                    seconds=long_s, k7=long_k7),
                memory=mem)


def _dense_logits(params, cfg, ids, dev):
    """The single-device dense ``forward``'s f32 logits after ``ids``
    (unfused params, the stacked K7 linear)."""
    import torch

    from wrinklefree_tpu_torch.models.bitnet import KVCache, forward
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc

    with torch.no_grad():
        lg, _ = forward(params, cfg, torch.tensor([ids], device=dev),
                        KVCache.zeros(cfg, 1, len(ids), device=dev),
                        torch.zeros((1,), dtype=torch.int32, device=dev),
                        linear_fn=tc.make_linear_stacked(), logits_all=False)
    return lg[0].float()


def text_parts(params, cfg, dev, prompts, got, want):
    """Where each of ``got``'s greedy token lists parts from ``want``'s (two
    TP-2 runs of the same prompts, batched otherwise) and why that is a
    near-tie, or is not: the two tokens' logits in the single-device dense
    forward on the common prefix lie within ``2 * TP_NOISE`` (each run's
    logits may sit the 30-layer rounding noise from it). Returns the parts
    (dicts; ``why`` empty for a near-tie)."""
    parts = []
    for p, a, b in zip(prompts, got, want):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            if len(a) != len(b):
                parts.append(dict(prompt=len(p), token=min(len(a), len(b)), gap=None,
                                  why=f"lengths {len(a)} and {len(b)} on equal tokens"))
            continue
        lg = _dense_logits(params, cfg, list(p) + list(a[:j]), dev)
        gap = abs(float(lg[a[j]] - lg[b[j]]))
        parts.append(dict(prompt=len(p), token=j, gap=gap,
                          why="" if gap <= 2 * TP_NOISE else f"a logit gap of {gap}"))
    return parts


def dp_tp_job(job):
    """(d) ``create_server("synth:<model>", dp=2, tp=2)`` on the world of 4
    (``make_mesh(2, 2)`` over gloo on this card): replica 0 on ranks 0-1
    (rank 0 serves HTTP), replica 1 on ranks 2-3 (rank 2's
    ``ReplicaServer``). Rank 0 sends ``TP_TEXTS`` as four concurrent greedy
    completions and records which replica served each and its tokens, then
    the two ``DP_TP_LONG`` prompts together (the pick sends them to the two
    replicas: each prefills a 512-token chunk through K4); after the
    shutdown it holds the four to ``job["want"]`` (the tp 2 world's) with
    ``text_parts`` on its snapshot, and plants a control (the least likely
    first token) that must fail it. Every rank reports its role, that it
    returned, its K7, K3, K4 and K6 launches and its decode steps."""
    import concurrent.futures

    import torch
    import torch.distributed as dist

    from wrinklefree_tpu_torch.client.client import InferenceClient
    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.ops import flash_attention as fa
    from wrinklefree_tpu_torch.ops import kv_update_cuda as kvu
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.server._web import ServerThread
    from wrinklefree_tpu_torch.server.http import InferenceServer, build_app, create_server

    dev = torch.device(job.get("device", "cuda:0"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    kernels = (tc.ternary_matmul_stacked, kvu.kv_write, fa.flash_paged_prefill,
               fa.flash_paged_decode)
    for c in kernels:
        c.launches = 0
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    server = create_server(f"synth:{job['model']}", engine_config=EngineConfig(**TP_ECFG),
                           dp=2, tp=2, device=dev, tp_backend="gloo")
    # a replica's leader keeps the unsharded snapshot, its follower not
    out = dict(rank=dist.get_rank(), role=type(server).__name__,
               built_gb=torch.cuda.memory_allocated(dev) / 1e9 if cuda else None)
    if not isinstance(server, InferenceServer):
        server.serve()
        return dict(out, returned=True, launches={c.__name__: c.launches for c in kernels},
                    decode_steps=server.engine.stats["decode_steps"],
                    peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
                    seconds=time.perf_counter() - t0)
    ae = server.async_engine
    eng = ae.engine
    served = _recorded(ae.engines)
    st = ServerThread(build_app(server))
    try:
        client = InferenceClient(st.url, timeout=600)
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(TP_TEXTS)) as pool:
            texts = list(pool.map(
                lambda t: client.generate(t, max_tokens=TP_NEW, temperature=0.0), TP_TEXTS))
        out["requests_s"] = time.perf_counter() - t1
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            list(pool.map(lambda t: client.generate(t, max_tokens=2, temperature=0.0),
                          DP_TP_LONG))
        out["per_replica_requests"] = [e.stats["requests"] for e in ae.engines]
    finally:
        st.stop()
        ae.shutdown()
    out.update(returned=True, launches={c.__name__: c.launches for c in kernels},
               decode_steps=eng.stats["decode_steps"], completions=len(texts),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None)
    prompts = [server.tokenizer.encode(t) for t in TP_TEXTS]
    by_prompt = {tuple(r.prompt_ids): (i, r.output_ids) for i, r in served}
    got = [by_prompt[tuple(p)] for p in prompts]
    out["long_replicas"] = [by_prompt[tuple(server.tokenizer.encode(t))][0] for t in DP_TP_LONG]
    out["replicas"] = [i for i, _ in got]
    out["ids"] = [ids for _, ids in got]
    snap = eng._long_ctx_params
    out["parts"] = text_parts(snap, eng.cfg, dev, prompts, out["ids"], job["want"])
    worst = int(_dense_logits(snap, eng.cfg, prompts[0], dev).argmin())
    out["control"] = text_parts(snap, eng.cfg, dev, prompts[:1], [[worst]],
                                [out["ids"][0][:1]])
    out["seconds"] = time.perf_counter() - t0
    return out


def _tp_rank_main(rank, world, store, out_dir, job):
    import os
    import pickle
    import traceback

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    result = None
    try:
        import torch
        import torch.distributed as dist

        # the ranks share the host's cores with gloo's copies: one intra-op
        # thread each
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        # the world's jobs, in turn
        result = ("ok", [dp_tp_job(j) if j.get("dp_tp") else tp_job(j) for j in job])
        dist.destroy_process_group()
    except BaseException:  # fail() raises SystemExit: reported to the parent
        result = ("error", traceback.format_exc())
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def tp_world(world, jobs, timeout=600.0):
    """Run ``tp_job`` on each of ``jobs`` in turn on ``world`` spawned ranks
    (the ``spawn`` method: CUDA cannot fork), rendezvous in a FileStore under
    build/; returns each rank's reports, one per job. Fails if a rank
    failed, hung or died; kills none it leaves running."""
    import multiprocessing
    import pickle
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="tp_world_", dir=root) as tmp:
        procs = [ctx.Process(target=_tp_rank_main, args=(r, world, str(Path(tmp) / "store"),
                                                         tmp, jobs)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        out = []
        for r, p in enumerate(procs):
            f = Path(tmp) / f"rank{r}.pkl"
            if not f.exists():
                fail(f"tp: world of {world}, rank {r} left no report (exit {p.exitcode})")
            status, value = pickle.loads(f.read_bytes())
            if status != "ok":
                fail(f"tp: world of {world}, rank {r}:\n{value}")
            out.append(value)
    return out


def _fresh_main(out, name, args):
    import pickle
    import traceback

    try:
        import torch

        from wrinklefree_tpu_torch.bench.roofline import GPU_SPECS, peak_ops

        global HBM_BYTES_PER_S
        HBM_BYTES_PER_S = GPU_SPECS["h100"]["hbm_bw"]
        PEAK_OPS.update(peak_ops("h100"))
        dev = torch.device("cuda")
        torch.cuda.set_device(0)
        start_profiler(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        result = ("ok", globals()[name](dev, *args))
        import torch.distributed as dist

        if dist.is_initialized():  # the phase's NCCL group of one, ended before exit
            dist.destroy_process_group()
    except BaseException:  # fail() raises SystemExit: reported to the parent
        result = ("error", traceback.format_exc())
    sys.stdout.flush()
    Path(out).write_bytes(pickle.dumps(result))


def in_fresh_process(name, *args, timeout=900.0):
    """``name(dev, *args)``, a phase of this script, in a spawned process on
    this card (set up as ``main`` sets up this one; the kernels load from
    the cache this process built); returns its result. Fails if it failed,
    hung or died."""
    import multiprocessing
    import pickle
    import tempfile

    sys.stdout.flush()
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase_", dir=root) as tmp:
        out = Path(tmp) / "result.pkl"
        p = multiprocessing.get_context("spawn").Process(target=_fresh_main,
                                                         args=(str(out), name, args))
        p.start()
        p.join(timeout)
        if p.is_alive():
            p.kill()
            p.join(10)
        if not out.exists():
            fail(f"{name}: its process left no result (exit {p.exitcode})")
        status, value = pickle.loads(out.read_bytes())
    if status != "ok":
        fail(f"{name} in its own process:\n{value}")
    return value


# one rank's K7 shapes of the 2B model at tp 2 and 4 (q, k/v, gate/up
# column-parallel with bf16 output; o, down row-parallel with the f32
# partials) at 1, 8 and 512 rows
TP_K7_SHAPES = [(name, k, n, mode, (1, 8, 512)) for name, k, n, mode in (
    ("q tp2", 2560, 1280, "bf16"), ("k/v tp2 and tp4, q tp4", 2560, 640, "bf16"),
    ("o tp2", 1280, 2560, "f32"), ("o tp4", 640, 2560, "f32"),
    ("gate/up tp2", 2560, 3456, "bf16"), ("gate/up tp4", 2560, 1728, "bf16"),
    ("down tp2", 3456, 2560, "f32"), ("down tp4", 1728, 2560, "f32"))]
# the pp_ep phase's K7 shapes: a Llama-3-8B stage's projections at the
# prefill's rows (2 x 128) and a step's (2); layer 0's experts at ep x C rows
# (2048 at capacity 8, 64 at 0.25, at ep 2 and 4 alike)
PP_EP_K7_SHAPES = [
    ("8B q/o", 4096, 4096, "bf16", (2, 256)), ("8B k/v", 4096, 1024, "bf16", (2, 256)),
    ("8B gate/up", 4096, 14336, "bf16", (2, 256)), ("8B down", 14336, 4096, "bf16", (2, 256)),
    ("expert gate/up", 2560, 6912, "bf16", (64, 2048)),
    ("expert down", 6912, 2560, "bf16", (64, 2048))]


def tp_k7_shapes(dev, g, shapes):
    """K7 at ``shapes`` ((name, K, N, output "bf16" or "f32", row counts)):
    bitwise against its plain version, timed beside the bf16
    ``torch.matmul`` on unpacked weights and ``torch._int_mm`` on the same
    codes (at 16 rows or fewer on the codes padded to 32 rows: it refuses
    fewer), each weight set cycled past the L2, and its bound."""
    import torch

    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.ternary import unpack_ternary

    rows_out = []
    for name, k, n, mode, row_counts in shapes:
        nl = max(8, math.ceil(64e6 / (k // 4 * n)))
        qw = torch.randint(0, 256, (nl, k // 4, n), generator=g, device=dev, dtype=torch.uint8)
        sw = torch.rand((nl,), generator=g, device=dev) * 80 + 10
        nlib = max(2, math.ceil(64e6 / (k * n * 2)))
        lib_w = [unpack_ternary(qw[i]).to(torch.bfloat16) for i in range(nlib)]
        lib_i = [w.to(torch.int8).t().contiguous() for w in lib_w]
        out_dt = torch.float32 if mode == "f32" else torch.bfloat16
        for rows in row_counts:
            xq = torch.randint(-128, 128, (rows, k), generator=g, device=dev, dtype=torch.int8)
            sx = torch.rand((rows, 1), generator=g, device=dev) * 60 + 0.5
            lay, lib_lay = Cycle(nl), Cycle(nlib)
            a = tc.ternary_matmul_stacked(xq, qw, 0, sx, sw, out_dtype=out_dt)
            b = tc.ternary_matmul_stacked_plain(xq, qw, 0, sx, sw, out_dtype=out_dt)
            if not torch.equal(a, b):
                fail(f"tp: K7 {name} rows={rows}: kernel and plain version differ")
            ms, call_ms = cuda_ms(lambda: tc.ternary_matmul_stacked(
                xq, qw, lay(), sx, sw, out_dtype=out_dt))
            plain_ms, _ = cuda_ms(lambda: tc.ternary_matmul_stacked_plain(
                xq, qw, lay(), sx, sw, out_dtype=out_dt), **PLAIN)
            xb = torch.randn((rows, k), generator=g, device=dev).to(torch.bfloat16)
            bf16_ms, _ = cuda_ms(lambda: torch.matmul(xb, lib_w[lib_lay()]))
            xi = xq if rows > 16 else torch.cat([xq, xq.new_zeros((32 - rows, k))])
            int_ms, _ = cuda_ms(lambda: torch._int_mm(xi, lib_i[lib_lay()].t()))
            nbytes = rows * k + rows * 4 + k // 4 * n + 4 + rows * n * out_dt.itemsize
            b_ms, b_by = bound(nbytes, 2 * rows * k * n, "int8")
            rows_out.append(dict(shape=f"{name} {k}->{n} ({mode} out) rows={rows}", ms=ms,
                                 call_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, bf16_matmul_ms=bf16_ms,
                                 int_mm_ms=int_ms, int_mm_rows=xi.shape[0]))
        del qw, lib_w, lib_i
    return rows_out


def check_tp_ring(tag, ranks, smi):
    """The parent's checks of ``_tp_ring``'s reports: on every rank 8
    tokens, K7 exactly 210 launches a forward pass (8 passes, the prefill's
    through the GEMM) in both runs, and the f32 gate passed with every
    control caught."""
    per_pass = 7 * ranks[0]["layers"]
    for r in ranks:
        g = r["ring"]
        for kind in ("bf16", "f32"):
            x = g[kind]
            if len(x["tokens"]) != TP_RING_NEW:
                fail(f"tp {tag}: rank {r['rank']}'s {kind} ring ended with {x['tokens']}")
            if (x["k7"], x["k7_gemm"]) != (per_pass * TP_RING_NEW, per_pass):
                fail(f"tp {tag}: rank {r['rank']}'s {kind} ring launched K7 {x['k7']} times "
                     f"({x['k7_gemm']} through the GEMM)")
        if g["f32"]["failures"]:
            fail(f"tp {tag}: rank {r['rank']}: the f32 ring fails its gate: "
                 + "; ".join(g["f32"]["failures"]))
    g0 = ranks[0]["ring"]
    rep = g0["f32"]["gate"]
    print(f"tp {tag}: ring on the TP engine's model group ({len(ranks)} ranks over gloo), a "
          f"{TP_RING_TOKENS}-token prompt, max_context {TP_RING_ECFG['max_context']}: bf16 "
          f"prefill {g0['bf16']['prefill_s']} s, decode {g0['bf16']['decode_ms']} ms a token, "
          f"wall {g0['bf16']['wall_s']} s, K7 {g0['bf16']['k7']} launches a rank "
          f"({g0['bf16']['k7_gemm']} through the GEMM); f32 gate on every rank: attention "
          f"within {max(r['ring']['f32']['gate']['attn_err'] for r in ranks)} (tolerance "
          f"{LONGCTX_ATTN_TOL}), hybrid {max(r['ring']['f32']['gate']['hybrid_err'] for r in ranks)}"
          f" (tolerance {LONGCTX_HYBRID_TOL}), ring vs dense logits up to "
          f"{max(rep['ring_logit_dist'])} (cap {rep['cap']}); tokens {rep['tokens']}, dense "
          f"{rep['dense_tokens']}; controls caught {json.dumps(rep['controls'])}; the gate "
          f"{g0['f32']['gate_s']} s, the ring job {g0['seconds']} s; peak "
          f"{[r['ring']['peak_gb'] for r in ranks]} GB; {smi}")


def check_dp_tp(tag, ranks, smi):
    """The parent's checks of ``dp_tp_job``'s reports: the roles, every rank
    returned, four completions served by both replicas, tokens equal to the
    tp 2 world's or parted at near-ties, the planted control refused, K7,
    K3, K4 and K6 launched on every rank, each follower stepping with its
    leader."""
    r0 = ranks[0]
    roles = [r["role"] for r in ranks]
    if roles != ["InferenceServer", "FollowerServer", "ReplicaServer", "FollowerServer"]:
        fail(f"tp {tag}: roles {roles}")
    if not all(r["returned"] for r in ranks):
        fail(f"tp {tag}: a rank did not return")
    if (r0["completions"] != 4 or set(r0["replicas"]) != {0, 1}
            or sorted(r0["long_replicas"]) != [0, 1]):
        fail(f"tp {tag}: completions {r0['completions']} served by replicas {r0['replicas']}, "
             f"the long ones by {r0['long_replicas']}")
    bad = [p for p in r0["parts"] if p["why"]]
    if bad:
        fail(f"tp {tag}: tokens part from the tp 2 world's beyond a near-tie: {bad}")
    if not all(p["why"] for p in r0["control"]):
        fail(f"tp {tag}: the planted control passes the near-tie check: {r0['control']}")
    for r in ranks:
        zero = [k for k, v in r["launches"].items() if not v]
        if zero:
            fail(f"tp {tag}: rank {r['rank']} never launched {zero}")
    if ranks[1]["decode_steps"] != r0["decode_steps"] or (
            ranks[3]["decode_steps"] != ranks[2]["decode_steps"]):
        fail(f"tp {tag}: a follower's steps differ from its leader's")
    print(f"tp {tag}: create_server(dp=2, tp=2) over 4 processes on one card: four concurrent "
          f"completions served by replicas {r0['replicas']} in {r0['requests_s']} s, two of "
          f"600 tokens by {r0['long_replicas']}; per replica requests "
          f"{r0['per_replica_requests']}; tokens "
          f"against the tp 2 world's: parts {json.dumps(r0['parts'])} (equal where none); the "
          f"control {json.dumps(r0['control'])}; every rank returned; {smi}")
    for r in ranks:
        print("tp: " + json.dumps(dict(run=tag, rank=r["rank"], role=r["role"],
                                       launches=r["launches"], decode_steps=r["decode_steps"],
                                       built_gb=r["built_gb"], peak_gb=r["peak_gb"],
                                       seconds=r["seconds"])))


def phase_tp(dev, smi):
    """17. tp — tensor parallelism (``parallel/sharding.py``, the engine's
    lockstep) on this one card: ranks spawned with ``spawn``, all on
    ``cuda:0``, on gloo groups carrying CUDA tensors (gloo copies them
    through the host by itself; NCCL refuses two ranks on one GPU). The
    kernels are built in this process first; the ranks load them.

    (k) K7 at one rank's shapes at tp 2 and 4 (``tp_k7_shapes``, in the tp 2
        world's rank 0 before its model: a fresh process's profiler);
    (a) BitNet-2B at full width (random weights from seed 0), at tp 2 at
        full depth and at tp 4 cut to ``TP4_LAYERS`` layers: the integer
        gates on layer 0's real activations and their controls
        (``_tp_int_gates``); three greedy requests (700,
        17 and 200 tokens, ``TP_NEW`` = 8 new) through ``Engine(mesh=...)``
        with the engine phase's configuration and ``flash_decode``: the pools
        replicated (5 KV heads), K7, K3, K4 and K6 launched on every rank;
        the token gate (``tp_token_gate``) against the single-device engine
        on the same params through K7: tokens equal or parting only at a
        near-tie, the largest teacher-forced logit distance under
        ``TP_DIST_CAP``; at tp 2 a planted control that must fail that gate
        (``_tp_control_run``: sub-norms over each rank's slice); at tp 2 a
        profiled burst of eight decoding slots on every rank (tp 4's is in
        PERF.md section 5); at tp 2 (r) the ring on the engine's
        model group (``_tp_ring``: a 4096-token prompt at max_context 2048, 8
        tokens through the lockstep, in bf16 and in f32 under
        ``longctx_f32_gate`` with its control, a dropped block) and, from
        rank 0 of ``create_server(tp=2, long_context=True)``, four concurrent
        HTTP completions, an embedding held to the single-device embedding of
        the leader's snapshot and a 2048-token completion through the ring
        (``_tp_http``);
    (b) Llama-3-8B ternary at full width cut to 4 layers at tp 2: each
        rank's pools hold 4 KV heads (head-sharded), the token gate as in
        (a);
    (d) in the world of 4 after its tp 4 job, ``create_server(dp=2,
        tp=2)`` (``dp_tp_job``): four concurrent completions over both
        replicas, their tokens held to (a)'s HTTP completions at tp 2 with
        ``text_parts`` and a planted control, every rank returning;
    (c) a mesh of one on NCCL in this process: ``Engine(mesh=make_mesh(1,
        1))`` serves the requests of (a), held to the token gate against the
        single-device engine run here; then the ring on its group of one on
        (r)'s prompt, whose bf16 tokens (r)'s must equal or part from at a
        near-tie of the teacher-forced logits."""
    import numpy as np
    import torch

    from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.engine.long_context import LongContextEngine
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.ops import cuda_lib
    from wrinklefree_tpu_torch.ops import flash_attention as fa
    from wrinklefree_tpu_torch.ops import sampling
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.parallel.sharding import make_mesh

    t_phase = time.perf_counter()
    cuda_lib.library()  # built (or loaded) here: the ranks load it from the cache
    worlds, runs = {}, []
    # one world a size, its jobs run in turn (each world's spawn, CUDA and
    # kernel load paid once); the world of 4's dp x tp job holds its tokens
    # to the tp 2 world's HTTP completions of the same prompts
    dp_tp = dict(model="bitnet_2b", dp_tp=True)
    for world, jobs in (
            (2, [("2B tp2", dict(model="bitnet_2b", gates=True, window=True, http=True,
                                 ring=True, k7_shapes=True, pp_ep_k7=True, control=True,
                                 pp_ep=True)),
                 ("llama8b 4 layers tp2", dict(model="llama3_8b_ternary", layers=4))]),
            (4, [("2B tp4", dict(model="bitnet_2b", layers=TP4_LAYERS, gates=True,
                                 pp_ep=True)),
                 ("2B dp2 x tp2", dp_tp)])):
        if world == 4:
            dp_tp["want"] = worlds["2B tp2"][0]["http"]["ids"]
        t0 = time.perf_counter()
        out = tp_world(world, [job for _, job in jobs])
        print(f"tp: the world of {world} ranks ({', '.join(t for t, _ in jobs)}): "
              f"{time.perf_counter() - t0} s")
        for i, (tag, job) in enumerate(jobs):
            worlds[tag] = [r[i] for r in out]
            runs.append((tag, world, job, worlds[tag]))
    for tag, world, job, ranks in runs:
        r0 = ranks[0]
        if job.get("dp_tp"):
            check_dp_tp(tag, ranks, smi)
            continue
        for row in r0.get("k7_shapes", ()):  # timed in rank 0, a fresh process
            print("tp: K7 " + json.dumps(row))
        for r in ranks:
            zero = [k for k, v in r["launches"].items() if not v]
            if zero:
                fail(f"tp {tag}: rank {r['rank']} never launched {zero}")
            if r["stats"] != r0["stats"]:
                fail(f"tp {tag}: rank {r['rank']} ran other steps than the leader")
        want_heads = 5 if job["model"] == "bitnet_2b" else 8 // world
        if any(r["pool_kv_heads"] != want_heads for r in ranks):
            fail(f"tp {tag}: pools hold {[r['pool_kv_heads'] for r in ranks]} KV heads, "
                 f"expected {want_heads}")
        if "gates" in r0:
            g0 = r0["gates"]
            must = [k for k in g0 if "control" not in k]
            controls = [k for k in g0 if "control" in k]
            if not all(g0[k] for k in must):
                fail(f"tp {tag}: integer gates failed: {json.dumps(g0)}")
            if any(g0[k] for k in controls):
                fail(f"tp {tag}: a control passed the gates: {json.dumps(g0)}")
        why = tp_token_gate(r0["parts"], r0["max_teacher_forced_dist"])
        if why:
            fail(f"tp {tag}: against the single device: {why}")
        if "control" in r0:
            c = r0["control"]
            c["gate"] = tp_token_gate(c["parts"], c["max_teacher_forced_dist"])
            print(f"tp {tag}: control (sub-norms over each rank's slice): " + json.dumps(c))
            if not c["gate"]:
                fail(f"tp {tag}: the control passed the token gate: {json.dumps(c)}")
        for toks in r0["tp_tokens"]:
            if len(toks) != TP_NEW:
                fail(f"tp {tag}: a request ended with {len(toks)} tokens")
        if "http" in r0:
            h, per_pass = r0["http"], 7 * r0["layers"]
            lg = h["long"]
            if not (h["completions"] == 4 and h["equal_to_generate"]):
                fail(f"tp {tag}: HTTP completions {json.dumps(h)}")
            if not (lg["prompt_tokens"] >= lg["max_context"] and lg["tokens"] == 4
                    and lg["equal_to_generate"] and lg["k7"] == 4 * per_pass):
                fail(f"tp {tag}: the long completion over HTTP {json.dumps(lg)}")
            if h["embedding_k7"] != per_pass:
                fail(f"tp {tag}: the TP embedding launched K7 {h['embedding_k7']} times")
            print(f"tp {tag}: over HTTP (create_server(tp={world}, long_context=True)): "
                  f"{h['embedding']}, K7 {h['embedding_k7']} launches on the leader alone, "
                  f"{h['embedding_s']} s; a {lg['prompt_tokens']}-token completion (max_context "
                  f"{lg['max_context']}) through the ring on the model group, equal to "
                  f"generate's, {lg['seconds']} s, K7 {lg['k7']} launches on rank 0; memory "
                  f"per rank (built / peak GB) "
                  f"{[(r['http']['memory']['built_gb'], r['http']['memory']['peak_gb']) for r in ranks]}"
                  f" (the leader keeps the unsharded snapshot); {smi}")
        if "ring" in r0:
            check_tp_ring(tag, ranks, smi)
        same = sum(a == b for a, b in zip(r0["tp_tokens"], r0["single_tokens"]))
        print(f"tp {tag}: {world} ranks on one card over gloo (gloo copies the CUDA tensors "
              f"through the host), {r0['layers']} layers, KV {'replicated' if r0['kv_replicated'] else 'head-sharded'}"
              f" ({r0['pool_kv_heads']} heads a pool); {same}/{len(TP_LENS)} requests equal to "
              f"the single device's, parts {json.dumps(r0['parts'])}; largest teacher-forced "
              f"logit distance {r0['max_teacher_forced_dist']} (cap {TP_DIST_CAP}; the "
              f"30-layer rounding noise {TP_NOISE}); gates {json.dumps(r0.get('gates'))}; "
              f"rank 0's job {r0['seconds']} s; {smi}")
        for r in ranks:
            print("tp: " + json.dumps(dict(
                run=tag, rank=r["rank"], launches=r["launches"], window=r["window"],
                peak_gb=r["peak_gb"], pool_gb=r["pool_gb"], seconds=r["seconds"],
                requests_s=r.get("requests_s"), lockstep_messages=r["lockstep_messages"],
                http=r.get("http"))))
    ring = worlds["2B tp2"][0]["ring"]["bf16"]
    # (c) a mesh of one on NCCL (make_mesh forms this process's default group)
    cfg = BitNetConfig.bitnet_2b()
    params = init_params(cfg, seed=0, device=dev)
    mesh = make_mesh(1, 1, device=dev)
    if mesh.backend != "nccl":
        fail(f"tp: the mesh of one runs on {mesh.backend}, not NCCL")
    eng = Engine(params, cfg, EngineConfig(**TP_ECFG), mesh=mesh)
    fa.flash_paged_decode.launches = tc.ternary_matmul_stacked.launches = 0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in TP_LENS]
    rec = LogitsRecorder()
    reqs = _tp_engine_run(eng, cfg, prompts, rec)
    if not (fa.flash_paged_decode.launches and tc.ternary_matmul_stacked.launches):
        fail("tp: the NCCL mesh of one did not launch K6 and K7")
    calls = dict(mesh.model.calls)
    del eng
    single = Engine(params, cfg, EngineConfig(**TP_ECFG), device=dev,
                    linear_fn=tc.make_linear_stacked())
    sreqs = _tp_engine_run(single, cfg, prompts, rec)
    got = [r.output_ids for r in reqs]
    if any(len(t) != TP_NEW for t in got):
        fail("tp: the NCCL mesh of one ended a request early")
    parts, dist = tp_compare(sampling, prompts, sreqs, reqs, rec.runs[1], rec.runs[0])
    lead = [next((i for i, (a, b) in enumerate(zip(x.output_ids, y.output_ids)) if a != b),
                 TP_NEW) for x, y in zip(reqs, sreqs)]
    print(f"tp: a mesh of one on NCCL served {len(reqs)} requests x {TP_NEW} tokens; leading "
          f"tokens equal to the single device's {lead} of {TP_NEW}, parts {json.dumps(parts)}; "
          f"largest teacher-forced logit distance {dist} (cap {TP_DIST_CAP}); collectives "
          f"{calls}")
    why = tp_token_gate(parts, dist)
    if why:
        fail(f"tp: the NCCL mesh of one against the single device: {why}")
    del single, rec
    torch.cuda.empty_cache()
    # the TP world's ring against the ring on this mesh's group of one
    lce = LongContextEngine(params, cfg, mesh.model.group, device=dev)
    prompt = np.random.default_rng(27).integers(1, cfg.vocab_size, TP_RING_TOKENS).tolist()
    logits0, pk, pv = lce._prefill(torch.tensor([prompt], device=dev), TP_RING_TOKENS)
    rest = []  # greedy, as generate, with each step's logits
    one = [int(logits0[0].argmax())] + lce._decode(
        pk, pv, logits0[0].argmax(), TP_RING_TOKENS, TP_RING_NEW - 1, logits_out=rest)
    l_one = [logits0[0].float()] + [x[0].float() for x in rest]
    l_tp = ring["logits"].to(dev)
    j = next((i for i, (a, b) in enumerate(zip(one, ring["tokens"])) if a != b), None)
    upto = TP_RING_NEW if j is None else j + 1
    d = max(float((l_tp[i] - l_one[i]).abs().max()) for i in range(upto))
    why = "" if j is None else near_tie(sampling, l_one[j], l_tp[j], SamplingParams(
        max_new_tokens=TP_RING_NEW, temperature=0.0), j, one[j], ring["tokens"][j], d)
    print(f"tp: the bf16 ring of the tp 2 world ({TP_RING_TOKENS}-token prompt) against the "
          f"ring on a group of one here: tokens {ring['tokens']} / {one}, "
          f"{'equal' if j is None else f'part at token {j}'}; teacher-forced logit distance "
          f"up to {d} on the common prefix{f'; {why}' if why else ''}")
    if why:
        fail(f"tp: the TP ring's bf16 tokens part from the group of one's beyond a near-tie: "
             f"{why}")
    del lce, pk, pv, rest, params
    torch.cuda.empty_cache()
    # the pp_ep phase's parts in the worlds count in its own wall
    pp_ep_s = sum(ranks[0]["pp_ep"]["seconds"] + ranks[0].get("pp_ep_k7_s", 0.0)
                  for ranks in worlds.values() if "pp_ep" in ranks[0])
    print(f"tp: phase wall {time.perf_counter() - t_phase - pp_ep_s} s")
    return worlds


# ---------------------------------------------------------------------------
# 17. pp_ep — pipeline and expert parallelism (parallel/pipeline.py,
# parallel/expert.py) in the tp phase's gloo worlds of 2 and 4 ranks on this
# card, held to the same functions run at one stage / one expert rank in
# this process on its NCCL mesh of one
# ---------------------------------------------------------------------------

# the pipeline's cases, by the size of the world they run in: a prompt of
# batch x prompt tokens (seed 0) on a cache of T, then greedy one-token steps
PP_CASES = {
    "2B S2 M2": dict(world=2, model="bitnet_2b", microbatches=2, batch=8, prompt=256, T=512,
                     steps=8),
    "2B S2 M4": dict(world=2, model="bitnet_2b", microbatches=4, batch=8, prompt=256, T=512,
                     steps=8),
    # Llama-3-8B ternary at full depth, 8 layers a stage
    "llama8b S4 M2": dict(world=4, model="llama3_8b_ternary", microbatches=2, batch=4,
                          prompt=128, T=256, steps=4),
}
# the planted control: stage 1 runs its layers on what it received a tick
# earlier
PP_CONTROL = "2B S2 M2"
# layer 0's experts of the repo's MoE configuration (scripts/serving_bench.py
# --model moe: 2B widths, 8 experts, top-2) on 1024 tokens (seed 0): capacity
# factor 8 drops nothing, 0.25 is the control
EP_TOKENS = 1024
EP_FACTORS = {"no drop": 8.0, "control": 0.25}
# the all-to-all y against the dense moe_ffn, and the mesh's dense moe_ffn
# against one device's: the largest difference over the largest |y|. Both
# sum the same f32 products in another order (or the card's norms reduce
# other row counts in another order) before one rounding to bf16, which
# moves an element by at most one bf16 unit (2^-8 of itself); the bar is two
# such units of the largest element
EP_REL_BAR = 2 ** -7
# aux is the mean of the ranks' losses on their own tokens (lax.pmean), a
# sum in gloo's order over the ranks: held to the same mean taken here
EP_AUX_TOL = 1e-6


def digest(t) -> str:
    """A tensor's bytes hashed (bitwise comparisons across processes)."""
    import hashlib

    import torch

    b = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(b.tobytes()).hexdigest()[:20]


def _moe_layer0(dev):
    """Layer 0's experts, router and ffn_sub of the repo's MoE
    configuration (init_params, seed 0) and the tokens (seed 0)."""
    import dataclasses

    import torch

    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.models.moe import EXPERT_KEYS

    cfg = dataclasses.replace(BitNetConfig.bitnet_2b(), num_layers=8, num_experts=8,
                              num_experts_per_tok=2)
    lay = init_params(cfg, seed=0, device=dev)["layers"]
    experts = {k: lay[f"moe_{k}"][0].clone() for k in EXPERT_KEYS}
    sub, router = lay["ffn_sub"][0].clone(), lay["router"][0].clone()
    del lay
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn((EP_TOKENS, cfg.hidden_size), generator=g, device=dev).to(cfg.dtype)
    return cfg, experts, sub, router, x


def pp_greedy(cfg, sp, mesh, case, keep_logits=False, stale_stage=None):
    """``make_pp_forward`` on this rank: the case's prompt, then its greedy
    steps. Per forward: the logits' digest (and the logits, f32 on the host,
    with ``keep_logits``), the argmax tokens, K7's launches and tiled
    launches and the stage axis's calls, each counted from 0 at the
    forward's start; then this stage's cache digests. ``stale_stage``: the
    planted control, that stage runs its layers on what it received a tick
    earlier."""
    import dataclasses

    import numpy as np
    import torch

    from wrinklefree_tpu_torch.models.bitnet import KVCache
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.parallel.pipeline import make_pp_forward

    ax, dev = mesh.axis["stage"], mesh.device
    B, n = case["batch"], case["prompt"]
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab_size, (B, n))).to(dev)
    lcfg = dataclasses.replace(cfg, num_layers=cfg.num_layers // ax.size)
    cache = KVCache.zeros(lcfg, B, case["T"], device=dev)
    f = make_pp_forward(cfg, mesh, num_microbatches=case["microbatches"])
    prev = []
    if stale_stage == ax.index:
        sound = ax.ppermute

        def stale(x, perm):
            got = sound(x, perm)
            out = prev[-1] if prev and prev[-1].shape == got.shape else torch.zeros_like(got)
            prev.append(got)
            return out

        ax.ppermute = stale
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    out = dict(tokens=[], logits=[], digests=[], launches=[], calls=[])
    k7 = tc.ternary_matmul_stacked
    try:
        for i in range(case["steps"] + 1):
            prev.clear()
            k7.launches = k7.tiled_launches = 0
            ax.calls.clear()
            logits, cache = f(sp, toks, cache, start)
            out["launches"].append((k7.launches, k7.tiled_launches))
            out["calls"].append(dict(ax.calls))
            out["digests"].append(digest(logits))
            if keep_logits:
                out["logits"].append(logits.float().cpu())
            nxt = logits.argmax(-1)
            out["tokens"].append(nxt.tolist())
            toks = nxt[:, None]
            start = torch.full((B,), n + i, dtype=torch.int32, device=dev)
    finally:
        if stale_stage == ax.index:
            ax.ppermute = sound
    out["cache"] = (digest(cache.k), digest(cache.v))
    return out, cache


def forward_greedy(cfg, params, case, dev, rows):
    """``models.bitnet.forward`` with the same K7 linear
    (``make_linear()``) on the whole params: the case's prompt and greedy
    steps, run on each block of ``rows`` batch rows on its own (a greedy
    row depends on its own tokens alone); per forward the argmax tokens and
    the f32 logits on the host, the blocks laid back in batch order."""
    import numpy as np
    import torch

    from wrinklefree_tpu_torch.models.bitnet import KVCache, forward
    from wrinklefree_tpu_torch.ops.ternary_cuda import make_linear

    B, n = case["batch"], case["prompt"]
    prompt = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab_size, (B, n)))
    lf = make_linear()
    blocks = []
    for r0 in range(0, B, rows):
        toks = prompt[r0:r0 + rows].to(dev)
        cache = KVCache.zeros(cfg, rows, case["T"], device=dev)
        start = torch.zeros(rows, dtype=torch.int32, device=dev)
        run = dict(tokens=[], logits=[])
        for i in range(case["steps"] + 1):
            logits, cache = forward(params, cfg, toks, cache, start, linear_fn=lf,
                                    logits_all=False)
            run["logits"].append(logits.float().cpu())
            nxt = logits.argmax(-1)
            run["tokens"].append(nxt.tolist())
            toks = nxt[:, None]
            start = torch.full((rows,), n + i, dtype=torch.int32, device=dev)
        blocks.append(run)
    steps = range(case["steps"] + 1)
    return dict(tokens=[sum((b["tokens"][i] for b in blocks), []) for i in steps],
                logits=[torch.cat([b["logits"][i] for b in blocks]) for i in steps])


def pp_compare(sampling, want, got):
    """A pipeline run's greedy rows against ``forward``'s, as ``tp_compare``
    holds requests: per batch row the largest logit distance over the steps
    both computed on the same prefix (up to and with the first step where
    their tokens part), and at that step ``near_tie``'s verdict. Returns
    (parts, the largest distance)."""
    from wrinklefree_tpu_torch.engine import SamplingParams

    greedy = SamplingParams(temperature=0.0)
    parts, dists = [], []
    steps = len(want["tokens"])
    for b in range(len(want["tokens"][0])):
        ta = [want["tokens"][i][b] for i in range(steps)]
        tb = [got["tokens"][i][b] for i in range(steps)]
        j = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y), None)
        upto = steps if j is None else j + 1
        d = max(float((got["logits"][i][b] - want["logits"][i][b]).abs().max())
                for i in range(upto))
        dists.append(d)
        if j is not None:
            why = near_tie(sampling, want["logits"][j][b], got["logits"][j][b], greedy, j,
                           ta[j], tb[j], d)
            parts.append(dict(row=b, step=j, dist=d, why=why))
    return parts, max(dists)


def ep_run(mesh, cfg, experts, sub, router, x, factor, dense=False):
    """This rank's expert-parallel MoE FFN on ``x`` (whole, the same on
    every rank): ``make_ep_moe`` at capacity ``factor``, or with ``dense``
    the dense-dispatch ``moe_ffn(ep_axis=)`` on all tokens with this rank's
    block of experts. Returns y's digest, y (f32 on the host), aux, K7's
    launches and tiled launches and the axis's calls, counted from 0."""
    from wrinklefree_tpu_torch.models.moe import moe_ffn
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.ternary_cuda import make_linear
    from wrinklefree_tpu_torch.parallel.expert import make_ep_moe

    ax = mesh.axis["expert"]
    k7 = tc.ternary_matmul_stacked
    kw = dict(top_k=cfg.num_experts_per_tok, eps=cfg.rms_norm_eps)
    if dense:
        e = experts["gate_qw"].shape[0] // ax.size
        mine = {k: v[ax.index * e:(ax.index + 1) * e] for k, v in experts.items()}
        fn = lambda: moe_ffn(x, mine, sub, router, lf=make_linear(),  # noqa: E731
                             ep_axis=ax if ax.size > 1 else None, **kw)
    else:
        fn = make_ep_moe(mesh, experts, sub, router, capacity_factor=factor, **kw)
        fn = (lambda apply: lambda: apply(x))(fn)
    k7.launches = k7.tiled_launches = 0
    ax.calls.clear()
    y, aux = fn()
    return dict(digest=digest(y), y=y.float().cpu(), aux=float(aux),
                launches=(k7.launches, k7.tiled_launches), calls=dict(ax.calls))


def pp_ep_job(world, dev):
    """One rank's pp_ep part in a tp world of ``world`` ranks (every rank
    runs it): the pipeline cases of this world on a ``stage`` axis over all
    ranks (and, in the world of 2, the planted control), then layer 0's
    experts on an ``expert`` axis: ``make_ep_moe`` at each capacity factor
    and the dense ``moe_ffn(ep_axis=)``. Rank 0 keeps the logits and y for
    the comparisons. Returns the rank's report."""
    import torch

    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.parallel.pipeline import shard_params_pp
    from wrinklefree_tpu_torch.parallel.sharding import make_named_mesh

    t0 = time.perf_counter()
    cuda = dev.type == "cuda"  # the CPU rehearses the job
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_named_mesh({"stage": world}, device=dev, backend="gloo")
    rank0 = mesh.axis["stage"].index == 0
    report = dict(rank=mesh.axis["stage"].index, pp={}, ep={})
    sp = model = None
    for name, case in PP_CASES.items():
        if case["world"] != world:
            continue
        cfg = getattr(BitNetConfig, case["model"])()
        if case["model"] != model:
            sp, model = None, case["model"]
            sp = shard_params_pp(init_params(cfg, seed=0, device=dev), mesh)
        t1 = time.perf_counter()
        run, _ = pp_greedy(cfg, sp, mesh, case, keep_logits=rank0)
        run["seconds"] = time.perf_counter() - t1
        report["pp"][name] = run
        if name == PP_CONTROL:
            report["pp_control"], _ = pp_greedy(cfg, sp, mesh, case, keep_logits=rank0,
                                                stale_stage=1)
    del sp
    if cuda:
        torch.cuda.empty_cache()
    emesh = make_named_mesh({"expert": world}, device=dev, backend="gloo")
    mcfg, experts, sub, router, x = _moe_layer0(dev)
    for tag, factor in EP_FACTORS.items():
        report["ep"][tag] = ep_run(emesh, mcfg, experts, sub, router, x, factor)
    report["ep"]["dense"] = ep_run(emesh, mcfg, experts, sub, router, x, None, dense=True)
    if not rank0:  # rank 0 alone returns the logits and y
        for r in list(report["pp"].values()) + [report.get("pp_control", {})]:
            r["logits"] = []
        for r in report["ep"].values():
            r["y"] = None
    report["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    report["seconds"] = time.perf_counter() - t0
    return report


def phase_pp_ep(dev, smi, worlds):
    """17. pp_ep — pipeline and expert parallelism on this card. The ranks'
    parts ran at the end of the tp phase's 2B worlds of 2 and 4 ranks
    (``pp_ep_job``: gloo groups carrying CUDA tensors, every rank on
    ``cuda:0``); this process, on its NCCL mesh of one, runs what they are
    held to and checks:

    (a) the pipeline (``make_pp_forward``, K7 linears) on 2B at 2 stages with
        2 and 4 microbatches (B 8, a 256-token prompt, T 512, 8 greedy steps)
        and on Llama-3-8B ternary at full depth (32 layers, 8 a stage) at 4
        stages, 2 microbatches (B 4, 128 tokens, T 256, 4 steps): every
        stage's logits at every forward and its cache shard bitwise equal to
        the same ``make_pp_forward`` at one stage here; per stage and forward
        exactly 7 x L/S x M K7 launches (all tiled in the prefill, none in
        the steps), S+M-1 shifts and one broadcast; the greedy rows against
        ``forward`` with the same K7 linear on the microbatches' rows under
        ``tp_token_gate`` (near-ties only, the teacher-forced distance under
        ``TP_DIST_CAP``; ``forward`` on the whole batch is printed beside it);
        the planted control (stage 1 a tick stale) must fail both gates;
    (b) layer 0's experts of the MoE configuration on 1024 tokens at ep 2 and
        4: ``make_ep_moe``'s y bitwise equal to ep 1's here without drops,
        aux within ``EP_AUX_TOL`` of the mean of the ranks' own losses, y
        within ``EP_REL_BAR`` of the dense ``moe_ffn``; the tight capacity
        (the control) finite and outside that bar; 2 all-to-alls and 3 x E/ep
        K7 launches per rank; the dense ``moe_ffn(ep_axis=)`` within the bar
        of one device's, its psum counted.
    Returns K7's (launches, tiled launches) over the ranks' sound runs."""
    import torch

    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.models.moe import load_balancing_loss, router_logits, top_k_route
    from wrinklefree_tpu_torch.ops import sampling
    from wrinklefree_tpu_torch.parallel.expert import capacity_for
    from wrinklefree_tpu_torch.parallel.pipeline import shard_params_pp
    from wrinklefree_tpu_torch.parallel.sharding import make_named_mesh

    t_phase = time.perf_counter()
    ranks = {2: [r["pp_ep"] for r in worlds["2B tp2"]], 4: [r["pp_ep"] for r in worlds["2B tp4"]]}
    for world, rs in ranks.items():
        if [r["rank"] for r in rs] != list(range(world)):
            fail(f"pp_ep: the world of {world} reported stages {[r['rank'] for r in rs]}")
    for row in worlds["2B tp2"][0].get("pp_ep_k7", ()):
        print("pp_ep: K7 " + json.dumps(row))
    total = [0, 0]
    mesh = make_named_mesh({"stage": 1}, device=dev)
    model = params = sp = None
    whole = {}
    for name, case in PP_CASES.items():
        world, M = case["world"], case["microbatches"]
        cfg = getattr(BitNetConfig, case["model"])()
        if case["model"] != model:
            params = sp = None
            torch.cuda.empty_cache()
            params = init_params(cfg, seed=0, device=dev)
            sp, model = shard_params_pp(params, mesh), case["model"]
        one, cache = pp_greedy(cfg, sp, mesh, case)
        n = cfg.num_layers // world
        mb = case["batch"] // M
        for r in ranks[world]:
            run, s = r["pp"][name], r["rank"]
            if run["digests"] != one["digests"]:
                bad = [i for i, (a, b) in enumerate(zip(run["digests"], one["digests"])) if a != b]
                fail(f"pp_ep {name}: stage {s}'s logits differ from one stage's at forwards {bad}")
            want = (digest(cache.k[s * n:(s + 1) * n]), digest(cache.v[s * n:(s + 1) * n]))
            if run["cache"] != want:
                fail(f"pp_ep {name}: stage {s}'s cache shard differs from one stage's layers")
            for i, (lt, calls) in enumerate(zip(run["launches"], run["calls"])):
                k7 = 7 * n * M
                rows = mb * (case["prompt"] if i == 0 else 1)
                if tuple(lt) != (k7, k7 if rows > 8 else 0):
                    fail(f"pp_ep {name}: stage {s}, forward {i}: K7 (launches, tiled) {lt}, "
                         f"expected ({k7}, {k7 if rows > 8 else 0})")
                if calls != {"ppermute": world + M - 1, "broadcast": 1}:
                    fail(f"pp_ep {name}: stage {s}, forward {i}: collectives {calls}")
                total[0] += lt[0]
                total[1] += lt[1]
        # forward on the microbatches' rows: the shapes a stage computes on.
        # On the whole batch the card's batched attention products and norms
        # take other reduction orders, which moves the 30-layer logits by
        # rounding noise (printed, not gated)
        ref = forward_greedy(cfg, params, case, dev, mb)
        parts, dist = pp_compare(sampling, ref, ranks[world][0]["pp"][name])
        why = tp_token_gate(parts, dist)
        if why:
            fail(f"pp_ep {name}: against forward: {why}")
        if whole.get("model") != case["model"]:  # one run serves the model's cases
            whole = dict(model=case["model"],
                         run=forward_greedy(cfg, params, case, dev, case["batch"]))
        whole_parts, whole_dist = pp_compare(sampling, whole["run"], ranks[world][0]["pp"][name])
        same = sum(all(a[b] == c[b] for a, c in zip(ref["tokens"], ranks[world][0]["pp"][name]
                                                     ["tokens"])) for b in range(case["batch"]))
        print(f"pp_ep {name}: {world} stages on one card over gloo, {cfg.num_layers} layers, "
              f"{M} microbatches; logits at {len(one['digests'])} forwards and every cache shard "
              f"bitwise equal to one stage's; K7 {7 * n * M} launches a stage a forward; "
              f"{world + M - 1} shifts + 1 broadcast a forward; against forward: {same}/"
              f"{case['batch']} rows equal over {case['steps'] + 1} tokens, parts "
              f"{json.dumps(parts)}, largest teacher-forced logit distance {dist} (cap "
              f"{TP_DIST_CAP}; forward on the whole batch of {case['batch']} rows: "
              f"{whole_dist}, parts {json.dumps(whole_parts)}, the 30-layer rounding noise "
              f"{TP_NOISE}); wall a stage {[r['pp'][name]['seconds'] for r in ranks[world]]} "
              f"s; {smi}")
        if name == PP_CONTROL:
            ctl = [r["pp_control"] for r in ranks[world]]
            bitwise = all(c["digests"] == one["digests"] for c in ctl)
            cparts, cdist = pp_compare(sampling, ref, ctl[0])
            cwhy = tp_token_gate(cparts, cdist)
            print(f"pp_ep {name}: control (stage 1 a tick stale): bitwise equal to one stage "
                  f"{bitwise}; token gate: {cwhy[:300]!r}")
            if bitwise or not cwhy:
                fail(f"pp_ep {name}: the control passed a gate (bitwise {bitwise}, token gate "
                     f"{cwhy!r})")
        del one, cache, ref
    params = sp = whole = None
    torch.cuda.empty_cache()

    emesh = make_named_mesh({"expert": 1}, device=dev)
    mcfg, experts, sub, router, x = _moe_layer0(dev)
    E, k = mcfg.num_experts, mcfg.num_experts_per_tok
    one = {tag: ep_run(emesh, mcfg, experts, sub, router, x, f) for tag, f in EP_FACTORS.items()}
    dense = ep_run(emesh, mcfg, experts, sub, router, x, None, dense=True)
    scale = float(dense["y"].abs().max())

    def rel(y):
        return float((y - dense["y"]).abs().max()) / scale

    if rel(one["no drop"]["y"]) > EP_REL_BAR:
        fail(f"pp_ep: ep 1's y parts from the dense moe_ffn by {rel(one['no drop']['y'])}")
    for world, rs in ranks.items():
        T = EP_TOKENS // world
        losses = []
        for i in range(world):
            xs = x[i * T:(i + 1) * T]
            logits = router_logits(xs, router)
            losses.append(load_balancing_loss(torch.softmax(logits, -1),
                                              top_k_route(logits, k)[1], E))
        aux_want = float(sum(losses) / world)
        for r in rs:
            ep = r["ep"]
            if ep["no drop"]["digest"] != one["no drop"]["digest"]:
                fail(f"pp_ep: ep {world}, rank {r['rank']}: y differs from ep 1's")
            if abs(ep["no drop"]["aux"] - aux_want) > EP_AUX_TOL:
                fail(f"pp_ep: ep {world}, rank {r['rank']}: aux {ep['no drop']['aux']}, the "
                     f"ranks' mean {aux_want}")
            for tag in list(EP_FACTORS) + ["dense"]:
                # each local expert's three linears on ep x C rows (all the
                # tokens in the dense form)
                rows = (EP_TOKENS if tag == "dense" else
                        world * capacity_for(T, k, E, EP_FACTORS[tag]))
                want = (3 * E // world, 3 * E // world if rows > 8 else 0)
                if tuple(ep[tag]["launches"]) != want:
                    fail(f"pp_ep: ep {world} {tag}: K7 (launches, tiled) {ep[tag]['launches']},"
                         f" expected {want}")
                calls = {"psum": 1} if tag == "dense" else {"all_to_all": 2, "psum": 1,
                                                           "all_gather": 1}
                if ep[tag]["calls"] != calls:
                    fail(f"pp_ep: ep {world} {tag}: collectives {ep[tag]['calls']}, expected "
                         f"{calls}")
                total[0] += ep[tag]["launches"][0]
                total[1] += ep[tag]["launches"][1]
        ep = rs[0]["ep"]
        d_a2a, d_ctl, d_dense = rel(ep["no drop"]["y"]), rel(ep["control"]["y"]), rel(
            ep["dense"]["y"])
        if d_a2a > EP_REL_BAR or d_dense > EP_REL_BAR:
            fail(f"pp_ep: ep {world}: y parts from the dense moe_ffn by {d_a2a} (all-to-all), "
                 f"{d_dense} (dense on the mesh), bar {EP_REL_BAR}")
        if not (bool(torch.isfinite(ep["control"]["y"]).all()) and d_ctl > EP_REL_BAR):
            fail(f"pp_ep: ep {world}: the control (capacity {EP_FACTORS['control']}) is not "
                 f"finite or passed the bar: {d_ctl}")
        print(f"pp_ep: ep {world}, {EP_TOKENS} tokens, {E} experts top-{k}: all-to-all y bitwise "
              f"equal to ep 1's on {world}/{world} ranks, {d_a2a} of the dense moe_ffn's largest "
              f"|y| {scale} (bar {EP_REL_BAR}); aux {ep['no drop']['aux']} (ranks' mean "
              f"{aux_want}; whole batch {one['no drop']['aux']}); control at capacity "
              f"{EP_FACTORS['control']}: {d_ctl}, finite; collectives a call "
              f"{ep['no drop']['calls']}"
              f" (all-to-all), {ep['dense']['calls']} (dense moe_ffn on the mesh: {d_dense}); K7 "
              f"{3 * E // world} launches a rank a call; peak GB a rank "
              f"{[r['peak_gb'] for r in rs]}; pp_ep wall a rank {[r['seconds'] for r in rs]} s; "
              f"{smi}")
    del experts, x, one, dense
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase + sum(
        ranks[0]["pp_ep"]["seconds"] + ranks[0].get("pp_ep_k7_s", 0.0)
        for ranks in (worlds["2B tp2"], worlds["2B tp4"]))
    print(f"pp_ep: phase wall {wall} s")
    return total


def main() -> int:
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from wrinklefree_tpu_torch.bench.roofline import GPU_SPECS, peak_ops
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
    global HBM_BYTES_PER_S
    HBM_BYTES_PER_S = GPU_SPECS["h100"]["hbm_bw"]
    PEAK_OPS.update(peak_ops("h100"))

    secs = cuda_lib.timed_build()
    report = cuda_lib.BUILD_DIR / "ptxas.txt"
    per = ([line[3:] for line in report.read_text().splitlines() if line.startswith("== ")]
           if report.exists() else [])
    print(f"build: {secs} s ({cuda_lib.build()}); per source: {', '.join(per)}")
    print(f"build: phase wall {secs} s")
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
    with phase_wall("kernels"):
        phase_kernels(params, cfg, dev, results)
    # the health stamp early: its busy share is read by the profiler, whose
    # sessions late in a long process have come back empty
    with phase_wall("calibrate"):
        calibrate_launches = phase_calibrate(dev)
    with phase_wall("forward"):
        floors = phase_forward(params, cfg, dev)
        phase_prefill(params, cfg, dev)
    # the batch-1 path reads the int8 head (its exact head scans it); the
    # engine's params keep the bf16 head only
    flash_prefill_launches = fa.flash_prefill.launches  # it has no path: the kernels phase's
    with phase_wall("batch1"):
        batch1 = phase_batch1(quantize_lm_head(params, cfg), cfg, dev, floors,
                              [tc.attn_block_megakernel, tc.mlp_block_megakernel,
                               tc.ternary_matmul_stacked_fused, tc.layer_block_megakernel,
                               tc.attn_block_megakernel_static, tc.mlp_block_megakernel_static])
    serving = [tc.ternary_matmul_stacked_fused, TiledCounter(tc.ternary_matmul_stacked_fused),
               tc.mlp_block_megakernel, kvu.kv_write, fa.flash_paged_prefill]
    # the two windows' device ms per decode step in the reference run
    # (PERF.md section 5); the flash_decode window also K6's
    with phase_wall("engine"):
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
    with phase_wall("preempt"):
        phase_preempt(params, cfg, dev, serving)
    with phase_wall("features"):
        phase_features(params, cfg, dev, serving, smi.splitlines()[0])
    with phase_wall("heads_kv"):
        engines = phase_heads_kv(params, cfg, dev, serving, toks, results,
                                 smi.splitlines()[0])
    launches["kv_write/token"] = engines["token"]["kv_write"]
    launches["flash_paged_prefill/contiguous"] = engines["token"]["flash_paged_prefill"]
    for dt in ("fp16", "f32"):
        launches[f"flash_paged_prefill/{dt}"] = engines[f"layer {dt}"]["flash_paged_prefill"]
        launches[f"flash_paged_decode/{dt}"] = engines[f"layer {dt}"]["flash_paged_decode"]
        launches[f"flash_paged_prefill/contiguous/{dt}"] = (
            engines[f"token {dt}"]["flash_paged_prefill"])
    torch.cuda.empty_cache()
    with phase_wall("spec"):
        phase_spec(params, cfg, dev, serving, smi.splitlines()[0])
    del params
    torch.cuda.empty_cache()
    with phase_wall("sparsity"):
        phase_sparsity(cfg, dev, smi.splitlines()[0])
    torch.cuda.empty_cache()
    with phase_wall("load"):
        phase_load(cfg, dev, serving, smi.splitlines()[0])
    torch.cuda.empty_cache()
    with phase_wall("server"):
        phase_server(dev, serving)
    torch.cuda.empty_cache()
    with phase_wall("serving"):
        phase_serving_bench(dev, serving)
    torch.cuda.empty_cache()
    with phase_wall("moe"):
        moe = phase_moe(dev)
    torch.cuda.empty_cache()
    # in a fresh process: torch.profiler sessions late in this long process
    # have come back empty
    longctx = in_fresh_process("phase_longctx", smi.splitlines()[0])
    for name in ("ternary_matmul_stacked", "ternary_matmul_stacked/tiled"):
        launches[name] = moe[name] + longctx[name]
    torch.cuda.empty_cache()
    worlds = phase_tp(dev, smi.splitlines()[0])
    torch.cuda.empty_cache()
    pp_ep = phase_pp_ep(dev, smi.splitlines()[0], worlds)
    launches["ternary_matmul_stacked"] += pp_ep[0]
    launches["ternary_matmul_stacked/tiled"] += pp_ep[1]
    launches["measure_stream_us_per_layer"] = calibrate_launches

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
