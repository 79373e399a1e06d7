#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wrinklefree_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``wrinklefree_tpu_torch/csrc`` and runs six phases at
BitNet b1.58-2B width (30 layers, H 2560, I 6912, 20 query / 5 KV heads,
vocab 128256) with random weights drawn on the card from seed 0:

1. build    — compile the kernels (one nvcc per source, in parallel);
2. kernels  — every kernel against its plain PyTorch version on the same
              inputs at the main paths' shapes, timed beside its bound
              (bytes over 3.35 TB/s or operations over the published dense
              peak) and a PyTorch library call;
3. forward  — ``paged_forward``: a 128-token prefill chunk and 4 decode
              steps, once through the kernels and once through the plain
              functions, logits compared;
4. batch1   — ``models.bitnet.forward`` at batch 1 (the path of
              ``wrinklefree_tpu_torch.bench.decode``): 8 decode steps
              through the kernels vs the plain functions; a 64-token
              prefill and 64 greedy steps whose exact head must equal the
              bf16 head's argmax every step, with the attention and MLP
              block kernels launched once per layer and step; then the
              bench's timed windows and the device's busy share;
5. engine   — ``Engine``: six greedy requests (prompts of 17..700 tokens,
              32 new tokens each) and two radix-cache resubmissions, every
              serving kernel's launch counter growing; then the six
              requests again with ``flash_decode=True``, whose decode
              attention kernel must launch;
6. moe      — the repo's MoE configuration (8 layers, 8 experts, top-2) on
              the unfused stacked linear and K7 experts: kernels vs plain,
              the fake-MoE oracle bit for bit against the dense model, and
              the engine phase with K7's launches per decode step counted.

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
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}  # published dense tensor-core peaks

KERNELS = {
    "ternary_matmul_stacked_fused": {
        "source": "wrinklefree_tpu_torch/csrc/ternary.cu",
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
        "source": "wrinklefree_tpu_torch/csrc/flash_prefill.cu",
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
        "source": "wrinklefree_tpu_torch/csrc/ternary.cu",
        "replaces": "wrinklefree_tpu/ops/ternary_pallas.py:228",
        # the same kernel on one [K/4, N] matrix (ROADMAP queue 2 row 5)
        "also_replaces": "wrinklefree_tpu/ops/ternary_pallas.py:132",
    },
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3):
    """(device ms, call ms) per call of fn. Device ms is the sum of the
    device activity (kernels, copies, sets) that torch.profiler records over
    `iters` calls; call ms is CUDA-event time between the first and the last
    call, which includes the host's launch overhead when that is the
    longer of the two."""
    import torch
    from torch.autograd import DeviceType
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
        dev_us = sum(e.device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
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

    # ---- K1 at the four linears of a layer, at 1, 8 and 512 rows
    shapes = [  # name, weights, scales, norm row, act, input width
        ("qkv", "qkv", "input_ln", "none", H),
        ("o", "o", "attn_sub", "none", Q),
        ("gateup", "gateup", "post_ln", "none", H),
        ("down", "down", "ffn_sub", "relu2", 2 * I),
    ]
    k1_rows, k1_err = [], 0.0
    for name, w, nrm, act, kin in shapes:
        qw, sw, nw = st[w + "_qw"], st[w + "_scale"], st[nrm]
        k, n = 4 * qw.shape[1], qw.shape[2]
        # the library yardstick: bf16 matmul against every layer's unpacked
        # weight, cycled like the kernel's layers
        wls = [unpack_ternary(qw[i]).to(torch.bfloat16) for i in range(L)]
        for rows in (1, 8, 512):
            x = rnd(rows, kin)
            lay = Cycle(L)
            a = tc.ternary_matmul_stacked_fused(x, qw, 3, sw, nw, act=act)
            b = tc.ternary_matmul_stacked_fused_plain(x, qw, 3, sw, nw, act=act)
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
            plain_ms, _ = cuda_ms(
                lambda: tc.ternary_matmul_stacked_fused_plain(x, qw, lay(), sw, nw, act=act),
                iters=5, warmup=1)
            xl = x[:, :k].contiguous()
            lib_ms, _ = cuda_ms(lambda: torch.matmul(xl, wls[lay()]))
            nbytes = rows * kin * 2 + k // 4 * n + n * 4 + k * 2 + rows * n * 2
            b_ms, b_by = bound(nbytes, 2 * rows * k * n, "int8")
            k1_rows.append(dict(shape=f"{name} {k}->{n} rows={rows}", ms=ms, call_ms=call_ms,
                                plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                                max_abs_err=d.max().item(), exact_share=eq))
        del wls
    for r in k1_rows:
        print("kernels: K1 " + json.dumps(r))
    pick = next(r for r in k1_rows if r["shape"].startswith("qkv") and r["shape"].endswith("=8"))
    results["ternary_matmul_stacked_fused"] = dict(pick, max_abs_err=k1_err)

    # ---- K2 at 1 and 8 rows
    k2_rows, k2_err = [], 0.0
    gw, dw = st["gateup_qw"], st["down_qw"]
    gs, ds, pl, fs = st["gateup_scale"], st["down_scale"], st["post_ln"], st["ffn_sub"]
    wgs = [unpack_ternary(gw[i]).to(torch.bfloat16) for i in range(L)]
    wds = [unpack_ternary(dw[i]).to(torch.bfloat16) for i in range(L)]
    for rows in (1, 8):
        h = rnd(rows, H)
        lay = Cycle(L)
        a = tc.mlp_block_megakernel(h, gw, dw, 3, gs, ds, pl, fs)
        b = tc.mlp_block_megakernel_plain(h, gw, dw, 3, gs, ds, pl, fs)
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
        nbytes = rows * H * 2 * 2 + H // 4 * 2 * I + I // 4 * H + (2 * I + H) * 4 + (H + I) * 2
        b_ms, b_by = bound(nbytes, 2 * rows * (H * 2 * I + I * H), "int8")
        k2_rows.append(dict(shape=f"mlp {H}->{2 * I}->{H} rows={rows}", ms=ms, call_ms=call_ms,
                            plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                            max_abs_err=d.max().item(), exact_share=(a == b).float().mean().item()))
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

    # ---- K4: a 512-token chunk over a 512-slot history, kv_valid < T, new_len < S
    B, S, T = 1, 512, 512
    NH, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = rnd(B, S, NH, D)
    kf, vf = rnd(B, T + S, KV, D), rnd(B, T + S, KV, D)
    kvv = torch.tensor([400], device=dev, dtype=torch.int32)
    nl = torch.tensor([500], device=dev, dtype=torch.int32)
    a = fa.flash_paged_prefill(q, kf, vf, kvv, nl, hist_len=T)
    b = fa.flash_paged_prefill_plain(q, kf, vf, kvv, nl, hist_len=T)
    torch.cuda.synchronize()
    d = (a[:, :500].float() - b[:, :500].float()).abs()
    # p is rounded to bf16 before PV in the kernel, after normalization in
    # the plain softmax
    if not (torch.isfinite(a).all() and d.max().item() <= 3e-2):
        fail(f"K4: max abs error {d.max().item()}")
    ms, call_ms = cuda_ms(lambda: fa.flash_paged_prefill(q, kf, vf, kvv, nl, hist_len=T))
    plain_ms, _ = cuda_ms(lambda: fa.flash_paged_prefill_plain(q, kf, vf, kvv, nl, hist_len=T))
    col = torch.arange(T + S, device=dev)
    row = torch.arange(S, device=dev)[:, None]
    mask = torch.where(col[None] < T, col[None] < 400, ((col - T)[None] <= row) & ((col - T)[None] < 500))
    qs, ks, vs = q.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms, _ = cuda_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask[None, None], enable_gqa=True))
    pairs = sum(400 + min(r + 1, 500) for r in range(500))  # visible (query, key) pairs
    nbytes = (S * NH * D * 2) * 2 + (400 + 500) * KV * D * 2 * 2
    b_ms, b_by = bound(nbytes, 4 * D * pairs * NH, "bf16")
    r = dict(shape=f"S={S} T={T} kv_valid=400 new_len=500 NH={NH} KV={KV}", ms=ms,
             call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
             max_abs_err=d.max().item())
    print("kernels: K4 " + json.dumps(r))
    results["flash_paged_prefill"] = r
    kernels_k5(params, cfg, dev, rnd, results)
    kernels_k6(cfg, dev, g, rnd, results)
    kernels_k7(params, cfg, dev, g, results)


def kernels_k5(params, cfg, dev, rnd, results):
    """K5, the batch-1 attention block, against its plain version at 2B
    shapes: caches of T = 328 (the bench's) and 2048 rows, pos 0, 47 and
    T - 1, layers 0 and 29. Bars: h' within 5% of its largest value and the
    written k/v rows within 3% of theirs (the prologues' variance and the
    scores sum in another order than torch's, so an int8 code can move by
    one, as for K1/K2); every other cache row bitwise unchanged."""
    import torch

    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.rope import rope_cos_sin
    from wrinklefree_tpu_torch.ops.ternary import unpack_ternary

    st = params["layers"]
    L, H, Q = cfg.num_layers, cfg.hidden_size, cfg.q_dim
    NH, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(q_dim=Q, n_kv=KV, n_heads=NH, head_dim=D, eps=cfg.rms_norm_eps)

    def call(fn, h, ck, cv, layer, pos, cos, sin):
        return fn(h, ck, cv, st["qkv_qw"], st["o_qw"], layer, pos, st["qkv_scale"],
                  st["o_scale"], st["input_ln"], st["attn_sub"], cos, sin, **kw)[0]

    wq = [unpack_ternary(st["qkv_qw"][i]).to(torch.bfloat16) for i in range(L)]
    wo = [unpack_ternary(st["o_qw"][i]).to(torch.bfloat16) for i in range(L)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, worst, exact_rows, checks = [], 0.0, 0, 0
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
                a = call(tc.attn_block_megakernel, h, ka, va, layer, p, cos, sin)
                b = call(tc.attn_block_megakernel_plain, h, kb, vb, layer, p, cos, sin)
                torch.cuda.synchronize()
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
            n_q = st["qkv_qw"].shape[2]
            nbytes = (H // 4 * n_q + Q // 4 * H + (n_q + H) * 4 + (H + Q) * 2 + 2 * H * 2
                      + 2 * D * 2 + 2 * (pos + 1) * KV * D * 2)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = (2 * (H * n_q + Q * H) / PEAK_OPS["int8"]
                     + 4 * NH * D * (pos + 1) / PEAK_OPS["bf16"]) * 1e3
            b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            rows.append(dict(shape=f"attention block T={T} pos={pos}", ms=ms, call_ms=call_ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             library="bf16 matmul qkv + SDPA over pos+1 rows + bf16 matmul o",
                             bound_ms=b_ms, bound_by=b_by))
    del wq, wo
    for r in rows:
        print("kernels: K5 " + json.dumps(r))
    print(f"kernels: K5 {checks} checks, max |h' diff| {worst}, written rows bitwise equal to "
          f"the plain version's {exact_rows}/{2 * checks}")
    pick = next(r for r in rows if r["shape"].endswith("T=328 pos=327"))
    results["attn_block_megakernel"] = dict(pick, max_abs_err=worst)


def kernels_k6(cfg, dev, g, rnd, results):
    """K6, the paged flash decode, against its plain version: 8 slots,
    page_size 16, histories of 17..2000 tokens, layers 0 and 29. Bar: 2e-2
    absolute (probabilities round to bf16 against each 64-token tile's
    running max in the kernel, against one max over all committed pages in
    the plain version)."""
    import torch

    from wrinklefree_tpu_torch.ops import flash_attention as fa

    L, NH, KV, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, ps, MP = 8, 16, 128
    lens = [17, 100, 255, 512, 777, 1024, 1500, 2000]
    P = B * MP + 1
    main = torch.empty((P, 2 * L, ps, KV * D), dtype=torch.bfloat16, device=dev)
    for i in range(0, P, 128):  # filled in slabs (one randn of 1.2 GB would double it)
        main[i:i + 128] = rnd(min(128, P - i), 2 * L, ps, KV * D)
    stage = rnd(B, ps, 2 * L, KV * D)
    q, kc, vc = rnd(B, NH, D), rnd(B, KV, D), rnd(B, KV, D)
    pt = (torch.randperm(B * MP, generator=g, device=dev) + 1).reshape(B, MP).to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    worst = 0.0
    for layer in (0, L - 1):
        a = fa.flash_paged_decode(q, kc, vc, main, stage, layer, pt, sl)
        b = fa.flash_paged_decode_plain(q, kc, vc, main, stage, layer, pt, sl)
        torch.cuda.synchronize()
        d = (a.float() - b.float()).abs().max().item()
        if not (torch.isfinite(a).all() and d <= 2e-2):
            fail(f"K6 layer={layer}: max abs error {d}")
        worst = max(worst, d)
    lay = Cycle(L)
    ms, call_ms = cuda_ms(lambda: fa.flash_paged_decode(q, kc, vc, main, stage, lay(), pt, sl))
    plain_ms, _ = cuda_ms(
        lambda: fa.flash_paged_decode_plain(q, kc, vc, main, stage, lay(), pt, sl),
        iters=5, warmup=1)
    # the yardstick: SDPA over contiguous copies of the same histories (made
    # untimed; four layers' copies, 164 MB, so repeats miss the 50 MB L2)
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
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cyc = Cycle(n_l)

    def lib():
        i = cyc()
        return sdpa(q[:, :, None], ks[i], vs[i], attn_mask=mask, enable_gqa=True)

    lib_ms, _ = cuda_ms(lib)
    tokens = sum(n + 1 for n in lens)
    nbytes = 2 * tokens * KV * D * 2 + 2 * B * NH * D * 2 + B * MP * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4 * NH * D * tokens, "bf16")
    r = dict(shape=f"decode B={B} ps={ps} seq_lens={lens}", ms=ms, call_ms=call_ms,
             plain_ms=plain_ms, library_ms=lib_ms, library="SDPA over contiguous histories",
             bound_ms=b_ms, bound_by=b_by, max_abs_err=worst)
    print("kernels: K6 " + json.dumps(r))
    results["flash_paged_decode"] = r


def kernels_k7(params, cfg, dev, g, results):
    """K7, the packed-ternary matmul of quantized codes, against its plain
    version at the MoE path's shapes: stacked with a per-layer scale at
    q/o 2560->2560 and k 2560->640, stacked with per-column scales at the
    fused qkv 2560->3840, one matrix at the experts' gate 2560->6912 and
    down 6912->2560, and the exact int32 mode. Bar: bit for bit (exact
    integer dot, the same IEEE rescale). Each shape cycles over enough
    distinct weight matrices (>= 64 MB) that the weights stream from HBM;
    the library yardstick is a bf16 matmul on unpacked weights, cycled the
    same way."""
    import torch

    from wrinklefree_tpu_torch.ops import ternary_cuda as tc
    from wrinklefree_tpu_torch.ops.ternary import unpack_ternary

    H, I, Q, KVD = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, cfg.kv_dim

    def stack(k, n, min_bytes=64e6):
        nl = max(8, math.ceil(min_bytes / (k // 4 * n)))
        return torch.randint(0, 256, (nl, k // 4, n), generator=g, device=dev, dtype=torch.uint8)

    def library(qw, k, n):
        nl = min(qw.shape[0], max(2, math.ceil(64e6 / (k * n * 2))))
        return [unpack_ternary(qw[i]).to(torch.bfloat16) for i in range(nl)]

    st = params["layers"]
    cases = [  # name, weights, scales ([L], [L, N] or None: one matrix), rows, mode
        ("q", (H, Q), "layer", (1, 8, 512), "bf16"),
        ("k", (H, KVD), "layer", (1, 8, 512), "bf16"),
        ("o", (Q, H), "layer", (1, 8, 512), "bf16"),
        ("qkv", None, "column", (8,), "bf16"),
        ("expert gate", (H, I), "matrix", (8, 512), "bf16"),
        ("expert down", (I, H), "matrix", (8, 512), "bf16"),
        ("q int32", (H, Q), "matrix", (8, 512), "int32"),
    ]
    rows_out, checks = [], 0
    for name, dims, scale, all_rows, mode in cases:
        if dims is None:  # the engine's fused stack and its column scales
            qw, sw = st["qkv_qw"], st["qkv_scale"]
        else:
            qw = stack(*dims)
            sw = torch.rand((qw.shape[0],), generator=g, device=dev) * 80 + 10
        nl, k4, n = qw.shape
        k = 4 * k4
        lib_w = library(qw, k, n)
        for rows in all_rows:
            xq = torch.randint(-128, 128, (rows, k), generator=g, device=dev, dtype=torch.int8)
            sx = torch.rand((rows, 1), generator=g, device=dev) * 60 + 0.5
            lay, lib_lay = Cycle(nl), Cycle(len(lib_w))
            if scale == "matrix":
                args = (lambda i: (xq, qw[i]) if mode == "int32" else (xq, qw[i], sx, sw[i]))
                ker, pla = tc.ternary_matmul, tc.ternary_matmul_plain
            else:
                args = (lambda i: (xq, qw, i, sx, sw))
                ker, pla = tc.ternary_matmul_stacked, tc.ternary_matmul_stacked_plain
            for i in (0, nl - 1):
                a, b = ker(*args(i)), pla(*args(i))
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    fail(f"K7 {name} rows={rows} weights {i}: kernel and plain version differ by "
                         f"{(a.float() - b.float()).abs().max().item()}")
                checks += 1
            ms, call_ms = cuda_ms(lambda: ker(*args(lay())))
            plain_ms, _ = cuda_ms(lambda: pla(*args(lay())), iters=5, warmup=1)
            xb = torch.randn((rows, k), generator=g, device=dev).to(torch.bfloat16)
            lib_ms, _ = cuda_ms(lambda: torch.matmul(xb, lib_w[lib_lay()]))
            out_bytes = 4 if mode == "int32" else 2
            sw_bytes = 0 if mode == "int32" else (n * 4 if scale == "column" else 4)
            nbytes = rows * k + (0 if mode == "int32" else rows * 4) + k4 * n + sw_bytes \
                + rows * n * out_bytes
            b_ms, b_by = bound(nbytes, 2 * rows * k * n, "int8")
            rows_out.append(dict(shape=f"{name} {k}->{n} ({scale} scale, {mode}) rows={rows}",
                                 ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0))
        del qw, lib_w
    for r in rows_out:
        print("kernels: K7 " + json.dumps(r))
    print(f"kernels: K7 bitwise equal to its plain version in {checks}/{checks} checks")
    # the MoE decode step's most frequent launch: an expert dot at 8 rows
    results["ternary_matmul_stacked"] = next(
        r for r in rows_out if r["shape"].startswith("expert gate") and r["shape"].endswith("=8"))


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


def phase_batch1(qparams, cfg, dev, floors, counters):
    """The batch-1 path of ``wrinklefree_tpu_torch.bench.decode`` on the
    dense cache (T = 64 + 4 * 64 + 8 = 328, as the bench's):

    - at 2 and 30 layers, a 64-token prefill and 8 greedy decode steps
      through the kernels, then teacher-forced through the plain functions;
      logits compared under phase_forward's noise-floor rule;
    - at 30 layers, the prefill and 64 greedy steps through the exact head
      (int8 scan + top-64 rescore), whose token must equal the argmax of the
      bf16 head every step, with the attention and MLP block kernels
      launched once per layer and step (counters zeroed just before);
    - the bench itself (warm window, best of 3 windows of 64 steps) and the
      device's busy share over one window under the profiler.
    Returns the launches of the counted run."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wrinklefree_tpu_torch.bench import decode as bd
    from wrinklefree_tpu_torch.models.bitnet import (
        KVCache, compute_logits, forward, greedy_exact_topk)
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc

    prompt_len, steps = 64, 64
    T = prompt_len + 4 * steps + 8
    plain_lf = tc.make_linear_fused(tc.ternary_matmul_stacked_fused_plain,
                                    tc.mlp_block_megakernel_plain,
                                    tc.attn_block_megakernel_plain)
    g = torch.Generator(device="cpu").manual_seed(3)
    prompt = torch.randint(1, cfg.vocab_size, (1, prompt_len), generator=g).to(dev)

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

    kernels_lf = tc.make_linear_fused()
    for depth in (2, cfg.num_layers):
        c = dataclasses.replace(cfg, num_layers=depth)
        p = dict(qparams, layers={k: v[:depth] for k, v in qparams["layers"].items()})
        ker = logits_run(p, c, kernels_lf)
        pla = logits_run(p, c, plain_lf, forced=[torch.argmax(x, -1) for x in ker[:-1]])
        worst, agree, bar, ties = compare_logits("batch1", ker, pla, depth, floors[depth])
        print(f"batch1: {depth} layers, 64-token prefill + 8 decode steps, kernels vs plain: "
              f"max |logit diff| {worst} (noise floor {floors[depth]}), argmax equal at "
              f"{agree}/9 steps"
              + (f", bar {bar}, ties {json.dumps(ties)}" if depth == 2 else " (no bar)"))

    # the exact head against the bf16 head, every step; launch counts
    clean = {k: v for k, v in qparams.items() if not k.startswith("lm_head_")}
    checks = []

    def checked_head(hidden, p):
        tok, _ = greedy_exact_topk(hidden, p, cfg, k=bd.EXACT_HEAD_K)
        checks.append(tok == torch.argmax(compute_logits(hidden, clean, cfg), -1))
        return tok[:, None]

    tok, cache = bd.prefill(qparams, cfg, kernels_lf, prompt, T)
    pos = torch.full((1,), prompt_len, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    for cnt in counters:
        cnt.launches = 0
    toks, tok, cache, pos = bd.decode_window(qparams, cfg, kernels_lf, tok, cache, pos, steps,
                                             checked_head)
    torch.cuda.synchronize()
    launches = {cnt.__name__: cnt.launches for cnt in counters}
    per_step = {k: v / steps for k, v in launches.items()}
    if not bool(torch.cat(checks).all()):
        bad = [i for i, x in enumerate(checks) if not bool(x.all())]
        fail(f"batch1: the exact head's token differs from the bf16 head's argmax at steps {bad}")
    for name in ("attn_block_megakernel", "mlp_block_megakernel"):
        if launches[name] != cfg.num_layers * steps:
            fail(f"batch1: {name} launched {launches[name]} times in {steps} decode steps")
    if not all(0 <= t < cfg.vocab_size for t in toks.tolist()):
        fail("batch1: token id out of vocabulary")
    print(f"batch1: {cfg.num_layers} layers, 64-token prefill + {steps} greedy steps: exact head == bf16 "
          f"argmax at {len(checks)}/{steps} steps, launches per decode step "
          f"{json.dumps(per_step)}")

    res = bd.run("bitnet2b", prompt_len, steps, dev)
    print("batch1: bench " + json.dumps(res))

    # device busy share over one more window, under the profiler
    head = bd.exact_head(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, tok, cache, pos = bd.decode_window(qparams, cfg, kernels_lf, tok, cache, pos, steps,
                                              head)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.device_time_total for e in evs) / 1e6
    top = sorted(evs, key=lambda e: -e.device_time_total)[:8]
    print(f"batch1: window under the profiler, device busy {dev_s / dt} of {dt} s "
          f"({dev_s / steps * 1e3} ms of device time per token); device ms per token by "
          "kernel: " + json.dumps({e.key[:60]: e.device_time_total / 1e3 / steps for e in top}))
    return launches


def phase_engine(params, cfg, dev, counters, flash_decode=False, tag=None, idle=(),
                 per_step_exact=None, resubmit=True):
    """The engine phase; with ``flash_decode`` the decode attention runs the
    paged flash decode kernel. Every counter in ``counters`` must launch and
    every one in ``idle`` must not (all zeroed just before the six requests,
    read after the resubmissions); ``per_step_exact`` ({name: n}) holds every
    decode-only step of the six requests, and the decode window on average,
    to exactly n launches;
    ``resubmit=False`` skips the two radix resubmissions. Returns (launches,
    the six requests' tokens)."""
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
            dev_s = sum(e.device_time_total for e in evs) / 1e6
            top = sorted(evs, key=lambda e: -e.device_time_total)[:8]
            print(f"{tag}: decode window under the profiler, device busy {dev_s / dt} of "
                  f"{dt} s ({dev_s / steps * 1e3} ms of device time per decode step); "
                  "device ms per decode step by kernel: " + json.dumps(
                      {e.key[:60]: e.device_time_total / 1e3 / steps for e in top}))
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
    3. the engine phase on the MoE model: K7, K3 and K4 launch, K1 and K2 do
       not, and K7 launches exactly (4 + 3 E) L times per decode step.
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
        params, cfg, dev, [tc.ternary_matmul_stacked, kvu.kv_write, fa.flash_paged_prefill],
        tag="moe engine", idle=[tc.ternary_matmul_stacked_fused, tc.mlp_block_megakernel],
        per_step_exact={"ternary_matmul_stacked": per_step}, resubmit=False)
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
    print(f"build: {secs} s ({cuda_lib.build()})")
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
    # the batch-1 path reads the int8 head (its exact head scans it); the
    # engine's params keep the bf16 head only
    batch1 = phase_batch1(quantize_lm_head(params, cfg), cfg, dev, floors,
                          [tc.attn_block_megakernel, tc.mlp_block_megakernel,
                           tc.ternary_matmul_stacked_fused])
    serving = [tc.ternary_matmul_stacked_fused, tc.mlp_block_megakernel, kvu.kv_write,
               fa.flash_paged_prefill]
    launches, toks = phase_engine(params, cfg, dev, serving)
    flash, ftoks = phase_engine(params, cfg, dev, serving + [fa.flash_paged_decode],
                                flash_decode=True)
    same = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
            for x, y in zip(toks, ftoks)]
    print(f"engine: flash_decode=True beside the default run: leading tokens equal per request "
          f"{same} of 32 (prompts 17/64/200/333/512/700)")
    launches["attn_block_megakernel"] = batch1["attn_block_megakernel"]
    launches["flash_paged_decode"] = flash["flash_paged_decode"]
    del params
    torch.cuda.empty_cache()
    moe = phase_moe(dev)
    launches["ternary_matmul_stacked"] = moe["ternary_matmul_stacked"]

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
