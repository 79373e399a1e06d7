#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wrinklefree_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
CUDA kernels from ``wrinklefree_tpu_torch/csrc`` and runs four phases at
BitNet b1.58-2B width (30 layers, H 2560, I 6912, 20 query / 5 KV heads,
vocab 128256) with random weights drawn on the card from seed 0:

1. build    — compile the kernels (one nvcc per source, in parallel);
2. kernels  — every kernel against its plain PyTorch version on the same
              inputs at the serving path's shapes, timed with CUDA events
              beside its bound (bytes over 3.35 TB/s or operations over the
              published dense peak) and a PyTorch library call;
3. forward  — ``paged_forward``: a 128-token prefill chunk and 4 decode
              steps, once through the kernels and once through the plain
              functions, logits compared;
4. engine   — ``Engine``: six greedy requests (prompts of 17..700 tokens,
              32 new tokens each) and two radix-cache resubmissions; every
              kernel's launch counter must grow in this phase.

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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    if dev_us <= 0:
        fail("torch.profiler recorded no device time")
    return dev_us / 1e3 / iters, call_ms


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
    it reports them without a bar."""
    import dataclasses

    import torch

    from wrinklefree_tpu_torch.kv.paged import PagedKV, _paged_attention_dual, paged_forward
    from wrinklefree_tpu_torch.ops import kv_update_cuda as kvu
    from wrinklefree_tpu_torch.ops import ternary_cuda as tc

    plain = dict(
        linear_fn=tc.make_linear_fused(tc.ternary_matmul_stacked_fused_plain,
                                       tc.mlp_block_megakernel_plain),
        attention_fn=_paged_attention_dual, kv_write=kvu.kv_write_plain)
    g = torch.Generator(device="cpu").manual_seed(2)
    prompt = torch.randint(1, cfg.vocab_size, (1, 128), generator=g).to(dev)
    pt = torch.arange(1, 17, dtype=torch.int32, device=dev)[None]
    slot = torch.zeros(1, dtype=torch.int32, device=dev)

    def run(p, c, kw, forced=None, steps=5):
        """A 128-token prefill chunk, then decode steps fed with `forced`
        (or the run's own argmax)."""
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

    for depth in (2, cfg.num_layers):
        c = dataclasses.replace(cfg, num_layers=depth)
        p = dict(params, layers={k: v[:depth] for k, v in params["layers"].items()})
        ker = run(p, c, {})
        pla = run(p, c, plain, forced=[torch.argmax(x, -1) for x in ker])
        alt = run(p, c, dict(plain, attention_fn=_prefill_attention_p_rounded), steps=1)
        floor = (alt[0] - pla[0]).abs().max().item()
        bar = max(6e-2, 3 * floor)
        worst, ties, agree = 0.0, [], 0
        for step, (a, b) in enumerate(zip(ker, pla)):
            if not torch.isfinite(a).all():
                fail(f"forward depth {depth} step {step}: non-finite logits")
            err = (a - b).abs().max().item()
            worst = max(worst, err)
            ia, ib = int(a.argmax()), int(b.argmax())
            agree += ia == ib
            if depth != 2:
                continue
            if err > bar:
                fail(f"forward step {step}: logits differ by {err} (bar {bar})")
            if ia != ib:
                top2 = torch.topk(b[0], 2).values
                gap = (top2[0] - top2[1]).item()
                if gap > 2 * err:
                    fail(f"forward step {step}: argmax {ia} vs {ib} with top-2 gap {gap}")
                ties.append(dict(step=step, kernels=ia, plain=ib, top2_gap=gap))
        print(f"forward: {depth} layers at full width, 128-token prefill + 4 decode steps, "
              f"kernels vs plain: max |logit diff| {worst}, noise floor {floor}, "
              f"argmax equal at {agree}/5 steps"
              + (f", bar {bar}, ties {json.dumps(ties)}" if depth == 2 else " (no bar)"))


def phase_engine(params, cfg, dev, counters):
    import numpy as np
    import torch

    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams

    ecfg = EngineConfig(max_batch_slots=8, page_size=16, num_pages=1024, max_context=2048,
                        prefill_buckets=(32, 128, 512))
    eng = Engine(params, cfg, ecfg, device=dev)
    rng = np.random.default_rng(0)
    lens = (17, 64, 200, 333, 512, 700)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    sp = SamplingParams(max_new_tokens=32, temperature=0.0)

    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, sp) for p in prompts]
    per_step = None
    while any(not r.finished for r in reqs):
        before = (eng.stats.get("prefill_rounds", 0), eng.stats["decode_steps"],
                  [c.launches for c in counters])
        eng.step()
        steps = eng.stats["decode_steps"] - before[1]
        if eng.stats.get("prefill_rounds", 0) == before[0] and steps and per_step is None:
            per_step = {c.__name__: (c.launches - n0) / steps  # a decode-only step
                        for c, n0 in zip(counters, before[2])}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hit0 = eng.stats["radix_hit_tokens"]
    again = [eng.generate(prompts[-1], sp) for _ in range(2)]
    launches = {c.__name__: c.launches for c in counters}

    for p, r in zip(prompts + [prompts[-1]] * 2, reqs + again):
        if r.finish_reason != "length" or len(r.output_ids) != 32:
            fail(f"request of {len(p)} tokens finished {r.finish_reason!r} "
                 f"with {len(r.output_ids)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output_ids):
            fail("token id out of vocabulary")
    if eng.stats["radix_hit_tokens"] < hit0 + 2 * 688:
        fail("the resubmitted prompts did not reuse the 43 cached pages of the prompt")
    # Two resubmissions run the same computation (688 cached tokens, a
    # 12-token suffix): identical tokens. Against the first submission, which
    # prefilled the same 700 tokens as chunks of 512 and 188 through the
    # flash kernel, the suffix goes through the plain attention path; on
    # random weights that moves the logits by about the forward phase's noise
    # floor, so the agreement is reported, not required.
    if again[0].output_ids != again[1].output_ids:
        fail("two radix resubmissions of one prompt gave different tokens")
    agree = next((i for i, (a, b) in enumerate(zip(again[0].output_ids, reqs[-1].output_ids))
                  if a != b), 32)
    if not (torch.isfinite(eng.pools.kv).all() and torch.isfinite(eng.pools.staging).all()):
        fail("non-finite values in the KV pools")
    zero = [n for n, v in launches.items() if v == 0]
    if zero:
        fail(f"kernels not launched on the engine path: {zero}")
    ttft = sorted(r.first_token_t - r.arrival_t for r in reqs)
    p50 = float(np.percentile(ttft, 50))
    print(f"engine: 6 requests + 2 radix resubmissions, wall {wall} s, TTFT p50 {p50} s, "
          f"radix hit tokens {eng.stats['radix_hit_tokens'] - hit0}, resubmission agrees "
          f"with the first submission on its first {agree}/32 tokens, "
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
            print(f"engine: decode window under the profiler, device busy {dev_s / dt} of "
                  f"{dt} s ({dev_s / steps * 1e3} ms of device time per decode step); "
                  "device ms per decode step by kernel: " + json.dumps(
                      {e.key[:60]: e.device_time_total / 1e3 / steps for e in top}))
        else:
            print(f"engine: decode window, 8 slots: "
                  f"{(eng.stats['decode_tokens'] - tok0) / dt} tok/s, {dt / steps * 1e3} ms "
                  f"per decode step ({steps} steps)")
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
        from wrinklefree_tpu_torch.models.bitnet import fuse_projections, init_params
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
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BitNetConfig.bitnet_2b()
    params = fuse_projections(init_params(cfg, seed=0, device=dev), cfg)
    torch.cuda.synchronize()

    results = {}
    phase_kernels(params, cfg, dev, results)
    phase_forward(params, cfg, dev)
    counters = [tc.ternary_matmul_stacked_fused, tc.mlp_block_megakernel, kvu.kv_write,
                fa.flash_paged_prefill]
    launches = phase_engine(params, cfg, dev, counters)

    line = []
    for name, meta in KERNELS.items():
        r = results[name]
        line.append({
            "name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
        })
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
