"""Flash attention: causal prefill (K9), paged prefill (K4) and paged decode
(K6), CUDA kernels and their plain PyTorch versions.

Counterpart of ``wrinklefree_tpu/ops/flash_attention.py``'s
``flash_prefill``, ``flash_paged_prefill`` and ``flash_paged_decode``. The
plain causal prefill is the TPU kernel's blockwise online softmax, block for
block; the plain paged prefill is the masked-softmax GQA core of the paged
forward (``kv/paged.py::_gqa_core``) on the same inputs; the plain decode
is the TPU kernel's online softmax with all committed pages as one update
and the staging prefix plus the current token as the last. K4 also reads
its history straight from the pool (``flash_paged_prefill_pool``, the paged
forward's prefill attention), whose plain version gathers it first.

Each wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel (``csrc/flash_prefill.cu``,
``csrc/flash_paged_prefill.cu``, ``csrc/flash_decode.cu``) or raises.
``<wrapper>.launches`` counts launches (both K4 wrappers count in
``flash_paged_prefill.launches``). K9's block shape is
``causal_prefill_block``, K4's ``flash_prefill_bq`` (every pool type), K6's
split ``flash_decode_split``: static shapes, so the CPU tests reach them.

K4 and K6 take every unquantized pool, as the reference's kernels do, all
on the tensor cores (``POOL_ELEM`` names the kernel's instantiation). K4's
inputs are all of the pool's type (the paged forward casts the chunk to
it, as the reference does); K6's query and current-token rows stay bf16,
the model's type, and on an fp16 pool its bf16 x fp16 scores go through
the tensor cores in TF32, which holds both types exactly
(``exact_in_tf32``). On f32 pools both kernels split each f32 operand into
TF32 pieces (``tf32_split``): K4's products and K6's probabilities times
values as 3xTF32 (hi*hi + hi*lo + lo*hi), K6's bf16 query times the three
pieces of each key, every product exact.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib


NEG_INF = -1e30


def _prefill_tiles(S: int, T: int, block_q: int, block_k: int):
    ts, tc = min(block_q, S), min(block_k, T)
    if S % ts or T % tc:
        raise ValueError(f"S ({S}) and T ({T}) must tile by ({ts},{tc}); pad upstream")
    return ts, tc


def flash_prefill_plain(q, k, v, q_offset=0, *, block_q: int = 256, block_k: int = 512):
    """Plain version of K9, the TPU kernel's arithmetic block for block: q
    scaled by 1/sqrt(D) in its own dtype; per key block of ``block_k``, f32
    scores masked to ``t <= q_offset + s`` with -1e30, the running max and
    sum in f32, ``p`` cast to v's dtype before PV; ``acc / max(l, 1e-30)``
    cast to q's dtype. Blocks after the last visible key are skipped, as
    the kernel's are (a wholly masked block leaves the state unchanged)."""
    B, S, NH, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = NH // KV
    _, tc = _prefill_tiles(S, T, block_q, block_k)
    dev = q.device
    off = int(q_offset)
    qs = (q * torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype, device=dev)).float()
    qs = qs.reshape(B, S, KV, G, D)
    rows = off + torch.arange(S, device=dev)
    m = torch.full((B, KV, G, S, 1), NEG_INF, device=dev)
    l = torch.zeros((B, KV, G, S, 1), device=dev)
    acc = torch.zeros((B, KV, G, S, D), device=dev)
    for c in range(min(-(-(off + S) // tc), T // tc)):
        kb, vb = k[:, c * tc:(c + 1) * tc], v[:, c * tc:(c + 1) * tc]
        s = torch.einsum("bskgd,btkd->bkgst", qs, kb.float())
        ok = (c * tc + torch.arange(tc, device=dev))[None, :] <= rows[:, None]
        s = torch.where(ok, s, torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(), vb.float())
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, NH, D)


def causal_prefill_block(g: int, d: int, f32: bool) -> tuple:
    """(query heads, query tokens, warps) of one block of the causal flash
    prefill (``csrc/flash_prefill.cu``) for ``g`` query heads per KV head and
    head dim ``d`` (64 or 128), a static shape. A KV head's query heads go
    into ``ceil(g / ceil(g / cap))`` heads a block, so that every block of
    the KV head stages each K/V tile once for all its rows: ``cap`` 8 in
    bf16, 4 in f32.

    - bf16: rows in groups of 16 tokens of one head. Up to 4 heads, the
      tokens are 64 / heads (16 at 3 or 4), four groups or three, and two
      warps a group, each scoring half of every 64-key tile (8 or 6 warps):
      a warp's chain of dependent instructions per tile bounds the kernel,
      and the causal grid's longest q tiles wait on it. From 5 heads, 16
      tokens and one warp a group (5-8 warps).
    - f32: one warp per 8 tokens of one head, at most 32 query rows a block
      (the tokens the most of 8, 16 and 32 that keep heads x tokens <= 32),
      so that Q, P^T and the K/V ring fit twice in an SM's shared memory at
      D 128."""
    if d not in (64, 128) or g < 1:
        raise ValueError(f"the causal flash prefill takes D 64 or 128 and G >= 1, got {d}, {g}")
    cap = 4 if f32 else 8
    gb = -(-g // -(-g // cap))
    if f32:
        bq = 8
        while gb * bq * 2 <= 32:
            bq *= 2
        return gb, bq, gb * bq // 8
    if gb > 4:
        return gb, 16, gb
    bq = 16 * max(1, 4 // gb)
    return gb, bq, 2 * gb * bq // 16


def flash_prefill_checks(q, k, v, q_offset, *, block_q: int = 256, block_k: int = 512):
    """The inputs the causal flash prefill kernel takes, checked without
    touching the data: q, k, v all bf16 or all f32 on one device, [B, S, NH,
    D] and [B, T, KV, D] with D 64 or 128 and KV dividing NH, S and T tiled
    by the blocks as the reference requires, and q_offset an int >= 0 or a
    one-element integer tensor (read on the device, never here). Raises
    ``ValueError``; returns ``causal_prefill_block``'s (heads, tokens, warps)
    and the offset (an int, or the tensor)."""
    B, S, NH, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    _prefill_tiles(S, T, block_q, block_k)
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the CUDA kernel takes q, k and v all bfloat16 or all float32")
    if D not in (64, 128) or NH % KV or k.shape != v.shape or tuple(k.shape) != (B, T, KV, D):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_prefill: every input must be on q's device")
    if isinstance(q_offset, torch.Tensor):
        if q_offset.numel() != 1 or q_offset.dtype.is_floating_point:
            raise ValueError("q_offset must be an int or a one-element integer tensor")
        qoff = q_offset
    else:
        qoff = int(q_offset)
        if qoff < 0:
            raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    return (*causal_prefill_block(NH // KV, D, q.dtype == torch.float32), qoff)


def flash_prefill(
    q: torch.Tensor,  # [B, S, NH, D] bf16 or f32
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    q_offset=0,  # int, or a one-element integer tensor: query row s sees key t iff t <= q_offset + s
    *,
    block_q: int = 256,
    block_k: int = 512,
) -> torch.Tensor:
    """Causal GQA flash attention over contiguous keys with an offset for
    chunked prefill, without materializing the [S, T] scores. ``S`` and
    ``T`` must tile by ``block_q``/``block_k`` (capped at S and T), as the
    reference requires, so that both packages accept the same calls; the
    kernel walks its own 64-key tiles, in blocks of ``causal_prefill_block``.
    A tensor ``q_offset`` is read by the kernel on the device."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, q_offset, block_q=block_q, block_k=block_k)
    cuda_lib.require_cuda(q, "flash_prefill")
    gb, bq, warps, qoff = flash_prefill_checks(q, k, v, q_offset, block_q=block_q,
                                               block_k=block_k)
    B, S, NH, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (qc, kc, vc)):
        raise ValueError("the CUDA kernel reads 16-byte aligned rows")
    if isinstance(qoff, torch.Tensor):
        qoff = qoff.to(device=q.device, dtype=torch.int32).reshape(1)
        qoff_ptr, qoff_int = qoff.data_ptr(), 0
    else:
        qoff_ptr, qoff_int = None, qoff
    out = torch.empty_like(qc)
    cuda_lib.call(
        "wf_flash_prefill", qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), qoff_ptr, qoff_int,
        out.data_ptr(), B, S, NH, KV, D, T, int(q.dtype == torch.float32), 1.0 / math.sqrt(D),
        gb, bq, warps, cuda_lib.stream(q),
    )
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def _lengths(x, b: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1).expand(b)


def flash_paged_prefill_plain(q, k_full, v_full, kv_valid, new_len, *, hist_len: int):
    """Plain version: ``_gqa_core`` over [history(hist_len) ++ chunk]."""
    from ..kv.paged import _gqa_core

    B, S = q.shape[:2]
    kv_valid = _lengths(kv_valid, B, q.device)
    new_len = _lengths(new_len, B, q.device)
    hist_ok = torch.arange(hist_len, device=q.device)[None, :] < kv_valid[:, None]
    return _gqa_core(
        q, k_full[:, hist_len:hist_len + S], v_full[:, hist_len:hist_len + S],
        k_full[:, :hist_len], v_full[:, :hist_len], hist_ok, new_len,
    )


PREFILL_BQ = (16, 32, 64, 128)  # query tokens per block of csrc/flash_paged_prefill.cu


def flash_prefill_bq(g: int) -> int:
    """Query tokens per block of the paged flash prefill for ``g`` query
    heads per KV head (1-8), a static shape: the smallest of 16, 32, 64 and
    128 that gives the block at least 4 warps (``g * bq / 16``, one per 16
    tokens of one query head; at most 8), so the grid has the most blocks.
    The kernel is bound by each warp's chain of dependent instructions, and
    timings on the H100 at the 2B engine's shapes found the smallest block
    as fast as or faster than the next (PERF.md section 6)."""
    fits = [bq for bq in PREFILL_BQ if 4 <= g * bq // 16 <= 8]
    if not 1 <= g <= 8 or not fits:
        raise ValueError(f"the paged flash prefill takes 1-8 query heads per KV head, got {g}")
    return min(fits)


# the pool types K4 and K6 take, as their entry points' codes (csrc/sm90.cuh)
POOL_ELEM = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

# K4's and K6's bars (atol, rtol) against their plain versions on each pool
# type, as ``meets_pool_bar`` applies them. bf16 and fp16 round their
# probabilities to the pool's type against each block's running max in the
# kernel and after normalization in the plain softmax (3e-2; K6 bf16 2e-2);
# in f32 nothing rounds before the output and only the f32 sums' order
# differs (2e-5, K9's f32 bar). K6 returns the bf16 query's type, so on an
# f32 pool both round an f32 result to bf16, and a difference of 1e-7 can
# land one bf16 step apart: the bar adds that step (at most 2^-7 of the
# value), and ``K6_F32_EQUAL_SHARE`` of the output must then be bitwise equal,
# the rest one step apart or within 2e-5 (near zero bf16's steps are finer
# than the sums' differences). A read of the pool at bf16 precision (each
# value moved by up to 2^-9 of it) leaves about half the output equal.
# On fp16 the absolute bar alone would pass a kernel that reads the keys
# at bf16 precision (the output moves by about 1e-3 of its size), so
# ``FP16_EQUAL_SHARE`` of the output must also be bitwise equal to the
# twin's: the rounding points above leave 0.42-0.49 of K4's fp16 output
# and 0.88-0.97 of K6's bf16 output equal on random inputs, the keys read
# at bf16 0.10-0.20 and 0.47-0.69 (PERF.md section 6).
POOL_BARS = {"bf16": {"k4": (3e-2, 0.0), "k6": (2e-2, 0.0)},
             "fp16": {"k4": (3e-2, 0.0), "k6": (3e-2, 0.0)},
             "f32": {"k4": (2e-5, 0.0), "k6": (2e-5, 2.0 ** -7)}}
K6_F32_EQUAL_SHARE = 0.99
FP16_EQUAL_SHARE = {"k4": 0.3, "k6": 0.8}


def meets_pool_bar(a: torch.Tensor, b: torch.Tensor, kernel: str, pool: str) -> tuple:
    """(whether kernel output ``a`` meets ``POOL_BARS[pool][kernel]`` against
    its plain version's ``b``, with the bitwise equal share that K6 on f32
    and both kernels on fp16 must reach, max |a - b| in f32, share of
    bitwise equal elements). NaN fails."""
    atol, rtol = POOL_BARS[pool][kernel]
    d = (a.float() - b.float()).abs()
    ok = bool((d <= atol + rtol * b.float().abs()).all())
    same = a == b
    share = float(same.float().mean()) if a.numel() else 1.0
    if kernel == "k6" and pool == "f32":
        steps = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
        ok = (ok and share >= K6_F32_EQUAL_SHARE
              and bool((same | (steps == 1) | (d <= atol)).all()))
    if pool == "fp16":
        ok = ok and share >= FP16_EQUAL_SHARE[kernel]
    return ok, float(d.max()) if a.numel() else 0.0, share


def _pool_elem(what, tensors):
    """The entry point's code of the one unquantized type of ``tensors``."""
    dt = tensors[0].dtype
    if dt not in POOL_ELEM or any(t.dtype != dt for t in tensors):
        raise ValueError(f"{what}: the CUDA kernel takes bfloat16, float16 or float32, all "
                         f"of one type; got {sorted({str(t.dtype) for t in tensors})}")
    return POOL_ELEM[dt]


def _prefill_checks(what, q, tensors):
    """The entry point's pool code of K4's inputs."""
    cuda_lib.require_cuda(q, what)
    elem = _pool_elem(what, (q, *tensors))
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: every input must be on q's device")
    return elem


def _prefill_bq(elem: int, g: int) -> int:
    """K4's query tokens per block for the pool code ``elem``: every pool
    type's kernel takes ``flash_prefill_bq``'s blocks of 16-token warps (f32
    on 32-key tiles, bf16 and fp16 on 64-key ones)."""
    return flash_prefill_bq(g)


def exact_in_tf32(x: torch.Tensor) -> torch.Tensor:
    """Whether each element of ``x`` (bf16, fp16 or f32) is exact in TF32:
    its f32 form has the low 13 of its 23 mantissa bits zero, the bits the
    tensor cores' TF32 products ignore. Every bf16 value (8 significant bits)
    and every fp16 value (11, subnormals included: f32's exponent range
    holds them as normals) is; so K6 on an fp16 pool takes the bf16 query's
    product with each fp16 key on TF32 ``mma``, exact in f32
    (``csrc/sm90.cuh::mma_tf32``)."""
    return (x.float().view(torch.int32) & 0x1FFF) == 0


TF32_MASK = -0x2000  # int32 0xFFFFE000: sign, exponent and TF32's 10 mantissa bits


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` with its low 13 mantissa bits cleared: the TF32 value a
    tensor core takes from it (``csrc/sm90.cuh::tf32_trunc``)."""
    return (x.float().view(torch.int32) & TF32_MASK).view(torch.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to the nearest TF32 value, ties away from zero,
    subnormals kept (``csrc/sm90.cuh::tf32_round``)."""
    return ((x.float().view(torch.int32) + 0x1000) & TF32_MASK).view(torch.float32)


def tf32_split(x: torch.Tensor, pieces: int) -> tuple:
    """The TF32 pieces the f32 pools' kernels hand the tensor cores for each
    element of f32 ``x``, bit for bit as ``csrc/sm90.cuh::split2`` and
    ``split3`` make them. hi = ``tf32_trunc(x)`` (no rounding up, so the
    largest finite values stay finite); two pieces: lo = ``tf32_round(x -
    hi)``, within 2^-22 of |x| of x where lo is normal; three pieces: mid =
    ``tf32_trunc(x - hi)``, lo = x - hi - mid (at most two significant
    bits), summing to x exactly wherever x is a multiple of 2^-136, TF32's
    least subnormal (every |x| >= 2^-113)."""
    x = x.float()
    hi = tf32_trunc(x)
    r = x - hi
    if pieces == 2:
        return hi, tf32_round(r)
    if pieces == 3:
        mid = tf32_trunc(r)
        return hi, mid, r - mid
    raise ValueError(f"tf32_split makes 2 or 3 pieces, not {pieces}")


def flash_paged_prefill(
    q: torch.Tensor,  # [B, S, NH, D] current chunk queries
    k_full: torch.Tensor,  # [B, Tt, KV, D] history(hist_len) ++ current(S)
    v_full: torch.Tensor,
    kv_valid,  # [B] int (or scalar): valid history length per row
    new_len,  # [B] int (or scalar): real tokens in each row's chunk
    *,
    hist_len: int,
) -> torch.Tensor:
    """Online-softmax attention for chunked-prefill rows over a gathered
    paged history, without materializing the [B, S, T] scores. One block per
    ``flash_prefill_bq`` query tokens, KV head and batch row serves all of
    the KV head's query heads. q, k_full and v_full share one type: bf16,
    fp16 or f32."""
    if q.device.type == "cpu":
        return flash_paged_prefill_plain(q, k_full, v_full, kv_valid, new_len,
                                         hist_len=hist_len)
    elem = _prefill_checks("flash_paged_prefill", q, (k_full, v_full))
    B, S, NH, D = q.shape
    Tt, KV = k_full.shape[1], k_full.shape[2]
    if (D != 128 or NH % KV or NH // KV > 8 or k_full.shape != v_full.shape
            or tuple(k_full.shape) != (B, Tt, KV, D)):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k {tuple(k_full.shape)}")
    if not (0 <= hist_len and hist_len + S <= Tt):
        raise ValueError(f"hist_len {hist_len} + S {S} exceeds key length {Tt}")
    qc, kc, vc = q.contiguous(), k_full.contiguous(), v_full.contiguous()
    if any(t.data_ptr() % 16 for t in (qc, kc, vc)):
        raise ValueError("the CUDA kernel reads 16-byte aligned rows")
    kvv = _lengths(kv_valid, B, q.device).contiguous()
    nl = _lengths(new_len, B, q.device).contiguous()
    out = torch.empty_like(qc)
    bq = _prefill_bq(elem, NH // KV)
    cuda_lib.call(
        "wf_flash_paged_prefill", qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        kvv.data_ptr(), nl.data_ptr(), out.data_ptr(), B, S, NH, KV, D, Tt, hist_len,
        1.0 / math.sqrt(D), bq, elem, cuda_lib.stream(q),
    )
    flash_paged_prefill.launches += 1
    return out


flash_paged_prefill.launches = 0


def flash_paged_prefill_pool_plain(q, k_cur, v_cur, main, layer, page_table, seq_lens,
                                   new_lens):
    """Plain version of the pool path: layer ``layer``'s history of every
    table page gathered (``kv/paged.py::_history``), the chunk appended, and
    ``flash_paged_prefill_plain`` over them with ``seq_lens`` valid history
    tokens per row."""
    from ..kv.paged import _history

    KV, D = k_cur.shape[2], k_cur.shape[3]
    T = page_table.shape[1] * main.shape[2]
    k_hist, v_hist = _history(main, page_table.long(), layer, KV, D)
    k_full = torch.cat([k_hist, k_cur.to(k_hist.dtype)], dim=1)
    v_full = torch.cat([v_hist, v_cur.to(v_hist.dtype)], dim=1)
    return flash_paged_prefill_plain(q, k_full, v_full, seq_lens, new_lens, hist_len=T)


def flash_paged_prefill_pool(
    q: torch.Tensor,  # [B, S, NH, D] current chunk queries
    k_cur: torch.Tensor,  # [B, S, KV, D] the chunk's keys
    v_cur: torch.Tensor,  # [B, S, KV, D]
    main: torch.Tensor,  # [P, 2L, ps, KV*D] layer-major main pool
    layer: int,
    page_table: torch.Tensor,  # [B, MP] int32
    seq_lens: torch.Tensor,  # [B] int32 valid history tokens (page-aligned chunk start)
    new_lens: torch.Tensor,  # [B] int32 real tokens in each row's chunk
) -> torch.Tensor:
    """``flash_paged_prefill`` over [history ++ chunk] with the history read
    from the pool inside the kernel: history token t of row b is layer
    ``layer``'s row of page ``page_table[b, t // ps]``, valid for t <
    ``seq_lens[b]``; no gathered copy of the history is made. q, k_cur,
    v_cur and the pool share one type: bf16, fp16 or f32. Counts in
    ``flash_paged_prefill.launches``. Returns [B, S, NH, D]."""
    if q.device.type == "cpu":
        return flash_paged_prefill_pool_plain(q, k_cur, v_cur, main, layer, page_table,
                                              seq_lens, new_lens)
    elem = _prefill_checks("flash_paged_prefill_pool", q, (k_cur, v_cur, main))
    B, S, NH, D = q.shape
    KV = k_cur.shape[2]
    P, two_l, ps, kvd = main.shape
    n_l = two_l // 2
    MP = page_table.shape[1]
    if (D != 128 or NH % KV or NH // KV > 8 or kvd != KV * D or ps > 64
            or tuple(k_cur.shape) != (B, S, KV, D) or k_cur.shape != v_cur.shape
            or page_table.shape[0] != B):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k_cur {tuple(k_cur.shape)} "
                         f"main {tuple(main.shape)}")
    if not 0 <= layer < n_l:
        raise IndexError(f"layer {layer} out of range for {n_l} layers")
    if not main.is_contiguous():
        raise ValueError("the main pool must be contiguous")
    if any(t.device != q.device for t in (page_table, seq_lens, new_lens)):
        raise ValueError("flash_paged_prefill_pool: every input must be on q's device")
    qc, kc, vc = q.contiguous(), k_cur.contiguous(), v_cur.contiguous()
    if any(t.data_ptr() % 16 for t in (qc, kc, vc, main)):
        raise ValueError("the CUDA kernel reads 16-byte aligned rows")
    pt = page_table.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    nl = new_lens.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    bq = _prefill_bq(elem, NH // KV)
    cuda_lib.call(
        "wf_flash_paged_prefill_pool", qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        main.data_ptr(), pt.data_ptr(), sl.data_ptr(), nl.data_ptr(), out.data_ptr(), B, S,
        NH, KV, D, n_l, layer, ps, MP, P, 1.0 / math.sqrt(D), bq, elem, cuda_lib.stream(q),
    )
    flash_paged_prefill.launches += 1
    return out


def flash_paged_decode_plain(q, k_cur, v_cur, main, staging_b, layer, page_table, seq_lens):
    """Plain version of K6: q scaled by 1/sqrt(D) in q's dtype; the
    ``(seq_lens // ps) * ps`` committed tokens of the main pool's pages as
    one online-softmax update, then the staging prefix and the current token
    as the last; f32 state, masked probabilities forced to 0, probabilities
    rounded to the pool's dtype before PV, ``acc / max(l, 1e-30)``."""
    from ..kv.paged import _history

    B, NH, D = q.shape
    KV = k_cur.shape[1]
    G = NH // KV
    n_l, ps = main.shape[1] // 2, main.shape[2]
    MP = page_table.shape[1]
    dev = q.device
    seq_lens = seq_lens.to(device=dev, dtype=torch.int64)
    qs = (q * torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype, device=dev)).float()
    qs = qs.reshape(B, KV, G, D)
    full = (seq_lens // ps) * ps
    off = seq_lens - full
    k_main, v_main = _history(main, page_table.long(), layer, KV, D)
    k_tail = torch.cat([staging_b[:, :, layer].reshape(B, ps, KV, D),
                        k_cur[:, None].to(main.dtype)], dim=1)
    v_tail = torch.cat([staging_b[:, :, n_l + layer].reshape(B, ps, KV, D),
                        v_cur[:, None].to(main.dtype)], dim=1)
    t_main = torch.arange(MP * ps, device=dev)[None, :]
    t_tail = torch.arange(ps + 1, device=dev)[None, :]
    segments = ((k_main, v_main, t_main < full[:, None]),
                (k_tail, v_tail, (t_tail < off[:, None]) | (t_tail == ps)))
    m = torch.full((B, KV, G, 1), NEG_INF, device=dev)
    l = torch.zeros((B, KV, G, 1), device=dev)
    acc = torch.zeros((B, KV, G, D), device=dev)
    for k_all, v_all, ok in segments:
        ok = ok[:, None, None, :]
        s = torch.einsum("bkgd,btkd->bkgt", qs, k_all.float())
        s = torch.where(ok, s, torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), torch.zeros((), device=dev))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bkgt,btkd->bkgd", p.to(v_all.dtype).float(), v_all.float())
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype).reshape(B, NH, D)


DECODE_TILE = 64  # tokens per tile of csrc/flash_decode.cu
DECODE_MAX_SPLIT = 8  # blocks per cluster (the portable limit)
# One K6 block's dynamic shared memory on each pool type
# (csrc/flash_decode.cu::SMEM): the warps' rings (two stages of a warp's 16
# rows of K and V on bf16 and fp16; one stage of K and one of V on f32,
# rows twice as wide: 64 KB either way), rank 0's slots for the ranks'
# states (8 x (16 + 8 x 132) floats) and the swizzle's 1 KB alignment.
DECODE_SMEM_BYTES = {pool: 65536 + 8 * (16 + 8 * 132) * 4 + 1024
                     for pool in ("bf16", "fp16", "f32")}
SM_SMEM_BYTES = 233472  # an H100 SM's shared memory, of which each block reserves 1 KB
# Blocks of K6 an SM holds at once: two on every pool type (each kernel's 99
# KB fits twice, the f32 kernel's too since it keeps one stage of K and V);
# flash_decode_split sizes the grid by it, and the card tests read it back
# from the CUDA runtime (``decode_occupancy``).
DECODE_BLOCKS_PER_SM = 2


def flash_decode_split(b: int, kv: int, hist_tokens: int, sms: int) -> int:
    """Blocks that share each slot's history in the paged flash decode, from
    static shapes only (the batch ``b``, the KV heads ``kv``, the page
    table's ``MP * ps`` tokens and the card's ``sms``; never the lengths,
    which stay on the device): the largest power of two whose grid of
    ``b * kv * split`` blocks the card holds at once (``DECODE_BLOCKS_PER_SM``
    per SM, on every pool type), at most 8
    (the cluster's portable size), and that leaves every block at least two
    of the 64-token tiles of the longest history the page table can hold (a
    cluster's barriers and combine cost more than a block's second tile); at
    least 1."""
    tiles = -(-hist_tokens // DECODE_TILE)
    split = 1
    while (split < DECODE_MAX_SPLIT and 4 * split <= tiles
           and b * kv * 2 * split <= DECODE_BLOCKS_PER_SM * sms):
        split *= 2
    return split


def flash_paged_decode(
    q: torch.Tensor,  # [B, NH, D] roped decode queries
    k_cur: torch.Tensor,  # [B, KV, D] roped current-token keys
    v_cur: torch.Tensor,  # [B, KV, D]
    main: torch.Tensor,  # [P, 2L, ps, KV*D] layer-major main pool
    staging_b: torch.Tensor,  # [B, ps, 2L, KV*D] this batch's staging pages
    layer: int,
    page_table: torch.Tensor,  # [B, MP] int32
    seq_lens: torch.Tensor,  # [B] int32 history before this token
) -> torch.Tensor:
    """Decode-step paged GQA attention with the page-table gather inside the
    kernel: each history row moves from the pool once, with no gathered copy
    of the history; each slot's history is split over
    ``flash_decode_split(B, KV, MP * ps, SMs)`` blocks. q, k_cur and v_cur
    are bf16 (the model's type); the pool and staging pages bf16, fp16 or f32.
    Returns [B, NH, D] bf16."""
    if q.device.type == "cpu":
        return flash_paged_decode_plain(q, k_cur, v_cur, main, staging_b, layer, page_table,
                                        seq_lens)
    cuda_lib.require_cuda(q, "flash_paged_decode")
    B, NH, D = q.shape
    KV = k_cur.shape[1]
    P, two_l, ps, kvd = main.shape
    n_l = two_l // 2
    MP = page_table.shape[1]
    if any(t.dtype != torch.bfloat16 for t in (q, k_cur, v_cur)):
        raise ValueError("flash_paged_decode: the CUDA kernel takes a bfloat16 query and "
                         "current token")
    elem = _pool_elem("flash_paged_decode", (main, staging_b))
    if (D != 128 or NH % KV or NH // KV > 8 or kvd != KV * D or ps > 64
            or tuple(k_cur.shape) != (B, KV, D) or k_cur.shape != v_cur.shape
            or tuple(staging_b.shape) != (B, ps, two_l, kvd) or page_table.shape[0] != B):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k_cur {tuple(k_cur.shape)} "
                         f"main {tuple(main.shape)} staging {tuple(staging_b.shape)}")
    if not 0 <= layer < n_l:
        raise IndexError(f"layer {layer} out of range for {n_l} layers")
    if not main.is_contiguous():
        raise ValueError("the main pool must be contiguous")
    if any(t.device != q.device for t in (k_cur, v_cur, main, staging_b, page_table, seq_lens)):
        raise ValueError("flash_paged_decode: every input must be on q's device")
    qc, kc, vc, sc = (t.contiguous() for t in (q, k_cur, v_cur, staging_b))
    if any(t.data_ptr() % 16 for t in (qc, kc, vc, main, sc)):
        raise ValueError("the CUDA kernel reads 16-byte aligned rows")
    pt = page_table.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    split = flash_decode_split(B, KV, MP * ps, cuda_lib.sm_count(q.device))
    cuda_lib.call(
        "wf_flash_paged_decode", qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), main.data_ptr(),
        sc.data_ptr(), pt.data_ptr(), sl.data_ptr(), out.data_ptr(), B, NH, KV, n_l, layer,
        ps, MP, D, P, 1.0 / math.sqrt(D), split, elem, cuda_lib.stream(q),
    )
    flash_paged_decode.launches += 1
    return out


flash_paged_decode.launches = 0


def decode_occupancy(dtype: torch.dtype, device: torch.device) -> tuple:
    """(dynamic shared memory bytes of one K6 block, blocks of it an SM of
    ``device`` holds at once) for a pool of ``dtype``, from the CUDA
    runtime's occupancy query: what ``DECODE_SMEM_BYTES`` and
    ``DECODE_BLOCKS_PER_SM`` state."""
    import ctypes

    cuda_lib.require_cuda(torch.empty(0, device=device), "decode_occupancy")
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        cuda_lib.call("wf_flash_paged_decode_occupancy", POOL_ELEM[dtype], ctypes.addressof(out))
    return out[0], out[1]
