"""Flash attention: causal prefill (K9), paged prefill (K4) and paged decode
(K6), CUDA kernels and their plain PyTorch versions.

Counterpart of ``wrinklefree_tpu/ops/flash_attention.py``'s
``flash_prefill``, ``flash_paged_prefill`` and ``flash_paged_decode``. The
plain causal prefill is the TPU kernel's blockwise online softmax, block for
block; the plain paged prefill is the masked-softmax GQA core of the paged
forward (``kv/paged.py::_gqa_core``) on the same inputs; the plain decode
is the TPU kernel's online softmax with all committed pages as one update
and the staging prefix plus the current token as the last.

Each wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel (``csrc/flash_prefill.cu``, ``csrc/flash_decode.cu``)
or raises. ``<wrapper>.launches`` counts launches.
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
    kernel walks its own 64-key tiles."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, q_offset, block_q=block_q, block_k=block_k)
    cuda_lib.require_cuda(q, "flash_prefill")
    B, S, NH, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    _prefill_tiles(S, T, block_q, block_k)
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the CUDA kernel takes q, k and v all bfloat16 or all float32")
    if D not in (64, 128) or NH % KV or k.shape != v.shape or tuple(k.shape) != (B, T, KV, D):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (qc, kc, vc)):
        raise ValueError("the CUDA kernel reads 16-byte aligned rows")
    if isinstance(q_offset, torch.Tensor):
        if q_offset.numel() != 1 or q_offset.dtype.is_floating_point:
            raise ValueError("q_offset must be an int or a one-element integer tensor")
        qoff = q_offset.to(device=q.device, dtype=torch.int32).reshape(1)
    else:
        if q_offset < 0:
            raise ValueError(f"q_offset must be >= 0, got {q_offset}")
        qoff = torch.tensor([q_offset], dtype=torch.int32, device=q.device)
    out = torch.empty_like(qc)
    cuda_lib.call(
        "wf_flash_prefill", qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), qoff.data_ptr(),
        out.data_ptr(), B, S, NH, KV, D, T, int(q.dtype == torch.float32), 1.0 / math.sqrt(D),
        cuda_lib.stream(q),
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
    paged history, without materializing the [B, S, T] scores."""
    if q.device.type == "cpu":
        return flash_paged_prefill_plain(q, k_full, v_full, kv_valid, new_len,
                                         hist_len=hist_len)
    cuda_lib.require_cuda(q, "flash_paged_prefill")
    B, S, NH, D = q.shape
    Tt, KV = k_full.shape[1], k_full.shape[2]
    if (
        q.dtype != torch.bfloat16 or k_full.dtype != torch.bfloat16
        or v_full.dtype != torch.bfloat16
    ):
        raise ValueError("the CUDA kernel takes bfloat16")
    if D != 128 or NH % KV or k_full.shape != v_full.shape or k_full.shape[0] != B:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k {tuple(k_full.shape)}")
    if not hist_len + S <= Tt:
        raise ValueError(f"hist_len {hist_len} + S {S} exceeds key length {Tt}")
    qc, kc, vc = q.contiguous(), k_full.contiguous(), v_full.contiguous()
    kvv = _lengths(kv_valid, B, q.device).contiguous()
    nl = _lengths(new_len, B, q.device).contiguous()
    out = torch.empty_like(qc)
    cuda_lib.call(
        "wf_flash_paged_prefill", qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        kvv.data_ptr(), nl.data_ptr(), out.data_ptr(), B, S, NH, KV, D, Tt, hist_len,
        1.0 / math.sqrt(D), cuda_lib.stream(q),
    )
    flash_paged_prefill.launches += 1
    return out


flash_paged_prefill.launches = 0


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
    of the history. Returns [B, NH, D]."""
    if q.device.type == "cpu":
        return flash_paged_decode_plain(q, k_cur, v_cur, main, staging_b, layer, page_table,
                                        seq_lens)
    cuda_lib.require_cuda(q, "flash_paged_decode")
    B, NH, D = q.shape
    KV = k_cur.shape[1]
    P, two_l, ps, kvd = main.shape
    n_l = two_l // 2
    MP = page_table.shape[1]
    if any(t.dtype != torch.bfloat16 for t in (q, k_cur, v_cur, main, staging_b)):
        raise ValueError("the CUDA kernel takes bfloat16")
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
    pt = page_table.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    cuda_lib.call(
        "wf_flash_paged_decode", qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), main.data_ptr(),
        sc.data_ptr(), pt.data_ptr(), sl.data_ptr(), out.data_ptr(), B, NH, KV, n_l, layer,
        ps, MP, D, 1.0 / math.sqrt(D), cuda_lib.stream(q),
    )
    flash_paged_decode.launches += 1
    return out


flash_paged_decode.launches = 0
