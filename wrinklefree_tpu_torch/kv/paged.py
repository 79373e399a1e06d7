"""Paged KV cache (dual and token-major layouts) and the paged model forward
(PyTorch port).

Counterpart of ``wrinklefree_tpu/kv/paged.py``, one device, two layouts:

    dual (layer-major + staging):
      main      : [P, 2L, ps, KV*D]     layer l's keys of a page are one
                                        contiguous [ps, KV*D] block (k at row
                                        l, v at row L + l)
      staging   : [NS+1, ps, 2L, KV*D]  token-major: each slot's current
                                        partial page; slot NS is trash
    token-major:
      kv        : [P, ps, 2L, KV*D]     one token's whole contribution (k and v
                                        of every layer) is one contiguous row
    page_table  : [num_slots, max_pages] int32 page ids; page 0 is trash

Quantized pools (int8, fp8) carry f32 per-(token, layer, head) scales in
``scale``, laid out as ``kv`` less its last axis, and the dual layout's
``staging_scale`` [NS+1, ps, 2L, KV]; history is dequantized after the
gather. The reference pads L to a multiple of 4 (``_lpad``) for Mosaic's
DMA tiling; the port keeps 2L rows.

Dual layout: decode writes one staging row per slot and flushes a completed
page into the main pool; prefill chunks start page-aligned and write whole
pages plus a staging remainder. Token-major layout: every token's row goes
to (page_table[pos // ps], pos % ps). Padding and incomplete targets resolve
to trash (page 0 / staging slot NS), so the forward never branches on slot
liveness.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import BitNetConfig
from ..models.bitnet import compute_logits
from ..models.moe import expert_linear, moe_layer
from ..ops.flash_attention import (flash_paged_decode, flash_paged_prefill,
                                   flash_paged_prefill_pool)
from ..ops.kv_update_cuda import kv_write as kv_write_kernel
from ..ops.kv_update_cuda import kv_write_plain
from ..ops.rope import apply_rope, rope_cos_sin
from ..ops.norms import rms_norm
from ..ops.ternary_cuda import make_linear_fused, make_linear_stacked
from .quantized import dequantize_kv, kv_dtype_name, kv_torch_dtype, needs_scale, quantize_kv


class PagedKV(NamedTuple):
    """KV pools: dual (``kv`` layer-major [P, 2L, ps, KV*D] plus ``staging``
    [NS+1, ps, 2L, KV*D]) or token-major (``kv`` [P, ps, 2L, KV*D], staging
    None). ``scale`` and ``staging_scale`` (f32, the layout of ``kv`` and
    ``staging`` less the last axis, KV heads in its place) are set for
    quantized dtypes only."""

    kv: torch.Tensor
    staging: Optional[torch.Tensor] = None  # dual layout only
    scale: Optional[torch.Tensor] = None  # quantized only
    staging_scale: Optional[torch.Tensor] = None  # dual + quantized only

    @classmethod
    def zeros(cls, cfg: BitNetConfig, num_pages: int, page_size: int,
              kv_dtype: str = "bf16", device="cuda") -> "PagedKV":
        """Token-major pool [P, ps, 2L, KV*D]; scales [P, ps, 2L, KV] of ones."""
        shape = (num_pages, page_size, 2 * cfg.num_layers, cfg.num_kv_heads * cfg.head_dim)
        kv = torch.zeros(shape, dtype=kv_torch_dtype(kv_dtype), device=device)
        scale = None
        if needs_scale(kv_dtype):
            scale = torch.ones(shape[:-1] + (cfg.num_kv_heads,), dtype=torch.float32,
                               device=device)
        return cls(kv, None, scale)

    @classmethod
    def zeros_dual(
        cls,
        cfg: BitNetConfig,
        num_pages: int,
        page_size: int,
        num_slots: int,
        kv_dtype: str = "bf16",
        device="cuda",
    ) -> "PagedKV":
        if page_size % 8:
            raise ValueError("dual KV layout needs page_size % 8 == 0")
        two_l = 2 * cfg.num_layers
        kvd = cfg.num_kv_heads * cfg.head_dim
        dt = kv_torch_dtype(kv_dtype)
        kv = torch.zeros((num_pages, two_l, page_size, kvd), dtype=dt, device=device)
        staging = torch.zeros((num_slots + 1, page_size, two_l, kvd), dtype=dt, device=device)
        if not needs_scale(kv_dtype):
            return cls(kv, staging)
        kvh = cfg.num_kv_heads
        return cls(kv, staging,
                   torch.ones((num_pages, two_l, page_size, kvh), dtype=torch.float32,
                              device=device),
                   torch.ones((num_slots + 1, page_size, two_l, kvh), dtype=torch.float32,
                              device=device))

    @property
    def dual(self) -> bool:
        return self.staging is not None

    @property
    def page_size(self) -> int:
        return self.kv.shape[2] if self.dual else self.kv.shape[1]

    @property
    def kv_dtype_name(self) -> str:
        return kv_dtype_name(self.kv.dtype)

    @property
    def nbytes(self) -> int:
        """Device bytes of every pool (values and scales)."""
        return sum(t.numel() * t.element_size() for t in self if t is not None)


def _gqa_masked(q, k, v, mask):
    """Masked-softmax GQA: q [B,S,NH,D] over k/v [B,T,KV,D] with mask
    [B,S,T]. Scores and softmax in f32 (bf16 inputs are exact in f32),
    probabilities rounded to the value dtype. The mask value is finite: a
    fully-masked row (batch padding with new_lens == 0) must produce
    garbage-but-finite output, or NaN would reach the shared trash page and
    from there every other row."""
    B, S, NH, D = q.shape
    KV = k.shape[2]
    G = NH // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, KV, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    scores = torch.where(mask[:, None, None], scores, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs.float(), v.float()).to(q.dtype)
    return out.reshape(B, S, NH, D)


def _cur_causal(S, new_lens, dev):
    """[B, S_q, S_k]: current keys causal within the chunk and limited to
    new_lens real tokens."""
    cur_idx = torch.arange(S, device=dev)
    return (cur_idx[None, None, :] <= cur_idx[None, :, None]) & (
        cur_idx[None, None, :] < new_lens[:, None, None])


def _gqa_core(q, k_cur, v_cur, k_hist, v_hist, hist_ok, new_lens):
    """Masked-softmax GQA over [history ++ current chunk].

    q [B,S,NH,D]; k/v_cur [B,S,KV,D]; k/v_hist [B,T,KV,D]; hist_ok [B,T]
    marks valid history slots; current keys are causal within the chunk and
    limited to new_lens real tokens.
    """
    B, S = q.shape[:2]
    T = k_hist.shape[1]
    k = torch.cat([k_hist, k_cur.to(k_hist.dtype)], dim=1)
    v = torch.cat([v_hist, v_cur.to(v_hist.dtype)], dim=1)
    mask = torch.cat([hist_ok[:, None, :].expand(B, S, T),
                      _cur_causal(S, new_lens, q.device)], dim=-1)  # [B, S, T+S]
    return _gqa_masked(q, k, v, mask)


def _history(main, page_table, layer, KV, D):
    """Layer `layer`'s k and v of every table page: 2 x [B, MP*ps, KV, D]."""
    B, MP = page_table.shape
    n_l = main.shape[1] // 2
    ps = main.shape[2]
    k = main[page_table, layer].reshape(B, MP * ps, KV, D)
    v = main[page_table, n_l + layer].reshape(B, MP * ps, KV, D)
    return k, v


def _dequant(x, scale, dtype):
    """x [..., KV, D] with scale [..., KV] (None: unquantized) in ``dtype``."""
    if scale is None:
        return x.to(dtype)
    return dequantize_kv(x, scale[..., None], out_dtype=dtype)


def _paged_attention_dual(
    q, k_cur, v_cur, main, staging_b, layer, page_table, seq_lens, new_lens, cfg,
    main_scale=None, staging_scale_b=None,
):
    """History attention over the layer-major main pool + staging page.

    Valid history = (seq_lens // ps) full pages + (seq_lens % ps) staging
    tokens; staging_b [B, ps, 2L, KVD] holds this batch's partial pages.
    Quantized pools pass ``main_scale`` [P, 2L, ps, KV] and
    ``staging_scale_b`` [B, ps, 2L, KV]; the history is dequantized after the
    page gather.
    """
    B, S, NH, D = q.shape
    KV = k_cur.shape[2]
    n_l = main.shape[1] // 2
    ps = main.shape[2]
    MP = page_table.shape[1]
    dev = q.device
    k_main, v_main = _history(main, page_table, layer, KV, D)
    k_stage = staging_b[:, :, layer].reshape(B, ps, KV, D)
    v_stage = staging_b[:, :, n_l + layer].reshape(B, ps, KV, D)
    sk = sv = ssk = ssv = None
    if main_scale is not None:
        sk = main_scale[page_table, layer].reshape(B, MP * ps, KV)
        sv = main_scale[page_table, n_l + layer].reshape(B, MP * ps, KV)
        ssk, ssv = staging_scale_b[:, :, layer], staging_scale_b[:, :, n_l + layer]

    full_tokens = (seq_lens // ps) * ps  # tokens committed to main
    off = seq_lens - full_tokens  # tokens in staging
    main_ok = torch.arange(MP * ps, device=dev)[None, :] < full_tokens[:, None]
    stage_ok = torch.arange(ps, device=dev)[None, :] < off[:, None]

    k_hist = torch.cat([_dequant(k_main, sk, q.dtype), _dequant(k_stage, ssk, q.dtype)], dim=1)
    v_hist = torch.cat([_dequant(v_main, sv, q.dtype), _dequant(v_stage, ssv, q.dtype)], dim=1)
    hist_ok = torch.cat([main_ok, stage_ok], dim=1)
    return _gqa_core(q, k_cur, v_cur, k_hist, v_hist, hist_ok, new_lens)


def _paged_attention_dual_flash(
    q, k_cur, v_cur, main, staging_b, layer, page_table, seq_lens, new_lens, cfg
):
    """Flash (online-softmax) prefill over the dual layout. Prefill chunks
    start page-aligned, so staging is empty and valid history is exactly
    the seq_lens-token prefix of the table's main pages, which the kernel
    reads from the pool (``flash_paged_prefill_pool``; its plain version
    gathers them)."""
    dt = main.dtype
    out = flash_paged_prefill_pool(
        q.to(dt), k_cur.to(dt), v_cur.to(dt), main, layer, page_table, seq_lens, new_lens)
    return out.to(q.dtype)


def _paged_attention_dual_flash_decode(
    q, k_cur, v_cur, main, staging_b, layer, page_table, seq_lens, new_lens, cfg
):
    """Decode-step (S == 1) attention with the page gather inside the kernel
    (``ops.flash_attention.flash_paged_decode``): the history is read from
    the pool once, without the gathered [B, MP*ps, KV, D] copies and the
    concatenations of the plain path."""
    out = flash_paged_decode(q[:, 0], k_cur[:, 0], v_cur[:, 0], main, staging_b, layer,
                             page_table, seq_lens)
    return out[:, None]


def _token_history(kv_rows, scale_rows, layer, token_rows, KV, D, dtype):
    """Layer `layer`'s k and v rows of the token-major pool at the flat rows
    ``token_rows`` [B, T]: 2 x [B, T, KV, D], dequantized to ``dtype`` (with
    ``dtype`` None: left in the pool's dtype)."""
    B, T = token_rows.shape
    n_l = kv_rows.shape[1] // 2
    k = kv_rows[token_rows, layer].reshape(B, T, KV, D)
    v = kv_rows[token_rows, n_l + layer].reshape(B, T, KV, D)
    if dtype is None:
        return k, v
    sk = sv = None
    if scale_rows is not None:
        sk, sv = scale_rows[token_rows, layer], scale_rows[token_rows, n_l + layer]
    return _dequant(k, sk, dtype), _dequant(v, sv, dtype)


def _paged_attention_token(q, k_cur, v_cur, kv_rows, scale_rows, layer, token_rows, seq_lens,
                           new_lens):
    """Gather attention over the token-major pool (the reference's
    ``_paged_attention_jnp``). ``kv_rows`` is the row-flattened pool [P*ps,
    2L, KV*D] (``scale_rows`` [P*ps, 2L, KV] or None), ``token_rows`` [B, T]
    the flat row of every history slot of the table; the first seq_lens of
    them are valid. The chunk (q/k_cur/v_cur) is not in the pool yet."""
    KV, D = k_cur.shape[2], k_cur.shape[3]
    T = token_rows.shape[1]
    k_hist, v_hist = _token_history(kv_rows, scale_rows, layer, token_rows, KV, D, q.dtype)
    hist_ok = torch.arange(T, device=q.device)[None, :] < seq_lens[:, None]
    return _gqa_core(q, k_cur, v_cur, k_hist, v_hist, hist_ok, new_lens)


def _paged_attention_token_flash(q, k_cur, v_cur, kv_rows, scale_rows, layer, token_rows,
                                 seq_lens, new_lens):
    """Flash prefill over the token-major pool (the reference's
    ``_paged_attention_flash``): the table's history gathered, the chunk
    appended, and K4's contiguous form (``flash_paged_prefill``) over them.
    Unquantized pools only."""
    KV, D = k_cur.shape[2], k_cur.shape[3]
    T = token_rows.shape[1]
    k_hist, v_hist = _token_history(kv_rows, None, layer, token_rows, KV, D, None)
    k_full = torch.cat([k_hist, k_cur.to(k_hist.dtype)], dim=1)
    v_full = torch.cat([v_hist, v_cur.to(v_hist.dtype)], dim=1)
    out = flash_paged_prefill(q.to(k_full.dtype), k_full, v_full, seq_lens, new_lens,
                              hist_len=T)
    return out.to(q.dtype)


def _gqa_core_windowed(q, k_cur, v_cur, k_hist, v_hist, hist_pos, hist_valid, seq_lens,
                       new_lens, window: int, global_tokens: int):
    """Masked-softmax GQA over [gathered history ++ current chunk] with
    sliding-window + global-prefix key selection.

    hist_pos [B, Th] carries each gathered history token's sequence
    position, hist_valid [B, Th] its storage validity. A key at position kp
    is visible to the query at position qp iff ``qp - window <= kp <= qp``
    (the window) or ``kp < global_tokens`` and strictly before the window
    (the global prefix: exclusive, so no key is counted twice across the two
    gathers)."""
    B, S = q.shape[:2]
    Th = k_hist.shape[1]
    dev = q.device
    k = torch.cat([k_hist, k_cur.to(k_hist.dtype)], dim=1)
    v = torch.cat([v_hist, v_cur.to(v_hist.dtype)], dim=1)
    qp = (seq_lens[:, None] + torch.arange(S, device=dev)[None, :])[:, :, None]  # [B, S, 1]

    def win_ok(kp):  # kp [B, 1, T'] -> [B, S, T'] visibility under window + globals
        in_win = (kp >= qp - window) & (kp <= qp)
        is_glob = (kp < global_tokens) & (kp < qp - window)
        return in_win | is_glob

    hist_ok = hist_valid[:, None, :].expand(B, S, Th) & win_ok(hist_pos[:, None, :])
    cur_pos = seq_lens[:, None] + torch.arange(S, device=dev)[None, :]
    cur_ok = _cur_causal(S, new_lens, dev) & win_ok(cur_pos[:, None, :])
    return _gqa_masked(q, k, v, torch.cat([hist_ok, cur_ok], dim=-1))


def make_dual_window_attention(window: int, global_tokens: int = 0):
    """Sliding-window attention over the dual layout that skips pages: only
    the pages that can intersect some query's window [qp - window, qp] this
    call, and the global prefix's pages, are gathered, so a step's attention
    reads scale with the window, not the context. Whenever window >= seq_len
    the visible set is full causal attention, so the output equals
    ``_paged_attention_dual``'s up to summation order. KV writes are
    unchanged: the whole cache is kept, only reads shrink. Quantized pools
    are dequantized after both gathers."""
    if window <= 0:
        raise ValueError("window must be positive")

    def attn(q, k_cur, v_cur, main, staging_b, layer, page_table, seq_lens, new_lens, cfg,
             main_scale=None, staging_scale_b=None):
        B, S, NH, D = q.shape
        KV = k_cur.shape[2]
        n_l = main.shape[1] // 2
        ps = main.shape[2]
        MP = page_table.shape[1]
        dev = q.device
        # pages that can intersect any query's window this call
        wp = min(MP, (window + S) // ps + 2)
        gp = min(MP, -(-global_tokens // ps)) if global_tokens > 0 else 0

        full_tokens = (seq_lens // ps) * ps  # committed to main pages
        off = seq_lens - full_tokens

        first = torch.clamp_min(seq_lens - window, 0) // ps  # [B]
        idx = torch.clamp_max(first[:, None] + torch.arange(wp, device=dev)[None, :], MP - 1)
        wpt = page_table.gather(1, idx.long()).long()  # [B, wp]

        def gather(pt, n):
            kk = main[pt, layer].reshape(B, n * ps, KV, D)
            vv = main[pt, n_l + layer].reshape(B, n * ps, KV, D)
            sk = sv = None
            if main_scale is not None:
                sk = main_scale[pt, layer].reshape(B, n * ps, KV)
                sv = main_scale[pt, n_l + layer].reshape(B, n * ps, KV)
            return _dequant(kk, sk, q.dtype), _dequant(vv, sv, q.dtype)

        k_w, v_w = gather(wpt, wp)
        wpos = first[:, None] * ps + torch.arange(wp * ps, device=dev)[None, :]  # [B, wp*ps]
        segs_k, segs_v, segs_pos, segs_ok = [k_w], [v_w], [wpos], [wpos < full_tokens[:, None]]
        if gp:
            k_g, v_g = gather(page_table[:, :gp].long(), gp)
            gpos = torch.arange(gp * ps, device=dev)[None, :].expand(B, gp * ps)
            # a position the window gather covers (pos >= first * ps) must not
            # be visible through this copy too, or the early overlap (first
            # == 0) would count keys twice in the softmax
            segs_k.append(k_g)
            segs_v.append(v_g)
            segs_pos.append(gpos)
            segs_ok.append((gpos < full_tokens[:, None]) & (gpos < first[:, None] * ps))

        k_stage = staging_b[:, :, layer].reshape(B, ps, KV, D)
        v_stage = staging_b[:, :, n_l + layer].reshape(B, ps, KV, D)
        ssk = ssv = None
        if main_scale is not None:
            ssk, ssv = staging_scale_b[:, :, layer], staging_scale_b[:, :, n_l + layer]
        segs_k.append(_dequant(k_stage, ssk, q.dtype))
        segs_v.append(_dequant(v_stage, ssv, q.dtype))
        segs_pos.append(full_tokens[:, None] + torch.arange(ps, device=dev)[None, :])
        segs_ok.append(torch.arange(ps, device=dev)[None, :] < off[:, None])
        attn.gathered_pages += B * (wp + gp)
        return _gqa_core_windowed(
            q, k_cur, v_cur, torch.cat(segs_k, dim=1), torch.cat(segs_v, dim=1),
            torch.cat(segs_pos, dim=1), torch.cat(segs_ok, dim=1), seq_lens, new_lens,
            window, global_tokens)

    attn.window = window
    attn.global_tokens = global_tokens
    attn.gathered_pages = 0  # main-pool pages gathered per layer call, summed (host count)
    return attn


def _dual_write(
    pools: PagedKV,
    vals: torch.Tensor,  # [B, S, 2L, KVD] token rows (k-layers then v-layers)
    page_table: torch.Tensor,  # [B, MP]
    seq_lens: torch.Tensor,  # [B] tokens already cached (page-aligned if S > ps)
    new_lens: torch.Tensor,  # [B] real tokens in this chunk
    slot_ids: Optional[torch.Tensor],
    kv_write,
    svals: Optional[torch.Tensor] = None,  # [B, S, 2L, KV] their scales (quantized)
) -> PagedKV:
    """Commit S new tokens to the dual-layout pools through ``kv_write``
    (values) and indexed assignment (scales, which mirror the value writes:
    same rows, KV heads in place of KV*D).

    S <= ps (decode, or a one-page chunk): each token's row goes to its
    slot's staging page at offset (pos % ps); the slot's current page is
    flushed to the main pool iff this window covers its last offset. Write
    order matters: current-page rows first, then the flush (which snapshots
    the staging page), then the rows that wrapped into the next page.
    S > ps (prefill, page-aligned start): pages fully covered by real tokens
    are transposed and written page-at-a-time; the remainder goes to
    staging. Non-completed flushes and padding land in the trash page /
    trash staging slot.
    """
    B, S = vals.shape[:2]
    P, two_l, ps = pools.kv.shape[:3]
    MP = page_table.shape[1]
    NS = pools.staging.shape[0] - 1
    dev = vals.device
    i32 = torch.int32
    slots = (
        torch.arange(B, dtype=i32, device=dev) if slot_ids is None else slot_ids.to(i32)
    )
    # (main pool, staging pool, rows, writer) per plane: values, then scales
    planes = [(pools.kv, pools.staging, vals, kv_write)]
    if svals is not None:
        planes.append((pools.scale, pools.staging_scale, svals, kv_write_plain))
    ns = torch.tensor(NS, dtype=i32, device=dev)
    zero = torch.tensor(0, dtype=i32, device=dev)

    if S <= ps:
        off0 = (seq_lens % ps).to(i32)
        ar = torch.arange(S, dtype=i32, device=dev)[None, :]
        pos_off = ((off0[:, None] + ar) % ps).reshape(-1)
        real = ar < new_lens[:, None]
        in_cur = off0[:, None] + ar < ps
        srow1 = torch.where(real & in_cur, slots[:, None], ns).reshape(-1)
        srow2 = torch.where(real & ~in_cur, slots[:, None], ns).reshape(-1)
        completed = off0 + new_lens >= ps  # at most one page per window
        lpg = torch.clamp(seq_lens // ps, 0, MP - 1).long()
        pid_b = torch.where(
            completed, page_table.gather(1, lpg[:, None])[:, 0].to(i32), zero)
        zeros_b = torch.zeros(B, dtype=i32, device=dev)
        for main, staging, v, write in planes:
            w = v.shape[-1]
            rows = v.reshape(B * S, two_l, w)
            write(staging, rows, srow1, pos_off)
            flushed = staging[slots.long()].transpose(1, 2).reshape(B, two_l * ps, w)
            # one row = one whole page
            write(main.view(P, 1, two_l * ps, w), flushed, pid_b, zeros_b)
            if S > 1:
                write(staging, rows, srow2, pos_off)
        return pools

    if S % ps:
        raise ValueError(
            f"dual KV layout requires prefill chunks that are multiples of "
            f"page_size ({ps}); got S={S}"
        )
    npg = S // ps
    j = torch.arange(npg, dtype=i32, device=dev)[None, :]
    logical = seq_lens[:, None] // ps + j
    full = ((j + 1) * ps <= new_lens[:, None]) & (logical < MP)
    pid = torch.where(
        full, page_table.gather(1, torch.clamp(logical, 0, MP - 1).long()).to(i32), zero)

    # staging remainder: the (new_lens % ps) tokens of the first non-full page
    nfull = new_lens // ps
    idx = nfull[:, None] * ps + torch.arange(ps, device=dev)[None, :]  # chunk-relative
    valid = idx < new_lens[:, None]
    gidx = torch.clamp(idx, 0, S - 1).long()
    srow_slot = torch.where(valid, slots[:, None], ns).reshape(-1)
    soff = torch.arange(ps, dtype=i32, device=dev)[None, :].expand(B, ps).reshape(-1)
    zeros_p = torch.zeros(B * npg, dtype=i32, device=dev)
    for main, staging, v, write in planes:
        w = v.shape[-1]
        pages = v.reshape(B, npg, ps, two_l, w).permute(0, 1, 3, 2, 4)
        write(main.view(P, 1, two_l * ps, w), pages.reshape(B * npg, two_l * ps, w),
              pid.reshape(-1), zeros_p)
        v_stage = v[torch.arange(B, device=dev)[:, None], gidx]  # [B, ps, 2L, w]
        write(staging, v_stage.reshape(B * ps, two_l, w), srow_slot, soff)
    return pools


def _token_write(pools: PagedKV, vals, svals, page_ids, offsets, kv_write) -> PagedKV:
    """Commit the chunk's rows to the token-major pool: row (b, s) to
    (page_ids[b, s], offsets[b, s]); ``kv_write`` for the values, indexed
    assignment for the scales."""
    n = vals.shape[0] * vals.shape[1]
    ids = page_ids.reshape(-1).to(torch.int32)
    offs = offsets.reshape(-1).to(torch.int32)
    kv_write(pools.kv, vals.reshape(n, *vals.shape[2:]), ids, offs)
    if svals is not None:
        kv_write_plain(pools.scale, svals.reshape(n, *svals.shape[2:]), ids, offs)
    return pools


def paged_forward(
    params,
    cfg: BitNetConfig,
    tokens: torch.Tensor,  # [B, S] int (padded; padding positions >= seq_len+real_S)
    pools: PagedKV,
    page_table: torch.Tensor,  # [B, MP] int32
    seq_lens: torch.Tensor,  # [B] int32 tokens already cached (before this call)
    new_lens: torch.Tensor,  # [B] int32 how many of the S tokens are real
    *,
    linear_fn=None,
    attention_fn=None,
    kv_write=None,
    slot_ids: Optional[torch.Tensor] = None,  # [B] staging slots (dual layout)
    flash_decode: bool = False,
    head_fn=None,  # (hidden [B, H], params) -> anything; replaces compute_logits
    logits_all: bool = False,  # True: [B, S, V] logits (speculative verify)
):
    """Run S new tokens per slot against the paged cache.

    Returns (last-real-token logits [B, V] float32, or ``head_fn``'s result
    on the final-normed hidden rows [B, H]; updated pools); the pools are
    written in place. With ``logits_all`` every position's logits [B, S, V]
    (``head_fn`` then sees [B, S, H]). Covers batched decode (S=1,
    new_lens=1), chunked prefill (S=bucket, new_lens=true chunk length) and
    the speculative verify window (S = k+1, new_lens = the window clamped
    to the current page), on dual or token-major pools, unquantized or
    quantized.

    ``linear_fn`` defaults to the fused kernels (``make_linear_fused()``)
    for fused dense params and to the stacked K7 linear
    (``make_linear_stacked()``) otherwise. Two layer steps, as in the
    reference: the prologue step for fused params with a fused-prologue
    ``linear_fn``; the plain step (norm, quantize, linear, and the MoE MLP of
    ``models/moe.py`` for ``cfg.num_experts > 0``) for a stacked or unstacked
    ``linear_fn`` over unfused or fused params. The default attention and
    write follow the reference's kernel path (its ``kv_write="pallas"``
    proxy: pools that are not quantized). On unquantized pools:
    ``attention_fn`` defaults to K4 for chunks of 128 tokens or more whose
    table width times the page size plus S is a multiple of 128 (the
    reference's condition; over the pool on the dual layout, K4's contiguous
    form over the gathered history on the token-major one), to the flash
    decode kernel at S == 1 on the dual layout when ``flash_decode`` is set,
    and to the plain gather attention otherwise; ``kv_write`` defaults to
    the in-place writer kernel (K3). K4 and K6 take bf16, fp16 and f32 pools
    on the card. Quantized pools take the plain attention,
    which dequantizes the gathered history, and the plain write (indexed
    assignment), whatever ``flash_decode`` says. Each wrapper runs its plain
    version on CPU tensors, and the plain functions can be passed explicitly
    to run the plain path on the card.

    An ``attention_fn`` is called with each layout's own arguments and
    returns [B, S, NH, D]. Dual layout: ``(q, k_cur, v_cur, main, staging_b,
    layer, page_table, seq_lens, new_lens, cfg)``, plus ``main_scale=`` and
    ``staging_scale_b=`` on quantized pools (``_paged_attention_dual``).
    Token-major layout: ``(q, k_cur, v_cur, kv_rows, scale_rows, layer,
    token_rows, seq_lens, new_lens)`` (``_paged_attention_token``).
    """
    stack = params["layers"]
    fused = "qkv_qw" in stack
    if linear_fn is None:
        linear_fn = make_linear_fused() if "gateup_qw" in stack else make_linear_stacked()
    lf = linear_fn
    quantized = pools.scale is not None
    write = kv_write or (kv_write_plain if quantized else kv_write_kernel)
    stacked = getattr(lf, "stacked", False)
    if fused and not stacked:
        raise ValueError("fused projections require a stacked linear_fn")
    prologue = fused and "gateup_qw" in stack and getattr(lf, "prologue", False)
    if getattr(lf, "prologue", False) and not prologue:
        raise ValueError("a fused-prologue linear_fn needs fused q/k/v and gate/up params "
                         "(models.bitnet.fuse_projections of a dense model)")
    B, S = tokens.shape
    ps = pools.page_size
    dtype = cfg.dtype
    dev = tokens.device
    seq_lens = seq_lens.to(torch.int32)
    new_lens = new_lens.to(torch.int32)
    dual = pools.dual

    hidden = params["embed"][tokens.long()].to(dtype)
    positions = seq_lens[:, None] + torch.arange(S, device=dev)[None, :]  # [B,S]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, dtype)

    if attention_fn is not None:
        attn_impl = attention_fn
    else:
        # the reference's condition (its kernel path): the flash prefill only
        # where the table's tokens plus the chunk fill whole 128-token tiles;
        # the two paths round attention differently
        hist_tokens = page_table.shape[1] * ps
        use_flash = not quantized and S >= 128 and (hist_tokens + S) % 128 == 0
        if not dual:
            attn_impl = _paged_attention_token_flash if use_flash else _paged_attention_token
        elif not quantized and S == 1 and flash_decode:
            attn_impl = _paged_attention_dual_flash_decode
        else:
            attn_impl = _paged_attention_dual_flash if use_flash else _paged_attention_dual

    if dual:
        # this batch's staging pages (and scales), gathered once for all layers
        sid = torch.arange(B, device=dev) if slot_ids is None else slot_ids.long()
        hist = (pools.kv, pools.staging[sid])
        hist_kw = ({} if not quantized else
                   dict(main_scale=pools.scale, staging_scale_b=pools.staging_scale[sid]))
    else:
        P = pools.kv.shape[0]
        # flat row of every history slot [B, MP*ps]; the chunk's rows go to
        # (page_table[pos // ps], pos % ps), padding past the table to page 0
        tbl = page_table.long()
        token_rows = (tbl[:, :, None] * ps + torch.arange(ps, device=dev)).reshape(B, -1)
        page_slot = positions.long() // ps
        in_range = page_slot < tbl.shape[1]
        page_ids = torch.where(in_range, tbl.gather(1, page_slot.clamp(0, tbl.shape[1] - 1)),
                               torch.zeros_like(page_slot))
        offsets = positions % ps
        hist = (pools.kv.view(P * ps, *pools.kv.shape[2:]),
                None if not quantized else pools.scale.view(P * ps, *pools.scale.shape[2:]))
        hist_kw = {}

    L = stack["o_qw"].shape[0]
    eps = cfg.rms_norm_eps
    kvd = cfg.num_kv_heads * cfg.head_dim
    mlp_act = "silu" if cfg.mlp_act == "silu" else "relu2"
    mega = getattr(lf, "mlp_mega", None) if prologue and B * S <= 8 else None
    expert_lf = expert_linear(lf)

    def plf(x, name, l, norm_name=None, act="none"):
        nw = stack[norm_name] if norm_name is not None else None
        return lf(x, stack[name + "_qw"], stack[name + "_scale"], l, nw, act=act,
                  norm=norm_name is not None, eps=eps)

    def wlin(x, l, name):
        if stacked:
            return lf(x, stack[name + "_qw"], stack[name + "_scale"], l)
        return lf(x, stack[name + "_qw"][l], stack[name + "_scale"][l])

    def split_qkv(qkv):
        qd = qkv.shape[-1] - 2 * kvd
        return (qkv[..., :qd].reshape(B, S, -1, cfg.head_dim),
                qkv[..., qd:qd + kvd].reshape(B, S, -1, cfg.head_dim),
                qkv[..., qd + kvd:].reshape(B, S, -1, cfg.head_dim))

    def attention(q, k, v, l):
        q, k = apply_rope(q, k, cos, sin)
        if dual:
            attn = attn_impl(q, k, v, *hist, l, page_table, seq_lens, new_lens, cfg, **hist_kw)
        else:
            attn = attn_impl(q, k, v, *hist, l, token_rows, seq_lens, new_lens)
        return attn.reshape(B, S, -1), k

    def prologue_step(h, l):
        q, k, v = split_qkv(plf(h, "qkv", l, "input_ln"))
        attn, k = attention(q, k, v, l)
        h = h + plf(attn, "o", l, "attn_sub" if cfg.sub_norms else None)
        # one launch for the whole MLP block at <= 8 rows; two fused linears
        # above that
        if mega is not None:
            h = mega(
                h, stack["gateup_qw"], stack["down_qw"], l, stack["gateup_scale"],
                stack["down_scale"], stack["post_ln"],
                stack["ffn_sub"] if cfg.sub_norms else None,
                eps=eps, act=mlp_act, norm2=cfg.sub_norms,
            )
        else:
            gu = plf(h, "gateup", l, "post_ln")
            h = h + plf(gu, "down", l, "ffn_sub" if cfg.sub_norms else None, act=mlp_act)
        return h, k, v

    def plain_step(h, l):
        normed = rms_norm(h, stack["input_ln"][l], eps)
        if fused:
            q, k, v = split_qkv(wlin(normed, l, "qkv"))
        else:
            q, k, v = (wlin(normed, l, n).reshape(B, S, -1, cfg.head_dim) for n in "qkv")
        attn, k = attention(q, k, v, l)
        if cfg.sub_norms:
            attn = rms_norm(attn, stack["attn_sub"][l], eps)
        h = h + wlin(attn, l, "o")
        normed = rms_norm(h, stack["post_ln"][l], eps)
        if cfg.num_experts > 0:
            y = moe_layer(normed.reshape(B * S, -1), stack, l, cfg, expert_lf)
            return h + y.reshape(B, S, -1).to(dtype), k, v
        if "gateup_qw" in stack:
            gu = wlin(normed, l, "gateup")
            inter = gu.shape[-1] // 2
            gate, up = gu[..., :inter], gu[..., inter:]
        else:
            gate, up = wlin(normed, l, "gate"), wlin(normed, l, "up")
        if cfg.mlp_act == "silu":
            act = torch.nn.functional.silu(gate) * up
        else:
            act = torch.square(torch.relu(gate)) * up
        if cfg.sub_norms:
            act = rms_norm(act, stack["ffn_sub"][l], eps)
        return h + wlin(act, l, "down"), k, v

    step = prologue_step if prologue else plain_step
    ks, vs = [], []
    for l in range(L):
        hidden, k, v = step(hidden, l)
        ks.append(k)
        vs.append(v)

    # each token's full contribution as one row [2L, KV*D] (k-layers, v-layers),
    # quantized per [D] head vector first
    kv_new = torch.stack(ks + vs, dim=2)  # [B, S, 2L, KV, D]
    q_kv, s_kv = quantize_kv(kv_new, pools.kv_dtype_name)
    vals = q_kv.reshape(B, S, 2 * L, kvd)
    svals = None if s_kv is None else s_kv.reshape(B, S, 2 * L, -1)
    if dual:
        new_pools = _dual_write(pools, vals, page_table, seq_lens, new_lens, slot_ids, write,
                                svals)
    else:
        new_pools = _token_write(pools, vals, svals, page_ids, offsets, write)

    hidden = rms_norm(hidden, params["final_norm"], eps)
    if not logits_all:  # the last real token per slot
        last_idx = torch.clamp(new_lens - 1, 0, S - 1).long()
        hidden = hidden.gather(1, last_idx[:, None, None].expand(B, 1, hidden.shape[-1]))[:, 0]
    if head_fn is not None:
        return head_fn(hidden, params), new_pools
    return compute_logits(hidden, params, cfg), new_pools
