"""Paged KV cache (dual layout) and the paged model forward (PyTorch port).

Counterpart of ``wrinklefree_tpu/kv/paged.py``, dual layout only, one device:

    main      : [P, 2L, ps, KV*D]     layer-major: layer l's keys of a page are
                                      one contiguous [ps, KV*D] block (k at
                                      row l, v at row L + l)
    staging   : [NS+1, ps, 2L, KV*D]  token-major: each slot's current partial
                                      page; slot NS is trash
    page_table: [num_slots, max_pages] int32 page ids; page 0 is trash

The reference pads L to a multiple of 4 (``_lpad``) for Mosaic's DMA
tiling; the port keeps 2L rows. Decode writes one staging row per slot and
flushes a completed page into the main pool; prefill chunks start
page-aligned and write whole pages plus a staging remainder. Padding and
incomplete targets resolve to trash (main page 0 / staging slot NS), so the
forward never branches on slot liveness.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import BitNetConfig
from ..models.bitnet import compute_logits
from ..models.moe import expert_linear, moe_layer
from ..ops.flash_attention import flash_paged_decode, flash_paged_prefill_pool
from ..ops.kv_update_cuda import kv_write as kv_write_kernel
from ..ops.rope import apply_rope, rope_cos_sin
from ..ops.norms import rms_norm
from ..ops.ternary_cuda import make_linear_fused, make_linear_stacked
from .quantized import kv_torch_dtype, quantize_kv


class PagedKV(NamedTuple):
    """Dual-layout KV pools: layer-major ``kv`` [P, 2L, ps, KV*D] plus the
    token-major ``staging`` [NS+1, ps, 2L, KV*D] (slot NS is trash)."""

    kv: torch.Tensor
    staging: torch.Tensor

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
        return cls(kv, staging)

    @property
    def page_size(self) -> int:
        return self.kv.shape[2]

    @property
    def kv_dtype_name(self) -> str:
        return {torch.bfloat16: "bf16", torch.float32: "f32"}[self.kv.dtype]


def _gqa_core(q, k_cur, v_cur, k_hist, v_hist, hist_ok, new_lens):
    """Masked-softmax GQA over [history ++ current chunk].

    q [B,S,NH,D]; k/v_cur [B,S,KV,D]; k/v_hist [B,T,KV,D]; hist_ok [B,T]
    marks valid history slots; current keys are causal within the chunk and
    limited to new_lens real tokens. Scores and softmax in f32 (bf16 inputs
    are exact in f32), probabilities rounded to the value dtype.
    """
    B, S, NH, D = q.shape
    KV = k_cur.shape[2]
    G = NH // KV
    T = k_hist.shape[1]
    k = torch.cat([k_hist, k_cur.to(k_hist.dtype)], dim=1)
    v = torch.cat([v_hist, v_cur.to(v_hist.dtype)], dim=1)

    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, KV, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    dev = q.device
    cur_idx = torch.arange(S, device=dev)
    cur_ok = (cur_idx[None, None, :] <= cur_idx[None, :, None]) & (
        cur_idx[None, None, :] < new_lens[:, None, None]
    )  # [B, S_q, S_k]
    mask = torch.cat([hist_ok[:, None, :].expand(B, S, T), cur_ok], dim=-1)  # [B, S, T+S]
    # finite mask value: a fully-masked row (batch padding with new_lens == 0)
    # must produce garbage-but-finite output, or NaN would reach the shared
    # trash page and from there every other row
    scores = torch.where(mask[:, None, None], scores, torch.tensor(-1e30, device=dev))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs.float(), v.float()).to(q.dtype)
    return out.reshape(B, S, NH, D)


def _history(main, page_table, layer, KV, D):
    """Layer `layer`'s k and v of every table page: 2 x [B, MP*ps, KV, D]."""
    B, MP = page_table.shape
    n_l = main.shape[1] // 2
    ps = main.shape[2]
    k = main[page_table, layer].reshape(B, MP * ps, KV, D)
    v = main[page_table, n_l + layer].reshape(B, MP * ps, KV, D)
    return k, v


def _paged_attention_dual(
    q, k_cur, v_cur, main, staging_b, layer, page_table, seq_lens, new_lens, cfg
):
    """History attention over the layer-major main pool + staging page.

    Valid history = (seq_lens // ps) full pages + (seq_lens % ps) staging
    tokens; staging_b [B, ps, 2L, KVD] holds this batch's partial pages.
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

    full_tokens = (seq_lens // ps) * ps  # tokens committed to main
    off = seq_lens - full_tokens  # tokens in staging
    main_ok = torch.arange(MP * ps, device=dev)[None, :] < full_tokens[:, None]
    stage_ok = torch.arange(ps, device=dev)[None, :] < off[:, None]

    k_hist = torch.cat([k_main, k_stage], dim=1).to(q.dtype)
    v_hist = torch.cat([v_main, v_stage], dim=1).to(q.dtype)
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


def _dual_write(
    pools: PagedKV,
    vals: torch.Tensor,  # [B, S, 2L, KVD] token rows (k-layers then v-layers)
    page_table: torch.Tensor,  # [B, MP]
    seq_lens: torch.Tensor,  # [B] tokens already cached (page-aligned if S > ps)
    new_lens: torch.Tensor,  # [B] real tokens in this chunk
    slot_ids: Optional[torch.Tensor],
    kv_write,
) -> PagedKV:
    """Commit S new tokens to the dual-layout pools through ``kv_write``.

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
    main, staging = pools.kv, pools.staging
    B, S, two_l, kvd = vals.shape
    P, _, ps, _ = main.shape
    MP = page_table.shape[1]
    NS = staging.shape[0] - 1
    dev = vals.device
    i32 = torch.int32
    slots = (
        torch.arange(B, dtype=i32, device=dev) if slot_ids is None else slot_ids.to(i32)
    )
    main_pages = main.view(P, 1, two_l * ps, kvd)  # one row = one whole page
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
        rows = vals.reshape(B * S, two_l, kvd)
        staging = kv_write(staging, rows, srow1, pos_off)
        flushed = staging[slots.long()].transpose(1, 2).reshape(B, two_l * ps, kvd)
        kv_write(main_pages, flushed, pid_b, torch.zeros(B, dtype=i32, device=dev))
        if S > 1:
            staging = kv_write(staging, rows, srow2, pos_off)
        return PagedKV(main, staging)

    if S % ps:
        raise ValueError(
            f"dual KV layout requires prefill chunks that are multiples of "
            f"page_size ({ps}); got S={S}"
        )
    npg = S // ps
    pages = vals.reshape(B, npg, ps, two_l, kvd).permute(0, 1, 3, 2, 4)
    j = torch.arange(npg, dtype=i32, device=dev)[None, :]
    logical = seq_lens[:, None] // ps + j
    full = ((j + 1) * ps <= new_lens[:, None]) & (logical < MP)
    pid = torch.where(
        full, page_table.gather(1, torch.clamp(logical, 0, MP - 1).long()).to(i32), zero)

    # staging remainder: the (new_lens % ps) tokens of the first non-full page
    nfull = new_lens // ps
    idx = nfull[:, None] * ps + torch.arange(ps, device=dev)[None, :]  # chunk-relative
    valid = idx < new_lens[:, None]
    gidx = torch.clamp(idx, 0, S - 1).long()[:, :, None, None].expand(B, ps, two_l, kvd)
    vals_stage = vals.gather(1, gidx)  # [B, ps, 2L, KVD]
    srow_slot = torch.where(valid, slots[:, None], ns)
    soff = torch.arange(ps, dtype=i32, device=dev)[None, :].expand(B, ps)

    kv_write(main_pages, pages.reshape(B * npg, two_l * ps, kvd), pid.reshape(-1),
             torch.zeros(B * npg, dtype=i32, device=dev))
    staging = kv_write(staging, vals_stage.reshape(B * ps, two_l, kvd),
                       srow_slot.reshape(-1), soff.reshape(-1))
    return PagedKV(main, staging)


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
    slot_ids: Optional[torch.Tensor] = None,  # [B] staging slots
    flash_decode: bool = False,
):
    """Run S new tokens per slot against the paged cache.

    Returns (last-real-token logits [B, V] float32, updated pools); the
    pools are written in place. Covers batched decode (S=1, new_lens=1) and
    chunked prefill (S=bucket, new_lens=true chunk length).

    ``linear_fn`` defaults to the fused kernels (``make_linear_fused()``)
    for fused dense params and to the stacked K7 linear
    (``make_linear_stacked()``) otherwise. Two layer steps, as in the
    reference: the prologue step for fused params with a fused-prologue
    ``linear_fn``; the plain step (norm, quantize, linear, and the MoE MLP of
    ``models/moe.py`` for ``cfg.num_experts > 0``) for a stacked or unstacked
    ``linear_fn`` over unfused or fused params. ``attention_fn`` defaults to
    the flash prefill kernel for chunks of 128 tokens or more whose table
    width times the page size plus S is a multiple of 128 (the reference's
    condition), to the flash decode kernel at S == 1 when ``flash_decode``
    is set, and to the plain dual-layout attention otherwise; ``kv_write``
    defaults to the in-place writer kernel. Each wrapper runs its plain
    version on CPU tensors, and the plain functions can be passed explicitly
    to run the plain path on the card.
    """
    stack = params["layers"]
    fused = "qkv_qw" in stack
    if linear_fn is None:
        linear_fn = make_linear_fused() if "gateup_qw" in stack else make_linear_stacked()
    lf = linear_fn
    write = kv_write or kv_write_kernel
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

    hidden = params["embed"][tokens.long()].to(dtype)
    positions = seq_lens[:, None] + torch.arange(S, device=dev)[None, :]  # [B,S]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, dtype)

    if attention_fn is not None:
        attn_impl = attention_fn
    elif S == 1 and flash_decode:
        attn_impl = _paged_attention_dual_flash_decode
    else:
        # the reference's condition (its kernel path, kv_write="pallas"): the
        # flash prefill only where the table's tokens plus the chunk fill
        # whole 128-token tiles; the two paths round attention differently
        hist_tokens = page_table.shape[1] * ps
        use_flash = S >= 128 and (hist_tokens + S) % 128 == 0
        attn_impl = _paged_attention_dual_flash if use_flash else _paged_attention_dual

    # this batch's staging pages, gathered once for all layers
    staging_b = pools.staging[:B] if slot_ids is None else pools.staging[slot_ids.long()]
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
        attn = attn_impl(q, k, v, pools.kv, staging_b, l, page_table, seq_lens, new_lens, cfg)
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

    # each token's full contribution as one row [2L, KV*D] (k-layers, v-layers)
    kv_new = torch.stack(ks + vs, dim=2)  # [B, S, 2L, KV, D]
    vals = quantize_kv(kv_new, pools.kv_dtype_name).reshape(B, S, 2 * L, kvd)
    new_pools = _dual_write(pools, vals, page_table, seq_lens, new_lens, slot_ids, write)

    hidden = rms_norm(hidden, params["final_norm"], eps)
    last_idx = torch.clamp(new_lens - 1, 0, S - 1).long()
    hidden = hidden.gather(1, last_idx[:, None, None].expand(B, 1, hidden.shape[-1]))[:, 0]
    return compute_logits(hidden, params, cfg), new_pools
