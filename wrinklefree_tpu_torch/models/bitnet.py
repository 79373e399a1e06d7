"""BitNet b1.58 model (PyTorch port).

Counterpart of ``wrinklefree_tpu/models/bitnet.py``: embed -> N x {
RMSNorm, GQA attention (RoPE), attn_sub_norm before o_proj, residual,
RMSNorm, ReLU^2-gated MLP with ffn_sub_norm before down_proj, residual } ->
final RMSNorm -> tied-embedding logits. Params are a dict of tensors with
per-layer arrays stacked on a leading [L] axis, under the reference's key
names. This module holds the parameters, the heads and the dense-cache
``forward``/``generate`` (batch-1 decode runs two kernels per layer, or one
with the layer megakernel, or two on each layer's views after
``split_layers_for_decode``); the paged forward of the serving engine lives
in ``kv/paged.py``.

MoE layers (``cfg.num_experts > 0``) run the plain layer step with the
expert MLP of ``models/moe.py``. ``forward`` takes the reference's
activation and attention sparsity policies (``ops/activation_sparsity.py``,
``ops/sparse_attention.py``). With ``tp_axis`` (a
``parallel.sharding.Axis``) ``forward`` is one rank's program of the
tensor-parallel model (``parallel/sharding.py``'s layout), as the
reference's is inside ``shard_map``; MoE experts are then sharded on the
same axis (expert parallelism).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import BitNetConfig
from ..ops.activation_sparsity import make_sparse_linear_fn
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_cos_sin
from ..ops.sparse_attention import apply_attention_sparsity, create_window_mask
from ..ops.ternary import ternary_linear


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller names another
    device; asking for CUDA on a host without it raises (no silent CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain path on the CPU")
    return dev


def default_linear(x, qweight, scale, out_dtype=torch.bfloat16, quant_axis=None):
    """Unfused exact linear (quantize, integer dot, rescale)."""
    return ternary_linear(x, qweight, scale, out_dtype=out_dtype, quant_axis=quant_axis)


class KVCache(NamedTuple):
    """Contiguous per-layer KV cache [L, B, T, KV, D], or at batch 1 the flat
    [L*T*KV, D] form of the same bytes (``flatten_cache_for_decode``)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg: BitNetConfig, batch: int, max_len: int, dtype=None, device=None):
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        dtype = cfg.dtype if dtype is None else dtype
        dev = resolve_device(device)
        return cls(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))


def flatten_cache_for_decode(cache: KVCache) -> KVCache:
    """The flat [L*T*KV, D] row form of a batch-1 cache.

    On the card this is a view (``reshape`` of a contiguous tensor): the
    reference's one-time relayout copy, forced there by the TPU's tile
    padding of KV = 5 to 8, does not exist here, so the flat and the 5-D
    cache are the same bytes and ``forward`` takes either."""
    L, B, T, KV, D = cache.k.shape
    if B != 1:
        raise ValueError("the flat decode cache is batch-1 only")
    return KVCache(cache.k.reshape(L * T * KV, D), cache.v.reshape(L * T * KV, D))


def init_params(cfg: BitNetConfig, seed: int = 0, device=None, dtype=None):
    """Random ternary model drawn on ``device`` (default CUDA) from a seeded
    ``torch.Generator``: uniform ternary codes packed in the wf format,
    per-layer scales 50.0, unit norms and N(0, 0.02) embeddings; with
    ``cfg.num_experts > 0`` the dense MLP gives way to expert stacks
    ``moe_{gate,up,down}_qw`` [L, E, K/4, N] with scales [L, E] of 50.0 and
    an N(0, 0.02) f32 router [L, H, E]. The analog
    of the reference's on-device init; the values differ from the
    reference's, whose random streams torch cannot reproduce (tests carry
    the reference's weights over with ``weights.params_from_numpy``)."""
    dev = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    H, I, Q, KV = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, cfg.kv_dim
    L = cfg.num_layers
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dims = {
        "q": (H, Q), "k": (H, KV), "v": (H, KV), "o": (Q, H),
        "gate": (H, I), "up": (H, I), "down": (I, H),
    }
    E = cfg.num_experts

    def packed(lead, kk, nn):
        qw = torch.zeros(lead + (kk // 4, nn), dtype=torch.uint8, device=dev)
        for j in range(4):
            enc = torch.randint(0, 3, qw.shape, generator=g, device=dev, dtype=torch.uint8)
            qw |= enc << (2 * j)
        return qw

    layers = {}
    for name, (kk, nn) in dims.items():
        if E > 0 and name in ("gate", "up", "down"):
            # MoE: per-layer expert stacks [L, E, ...] replace the dense MLP
            layers[f"moe_{name}_qw"] = packed((L, E), kk, nn)
            layers[f"moe_{name}_scale"] = torch.full((L, E), 50.0, dtype=torch.float32,
                                                     device=dev)
            continue
        layers[f"{name}_qw"] = packed((L,), kk, nn)
        layers[f"{name}_scale"] = torch.full((L,), 50.0, dtype=torch.float32, device=dev)
    if E > 0:
        layers["router"] = torch.randn((L, H, E), generator=g, device=dev,
                                       dtype=torch.float32) * 0.02
    layers["input_ln"] = torch.ones((L, H), dtype=dtype, device=dev)
    layers["post_ln"] = torch.ones((L, H), dtype=dtype, device=dev)
    layers["attn_sub"] = torch.ones((L, Q), dtype=dtype, device=dev)
    layers["ffn_sub"] = torch.ones((L, I), dtype=dtype, device=dev)

    def rand_embed():
        e = torch.randn((cfg.vocab_size, H), generator=g, device=dev, dtype=torch.float32)
        return (e * 0.02).to(dtype)

    params = {
        "embed": rand_embed(),
        "final_norm": torch.ones((H,), dtype=dtype, device=dev),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = rand_embed()
    return params


def fuse_projections(params, cfg: BitNetConfig):
    """Concat q/k/v and gate/up weight stacks along N: 7 -> 4 linears per
    layer. Per-tensor scales become per-column scale rows ([L, N] f32) so
    each segment keeps its own scale in one call. Replaces the q/k/v and
    gate/up entries with "qkv_qw"/"qkv_scale" and "gateup_qw"/"gateup_scale"."""
    layers = dict(params["layers"])

    def fuse(names, out_name):
        qws = [layers.pop(f"{nm}_qw") for nm in names]
        scs = [layers.pop(f"{nm}_scale") for nm in names]
        layers[f"{out_name}_qw"] = torch.cat(qws, dim=-1)
        layers[f"{out_name}_scale"] = torch.cat(
            [s.float()[:, None].expand(-1, w.shape[-1]) for s, w in zip(scs, qws)], dim=-1
        ).contiguous()

    fuse(("q", "k", "v"), "qkv")
    if "gate_qw" in layers:
        fuse(("gate", "up"), "gateup")
    return {**params, "layers": layers}


def split_layers_for_decode(params, cfg: BitNetConfig):
    """Per-layer entries for the unrolled batch-1 decode path: adds
    ``params["layers_split"]``, a tuple of one dict per layer under the
    reference's keys (``qkv_qw``, ``o_qw``, ``gateup_qw``, ``down_qw``, their
    ``*_scale``, ``input_ln``, ``post_ln`` and, with sub-norms, ``attn_sub``
    and ``ffn_sub``). Requires ``fuse_projections``.

    The reference copies the packed weights once (~0.5 GB at 2B) and
    broadcasts scales and norms to 8 f32 rows, the TPU's tile; it does so
    to make every index map of its kernels static, which the TPU's
    scalar-prefetch grid made costly. On the card the layer is a pointer:
    the entries are views of ``params["layers"]`` (no copy), the weight
    scale of a layer one value (``o``, ``down``) or its column scales
    (``qkv``, ``gateup``), norms their bf16 rows."""
    stack = params["layers"]
    if "qkv_qw" not in stack or "gateup_qw" not in stack:
        raise ValueError("split_layers_for_decode requires fuse_projections")
    names = ["qkv", "o", "gateup", "down"]
    norms = ["input_ln", "post_ln"] + (["attn_sub", "ffn_sub"] if cfg.sub_norms else [])
    split = tuple(
        {**{f"{n}_{kind}": stack[f"{n}_{kind}"][l] for n in names for kind in ("qw", "scale")},
         **{n: stack[n][l] for n in norms}}
        for l in range(stack["o_qw"].shape[0]))
    return {**params, "layers_split": split}


def quantize_lm_head(params, cfg: BitNetConfig):
    """int8 per-row quantization of the output head (approximate): adds
    ``lm_head_q`` (int8) and ``lm_head_s`` ([V] f32), which
    ``compute_logits`` then prefers."""
    head = params["embed"] if cfg.tie_word_embeddings else params["lm_head"]
    hf = head.float()
    absmax = hf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)
    q = torch.round(hf / absmax * 127.0).clamp(-127, 127).to(torch.int8)
    out = dict(params)
    out["lm_head_q"] = q
    out["lm_head_s"] = (absmax[:, 0] / 127.0).float()
    return out


def _head_matmul(hidden: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """hidden [B, H] x head [V, H]^T -> f32 logits with f32 accumulation.
    On the card this is cuBLAS's bf16 product with an f32 result; the CPU
    has no mixed-dtype product, so it multiplies f32 copies (the bf16
    values are exact in f32)."""
    if hidden.is_cuda:
        return torch.mm(hidden, head.t(), out_dtype=torch.float32)
    return hidden.float() @ head.float().t()


def compute_logits(hidden, params, cfg: BitNetConfig, tp_axis=None) -> torch.Tensor:
    """hidden [..., H] -> logits [..., V] f32 (int8 head when present). With
    ``tp_axis`` the head is vocab-sharded: the local [..., V/tp] logits are
    gathered along the vocabulary in rank order."""
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1]).to(cfg.dtype)
    if "lm_head_q" in params:
        logits = _head_matmul(h2, params["lm_head_q"].to(cfg.dtype)) * params["lm_head_s"]
    else:
        logits = _head_matmul(h2, _bf16_head(params, cfg))
    if tp_axis is not None:
        logits = tp_axis.all_gather(logits)
    return logits.reshape(*lead, -1)


def _bf16_head(params, cfg: BitNetConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_word_embeddings else params["lm_head"]


_SENT = torch.iinfo(torch.int32).max  # above every vocabulary id


def _tp_min_id(value, ids, tp_axis):
    """The lowest global id among the ranks whose ``value`` [B] is the
    maximum over the axis (the reference's pmax/pmin tie-break)."""
    g = tp_axis.pmax(value.clone())
    return tp_axis.pmin(torch.where(value >= g, ids, torch.full_like(ids, _SENT))), g


def exact_topk_shortlist(hidden, params, cfg: BitNetConfig, k: int = 128, tp_axis=None):
    """The exact head up to its branch: the int8 head scan, the exact bf16
    rescore of the top-k candidates and the certificate, with no host read
    (the reference's ``greedy_exact_topk`` up to its ``lax.cond``).

    The rescored winner is the lowest id among the exact maxima; it is the
    greedy token when ``certified``: ``exact_max > best_outside + eps`` for
    every row, with ``eps = 0.5*s_max*||h||_1 + 1e-3*(|exact_max| + 1)``.
    ``approx_max_k`` becomes ``torch.topk``.

    hidden: [B, H] post-final-norm. Returns (tokens [B] int32, certified
    0-d bool), both on hidden's device. Requires ``quantize_lm_head(params)``.

    With ``tp_axis`` (the head vocab-sharded, ``hidden`` the same on every
    rank) each rank scans and rescores its local rows; the winner, the bound
    outside the shortlist and the error scale are combined with pmax/pmin, as
    the reference's: the same token as one device (the lowest global id
    among the exact maxima)."""
    if "lm_head_q" not in params:
        raise ValueError("the exact head requires quantize_lm_head(params)")
    head = _bf16_head(params, cfg)
    h = hidden.to(cfg.dtype)
    approx = compute_logits(h, params, cfg)  # [B, V] int8 head (local rows under TP)
    cand = torch.topk(approx, k, dim=-1).indices  # [B, k]
    rows = head[cand].to(cfg.dtype)  # [B, k, H]
    # bf16 products are exact in f32; sums in f32
    exact = torch.einsum("bh,bkh->bk", h.float(), rows.float())
    m_out = approx.scatter(-1, cand, float("-inf")).amax(dim=-1)
    h1 = h.float().abs().sum(dim=-1)
    s_max = params["lm_head_s"].amax()
    exact_max = exact.amax(dim=-1)
    if tp_axis is not None:
        cand = cand + tp_axis.index * head.shape[0]  # global vocabulary ids
    minid = torch.where(exact >= exact_max[:, None], cand,
                        torch.full_like(cand, _SENT)).amin(dim=-1)
    if tp_axis is not None:
        minid, exact_max = _tp_min_id(exact_max, minid, tp_axis)
        m_out = tp_axis.pmax(m_out)
        s_max = tp_axis.pmax(s_max.reshape(1))[0]
    eps = 0.5 * s_max * h1 + 1e-3 * (exact_max.abs() + 1.0)
    return minid.to(torch.int32), (exact_max > m_out + eps).all()


def full_head_argmax(hidden, params, cfg: BitNetConfig, tp_axis=None) -> torch.Tensor:
    """The exact head's fallback branch (the reference's ``full_head``):
    argmax of the f32 product of hidden [B, H] with the bf16 head; tokens [B]
    int32 (the lowest id among equal maxima). With ``tp_axis`` each rank
    takes its local rows' argmax and the ranks combine them with pmax/pmin
    (the lowest global id among the maxima)."""
    h = hidden.to(cfg.dtype)
    head = _bf16_head(params, cfg)
    full = _head_matmul(h.reshape(-1, h.shape[-1]), head)
    if tp_axis is None:
        return torch.argmax(full, dim=-1).to(torch.int32)
    lmax = full.amax(dim=-1)
    lid = torch.argmax(full, dim=-1) + tp_axis.index * head.shape[0]
    return _tp_min_id(lmax, lid, tp_axis)[0].to(torch.int32)


def greedy_exact_topk(hidden, params, cfg: BitNetConfig, k: int = 128,
                      tp_axis: Optional[str] = None):
    """Greedy next token via the int8 head scan and an exact bf16 rescore of
    the top-k candidates, certified against the int8 error bound.

    Same contract as the reference: the rescored winner is taken when the
    certificate holds (``exact_topk_shortlist``); otherwise the full bf16
    head decides (``full_head_argmax``), so the token always equals
    ``argmax(compute_logits)`` of the bf16 head. The reference picks the
    branch on the device with ``lax.cond``; here the host reads the
    certificate, one device read per call, and runs the full head only when
    it failed (the captured decode window of ``bench.decode`` keeps that read
    out of the window and repairs after it).

    hidden: [B, H] post-final-norm. Returns (tokens [B] int32, certified
    0-d bool tensor). Requires ``quantize_lm_head(params)``. With ``tp_axis``
    (a ``parallel.sharding.Axis``; the head vocab-sharded) both branches
    combine the ranks' rows, as the reference's: the certificate is the same
    on every rank, so every rank takes the same branch."""
    minid, certified = exact_topk_shortlist(hidden, params, cfg, k, tp_axis=tp_axis)
    if bool(certified):  # the one host read
        return minid, certified
    return full_head_argmax(hidden, params, cfg, tp_axis=tp_axis), certified


# ---------------------------------------------------------------------------
# Forward pass over the dense cache
# ---------------------------------------------------------------------------


def _attention(q, k_cache, v_cache, q_pos, cfg: BitNetConfig, attn_sparsity=None):
    """GQA attention of q [B,S,NH,D] over cache [B,T,KV,D] (full history):
    key t is visible iff t <= q_pos. Scores and softmax in f32 (inputs are
    exact in f32), probabilities rounded to the cache dtype before PV.

    ``attn_sparsity`` (an ``AttentionSparsityConfig``), in the reference's
    order: the WINDOW mode's mask replaces the causal one before the softmax,
    the other modes sparsify the f32 probabilities after it, before their
    rounding to the cache dtype."""
    B, S, NH, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = NH // KV
    qg = q.reshape(B, S, KV, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k_cache.float())
    scores = scores * (1.0 / math.sqrt(D))
    if attn_sparsity is not None and attn_sparsity.mode == "window":
        mask = create_window_mask(q_pos, T, attn_sparsity.window_size,
                                  attn_sparsity.global_tokens,
                                  attn_sparsity.stride)[:, None, None]
    else:
        key_idx = torch.arange(T, device=q.device)
        mask = key_idx[None, None, None, None, :] <= q_pos[:, None, None, :, None]
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if attn_sparsity is not None:
        probs = apply_attention_sparsity(probs, attn_sparsity)
    probs = probs.to(v_cache.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs.float(), v_cache.float()).to(v_cache.dtype)
    return out.reshape(B, S, NH, D)


def tp_embed(embed, tokens, dtype, tp_axis=None):
    """The tokens' embedding rows in ``dtype``; with ``tp_axis`` the
    vocab-sharded lookup: each rank gathers the rows of its shard (zeros for
    the others' tokens) and the ranks sum them (exact: one rank holds each
    token)."""
    if tp_axis is None:
        return embed[tokens.long()].to(dtype)
    v_local = embed.shape[0]
    local = tokens.long() - tp_axis.index * v_local
    ok = (local >= 0) & (local < v_local)
    rows = embed[local.clamp(0, v_local - 1)].to(dtype)
    return tp_axis.psum(torch.where(ok[..., None], rows, torch.zeros_like(rows)))


def tp_sub_norm(x, weight, eps: float, full_dim: int, tp_axis=None):
    """``rms_norm`` over a feature axis of ``full_dim`` of which, with
    ``tp_axis``, each rank holds a slice (and its slice of ``weight``): the
    mean square is summed over the ranks in f32 before the normalization."""
    if tp_axis is None:
        return rms_norm(x, weight, eps)
    xf = x.float()
    var = tp_axis.psum((xf * xf).sum(dim=-1, keepdim=True)) / full_dim
    return (xf * (1.0 / torch.sqrt(var + eps))).to(x.dtype) * weight.to(x.dtype)


def row_parallel(wlin, x, l: int, name: str, dtype, tp_axis=None, **single):
    """The o/down linear ``wlin(x, l, name, ...)``: on one device with
    ``single``'s arguments; under TP the rank's f32 partial (its input
    quantized with the ranks' absmax), summed over the ranks in f32, then
    cast to ``dtype``."""
    if tp_axis is None:
        return wlin(x, l, name, **single)
    return tp_axis.psum(wlin(x, l, name, out_dtype=torch.float32,
                             quant_axis=tp_axis)).to(dtype)


def tp_local_kv_heads(cfg: BitNetConfig, tp_axis=None, tp_kv_replicated: bool = False) -> int:
    """KV heads of one rank's k/v and cache: all of them on one device or
    when replicated, else KV/tp."""
    if tp_axis is None or tp_kv_replicated:
        return cfg.num_kv_heads
    return cfg.num_kv_heads // tp_axis.size


def tp_scatter_heads(q, num_heads: int, tp_axis):
    """A rank's local query heads [B, S, NH/tp, D] placed at their offset in
    the full [B, S, NH, D] layout, zeros elsewhere (replicated KV: the grouped
    attention then maps each query head to its KV head as on one device);
    returns (the full q, a function that slices the local heads back out of
    an attention output [B, S, NH, D])."""
    B, S, nh, D = q.shape
    off = tp_axis.index * nh
    full = q.new_zeros((B, S, num_heads, D))
    full[:, :, off:off + nh] = q
    return full, lambda a: a.reshape(B, S, num_heads, D)[:, :, off:off + nh]


def forward(
    params,
    cfg: BitNetConfig,
    tokens: torch.Tensor,  # [B, S] int
    cache: KVCache,  # [L, B, T, KV, D], or flat [L*T*KV, D] at B = 1
    start_pos: torch.Tensor,  # [B] int: cache fill per sequence
    *,
    linear_fn=None,
    logits_all: bool = True,
    head_fn=None,  # (hidden [B, H], params) -> anything; replaces compute_logits
    tp_axis: Optional[str] = None,
    tp_kv_replicated: bool = False,
    act_sparsity=None,
    attn_sparsity=None,
):
    """Run S new tokens through the model, writing their k/v rows into the
    cache. Covers prefill (S = prompt length, start_pos = 0) and decode
    (S = 1). Returns (logits [B,S,V] f32 if ``logits_all`` else [B,V], or
    ``head_fn``'s result; the cache).

    The cache is updated in place and returned in the format it came in (the
    reference donates it and returns a new one). Three branches, as in the
    reference:

    - the plain layer step: ``linear_fn`` unfused (``default_linear``, the
      default) or stacked over fused projections;
    - the prologue branch: a fused-prologue ``linear_fn``
      (``ops.ternary_cuda.make_linear_fused``) runs norm, quant and dot in
      one call per linear, and the MLP block in one call at <= 8 rows;
    - the megakernel branch: at B = S = 1 with ``.attn_mega`` and
      ``.mlp_mega`` on ``linear_fn``, in the reference's order: the unrolled
      loop over ``params["layers_split"]`` (``split_layers_for_decode``) when
      ``linear_fn`` has ``.attn_mega_static`` and ``.mlp_mega_static``; else
      one ``.layer_mega`` call per layer when ``linear_fn`` has it; else two
      calls per layer (attention block, then MLP block). The attention block
      writes the cache row in place.

    The reference also gates the megakernel branch on the TPU's on-chip
    memory (``_auto_cache_ok``, ``attn_manual_tile``) and picks between
    attention-block kernels that compute the same function (its manual-DMA
    variants); the port always takes it at batch-1 decode with its one
    kernel per branch. That changes the choice of kernel, not the function
    computed. MoE params take the plain layer
    step, their MLP being ``models.moe.moe_ffn`` (the megakernel branch is
    dense-only, as in the reference).

    ``act_sparsity`` (an ``ActivationSparsityConfig``) wraps the linear with
    ``make_sparse_linear_fn``: a plain function, so the layers take the plain
    step, and fused params raise ``ValueError`` there, as in the reference;
    run it on unfused params with an unstacked linear (``default_linear``, or
    ``ops.ternary_cuda.make_linear()``, K7). ``attn_sparsity`` reaches the
    attention of the prologue and plain steps; the megakernel branch (B = S =
    1 with a fused-prologue linear) does not take it, as the reference's does
    not.

    With ``tp_axis`` (a ``parallel.sharding.Axis``) this is one rank's
    program of the tensor-parallel model, as the reference's inside
    ``shard_map``: ``params`` and ``cache`` are the rank's shards
    (``parallel.sharding.shard_params``; the cache holds the local KV heads,
    or all of them with ``tp_kv_replicated``), q/k/v/gate/up are
    column-parallel, o/down row-parallel (their input quantized with the
    absmax reduced over the ranks, their f32 partials summed), the embedding
    lookup and the logits vocab-sharded (summed, gathered), the sub-norms'
    mean squares summed over the ranks in f32; MoE experts are sharded on
    the same axis. It takes the plain layer step: a fused-prologue
    ``linear_fn`` raises ``ValueError``.
    """
    if tp_axis is None and tp_kv_replicated:
        raise ValueError("tp_kv_replicated needs a tp_axis")
    if tp_axis is not None and getattr(linear_fn, "prologue", False):
        raise ValueError("tensor parallelism takes an unfused plain or stacked linear_fn, "
                         "not a fused-prologue one")
    lf = linear_fn or default_linear
    if act_sparsity is not None:
        lf = make_sparse_linear_fn(lf, act_sparsity)
    B, S = tokens.shape
    dtype = cfg.dtype
    dev = tokens.device
    stack = params["layers"]
    L = stack["o_qw"].shape[0]
    KV, D = tp_local_kv_heads(cfg, tp_axis, tp_kv_replicated), cfg.head_dim
    eps = cfg.rms_norm_eps
    mlp_act = "silu" if cfg.mlp_act == "silu" else "relu2"

    flat_cache = cache.k.dim() == 2
    T = cache.k.shape[0] // (L * KV) if flat_cache else cache.k.shape[2]
    ck5 = cache.k.view(L, 1, T, KV, D) if flat_cache else cache.k
    cv5 = cache.v.view(L, 1, T, KV, D) if flat_cache else cache.v

    start_pos = start_pos.to(device=dev, dtype=torch.int32)
    hidden = tp_embed(params["embed"], tokens, dtype, tp_axis)  # [B, S, H]
    positions = start_pos[:, None] + torch.arange(S, device=dev, dtype=torch.int32)[None, :]
    cos, sin = rope_cos_sin(positions, D, cfg.rope_theta, dtype)

    stacked = getattr(lf, "stacked", False)
    fused = "qkv_qw" in stack
    if fused and not stacked:
        raise ValueError("fused projections require a stacked linear_fn")
    prologue = fused and "gateup_qw" in stack and getattr(lf, "prologue", False)
    if getattr(lf, "prologue", False) and not prologue:
        raise ValueError("a fused-prologue linear_fn needs fused q/k/v and gate/up params "
                         "(fuse_projections of a dense model)")
    attn_mega = getattr(lf, "attn_mega", None) if prologue else None
    mlp_mega = getattr(lf, "mlp_mega", None) if prologue else None

    def plf(x, name, l, norm_name=None, act="none"):
        nw = stack[norm_name] if norm_name is not None else None
        return lf(x, stack[name + "_qw"], stack[name + "_scale"], l, nw, act=act,
                  norm=norm_name is not None, eps=eps)

    def wlin(x, l, name, **kw):
        if stacked:
            return lf(x, stack[name + "_qw"], stack[name + "_scale"], l, **kw)
        kw.setdefault("out_dtype", dtype)
        return lf(x, stack[name + "_qw"][l], stack[name + "_scale"][l], **kw)

    def split_qkv(qkv):
        qd = qkv.shape[-1] - 2 * KV * D
        return (qkv[..., :qd].reshape(B, S, -1, D),
                qkv[..., qd:qd + KV * D].reshape(B, S, KV, D),
                qkv[..., qd + KV * D:].reshape(B, S, KV, D))

    def write_cache(l, k, v):
        b_idx = torch.arange(B, device=dev)[:, None].expand(B, S)
        ck5[l].index_put_((b_idx, positions.long()), k.to(ck5.dtype))
        cv5[l].index_put_((b_idx, positions.long()), v.to(cv5.dtype))

    def layer_step(h, l):
        if prologue:
            q, k, v = split_qkv(plf(h, "qkv", l, "input_ln"))
            q, k = apply_rope(q, k, cos, sin)
            write_cache(l, k, v)
            attn = _attention(q, ck5[l], cv5[l], positions, cfg, attn_sparsity).reshape(B, S, -1)
            h = h + plf(attn, "o", l, "attn_sub" if cfg.sub_norms else None)
            if mlp_mega is not None and B * S <= 8:
                return mlp_mega(
                    h, stack["gateup_qw"], stack["down_qw"], l, stack["gateup_scale"],
                    stack["down_scale"], stack["post_ln"],
                    stack["ffn_sub"] if cfg.sub_norms else None,
                    eps=eps, act=mlp_act, norm2=cfg.sub_norms)
            gu = plf(h, "gateup", l, "post_ln")
            return h + plf(gu, "down", l, "ffn_sub" if cfg.sub_norms else None, act=mlp_act)

        normed = rms_norm(h, stack["input_ln"][l], eps)
        if fused:
            q, k, v = split_qkv(wlin(normed, l, "qkv"))
        else:
            q = wlin(normed, l, "q").reshape(B, S, -1, D)
            k = wlin(normed, l, "k").reshape(B, S, -1, D)
            v = wlin(normed, l, "v").reshape(B, S, -1, D)
        q, k = apply_rope(q, k, cos, sin)
        write_cache(l, k, v)
        local_heads = None
        if tp_axis is not None and tp_kv_replicated:
            q, local_heads = tp_scatter_heads(q, cfg.num_heads, tp_axis)
        attn = _attention(q, ck5[l], cv5[l], positions, cfg, attn_sparsity)
        if local_heads is not None:
            attn = local_heads(attn)
        attn = attn.reshape(B, S, -1)
        if cfg.sub_norms:
            attn = tp_sub_norm(attn, stack["attn_sub"][l], eps, cfg.q_dim, tp_axis)
        h = h + row_parallel(wlin, attn, l, "o", dtype, tp_axis, out_dtype=dtype).to(dtype)
        normed = rms_norm(h, stack["post_ln"][l], eps)
        if cfg.num_experts > 0:
            # MoE MLP: ternary experts, top-k routing (models/moe.py); under
            # TP the model axis doubles as the expert axis
            from .moe import expert_linear, moe_layer

            y = moe_layer(normed.reshape(B * S, -1), stack, l, cfg, expert_linear(lf),
                          ep_axis=tp_axis)
            return h + y.reshape(B, S, -1).to(dtype)
        if fused and "gateup_qw" in stack:
            gu = wlin(normed, l, "gateup")
            inter = gu.shape[-1] // 2
            gate, up = gu[..., :inter], gu[..., inter:]
        else:
            gate = wlin(normed, l, "gate")
            up = wlin(normed, l, "up")
        if cfg.mlp_act == "silu":
            act = torch.nn.functional.silu(gate) * up
        else:
            act = torch.square(torch.relu(gate)) * up
        if cfg.sub_norms:
            act = tp_sub_norm(act, stack["ffn_sub"][l], eps, cfg.intermediate_size, tp_axis)
        return h + row_parallel(wlin, act, l, "down", dtype, tp_axis,
                                out_dtype=dtype).to(dtype)

    if attn_mega is not None and mlp_mega is not None and B == 1 and S == 1:
        h2 = hidden.reshape(B, -1)
        cos1, sin1 = cos.reshape(D), sin.reshape(D)
        heads = dict(q_dim=cfg.q_dim, n_kv=KV, n_heads=cfg.num_heads, head_dim=D, eps=eps)
        attn_sub = stack["attn_sub"] if cfg.sub_norms else None
        ffn_sub = stack["ffn_sub"] if cfg.sub_norms else None
        split = params.get("layers_split")
        attn_static = getattr(lf, "attn_mega_static", None)
        mlp_static = getattr(lf, "mlp_mega_static", None)
        layer_mega = getattr(lf, "layer_mega", None)
        if split is not None and attn_static is not None and mlp_static is not None:
            if len(split) != L:
                raise ValueError(f"layers_split holds {len(split)} layers, the stack {L}")
            for l, sl in enumerate(split):
                h2, _, _ = attn_static(
                    h2, ck5[l], cv5[l], sl["qkv_qw"], sl["o_qw"], start_pos, sl["qkv_scale"],
                    sl["o_scale"], sl["input_ln"], sl.get("attn_sub"), cos1, sin1,
                    norm2=cfg.sub_norms, **heads)
                h2 = mlp_static(
                    h2, sl["gateup_qw"], sl["down_qw"], sl["gateup_scale"], sl["down_scale"],
                    sl["post_ln"], sl.get("ffn_sub"), eps=eps, act=mlp_act, norm2=cfg.sub_norms)
        elif layer_mega is not None:
            for l in range(L):
                h2, _, _ = layer_mega(
                    h2, cache.k, cache.v, stack["qkv_qw"], stack["o_qw"], stack["gateup_qw"],
                    stack["down_qw"], l, start_pos, stack["qkv_scale"], stack["o_scale"],
                    stack["gateup_scale"], stack["down_scale"], stack["input_ln"], attn_sub,
                    stack["post_ln"], ffn_sub, cos1, sin1, act=mlp_act, norm2=cfg.sub_norms,
                    **heads)
        else:
            for l in range(L):
                h2, _, _ = attn_mega(
                    h2, cache.k, cache.v, stack["qkv_qw"], stack["o_qw"], l, start_pos,
                    stack["qkv_scale"], stack["o_scale"], stack["input_ln"], attn_sub, cos1,
                    sin1, norm2=cfg.sub_norms, **heads)
                h2 = mlp_mega(
                    h2, stack["gateup_qw"], stack["down_qw"], l, stack["gateup_scale"],
                    stack["down_scale"], stack["post_ln"], ffn_sub,
                    eps=eps, act=mlp_act, norm2=cfg.sub_norms)
        hidden = h2.reshape(B, S, -1)
    else:
        for l in range(L):
            hidden = layer_step(hidden, l)

    hidden = rms_norm(hidden, params["final_norm"], eps)
    if not logits_all:
        hidden = hidden[:, -1]
    # under TP ``hidden`` is the same on every rank (the last row-parallel sum
    # ran inside the last layer), so a replicated head_fn sees one value
    out = (head_fn(hidden, params) if head_fn is not None
           else compute_logits(hidden, params, cfg, tp_axis=tp_axis))
    return out, KVCache(cache.k, cache.v)


# ---------------------------------------------------------------------------
# Simple generation loop (the serving path is the engine)
# ---------------------------------------------------------------------------


def generate(
    params,
    cfg: BitNetConfig,
    prompt_ids,
    max_new_tokens: int = 32,
    max_len: Optional[int] = None,
    temperature: float = 0.0,
    top_p: float = 1.0,
    seed: int = 0,
    device=None,
):
    """Greedy/sampled batch-1 generation with a contiguous KV cache and the
    default (plain) linear, as the reference's. Sampling draws the
    reference's stream: the key starts as ``PRNGKey(seed)`` and each token
    splits it (``ops.sampling.split_key``) and samples with the second half.
    ``device`` defaults to CUDA."""
    from ..ops.sampling import NUCLEUS_CANDIDATES, gumbel, sample_token, split_key

    dev = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt_ids, np.int64), device=dev)[None, :]
    T = max_len or min(cfg.max_position, prompt.shape[1] + max_new_tokens)
    # a multiple of 8, as the reference (its flat-cache TPU kernel writes
    # aligned 8-row groups)
    T = min(-(-T // 8) * 8, cfg.max_position)
    cache = KVCache.zeros(cfg, 1, T, cfg.dtype, device=dev)
    rng = torch.tensor([0, seed & 0xFFFFFFFF], dtype=torch.int64, device=dev)

    logits, cache = forward(params, cfg, prompt, cache,
                            torch.zeros(1, dtype=torch.int32, device=dev), logits_all=False)
    out = [int(t) for t in prompt_ids]
    pos = prompt.shape[1]
    c = min(NUCLEUS_CANDIDATES, cfg.vocab_size)

    def sample(logits, rng):
        rng, sub = split_key(rng)
        noise = gumbel(sub[None], c) if temperature > 0 else None
        return sample_token(logits, noise, temperature=temperature, top_p=top_p), rng

    tok, rng = sample(logits, rng)
    for _ in range(max_new_tokens):
        out.append(int(tok[0]))
        if pos + 1 >= T:
            break
        logits, cache = forward(params, cfg, tok[:, None], cache,
                                torch.full((1,), pos, dtype=torch.int32, device=dev),
                                logits_all=False)
        tok, rng = sample(logits, rng)
        pos += 1
    return out


