"""BitNet b1.58 parameters and head (PyTorch port).

Counterpart of the parameter half of ``wrinklefree_tpu/models/bitnet.py``:
embed -> N x { RMSNorm, GQA attention (RoPE), attn_sub_norm before o_proj,
residual, RMSNorm, ReLU^2-gated MLP with ffn_sub_norm before down_proj,
residual } -> final RMSNorm -> tied-embedding logits. Params are a dict of
tensors with per-layer arrays stacked on a leading [L] axis, under the
reference's key names. The paged forward lives in ``kv/paged.py``; the
batch-1 dense-cache ``forward`` is not ported yet.
"""

from __future__ import annotations

import torch

from ..config import BitNetConfig
from ..ops.ternary import ternary_linear


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller names another
    device; asking for CUDA on a host without it raises (no silent CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain path on the CPU")
    return dev


def default_linear(x, qweight, scale, out_dtype=torch.bfloat16):
    """Unfused exact linear (quantize, integer dot, rescale)."""
    return ternary_linear(x, qweight, scale, out_dtype=out_dtype)


def init_params(cfg: BitNetConfig, seed: int = 0, device=None, dtype=None):
    """Random ternary model drawn on ``device`` (default CUDA) from a seeded
    ``torch.Generator``: uniform ternary codes packed in the wf format,
    per-layer scales 50.0, unit norms and N(0, 0.02) embeddings. The analog
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
    layers = {}
    for name, (kk, nn) in dims.items():
        qw = torch.zeros((L, kk // 4, nn), dtype=torch.uint8, device=dev)
        for j in range(4):
            enc = torch.randint(0, 3, (L, kk // 4, nn), generator=g, device=dev,
                                dtype=torch.uint8)
            qw |= enc << (2 * j)
        layers[f"{name}_qw"] = qw
        layers[f"{name}_scale"] = torch.full((L,), 50.0, dtype=torch.float32, device=dev)
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


def compute_logits(hidden, params, cfg: BitNetConfig) -> torch.Tensor:
    """hidden [..., H] -> logits [..., V] f32 (int8 head when present)."""
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1]).to(cfg.dtype)
    if "lm_head_q" in params:
        logits = _head_matmul(h2, params["lm_head_q"].to(cfg.dtype)) * params["lm_head_s"]
    else:
        head = params["embed"] if cfg.tie_word_embeddings else params["lm_head"]
        logits = _head_matmul(h2, head)
    return logits.reshape(*lead, -1)


