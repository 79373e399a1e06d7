"""Load BitNet weights from safetensors directories into the port's params.

Counterpart of ``wrinklefree_tpu/models/loader.py``, for three on-disk
formats:

1. HF BitNet checkpoints: ``*.weight`` uint8 ``[out/4, in]`` + ``*.weight_scale``;
2. float ternary checkpoints (values round to {-1, 0, +1});
3. the packed cache (``convert.convert_and_save``): ``*.qweight`` uint8
   ``[in/4, out]`` + ``*.weight_scale``.

Every projection is repacked to the plane-major layout (one at a time, to
keep the host's temporaries small) and stacked on a leading ``[L]`` axis.
The result is the unfused params of ``models.bitnet.init_params``, equal
tensor for tensor to ``weights.params_from_numpy`` of the reference's
``load_params`` on the same directory; ``Engine`` fuses them itself. Files
are read with ``convert.safetensors_io`` (no ``safetensors`` package).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..config import BitNetConfig
from ..convert.safetensors_io import load_file
from ..convert.safetensors_io import to_float as _to_float
from ..ops.ternary import hf_packed_to_wf, pack_ternary_np
from .bitnet import resolve_device

logger = logging.getLogger(__name__)

PROJS = {
    "q": "self_attn.q_proj",
    "k": "self_attn.k_proj",
    "v": "self_attn.v_proj",
    "o": "self_attn.o_proj",
    "gate": "mlp.gate_proj",
    "up": "mlp.up_proj",
    "down": "mlp.down_proj",
}

NORMS = {
    "input_ln": "input_layernorm.weight",
    "post_ln": "post_attention_layernorm.weight",
    "attn_sub": "self_attn.attn_sub_norm.weight",
    "ffn_sub": "mlp.ffn_sub_norm.weight",
}


def _load_safetensors_dir(path: Path) -> Dict[str, np.ndarray]:
    tensors: Dict[str, np.ndarray] = {}
    files = sorted(Path(path).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    for f in files:
        tensors.update(load_file(f))
    return tensors


def _proj_to_wf(tensors: Dict[str, np.ndarray], base: str):
    """Return (qweight [K/4,N] uint8, weight_scale float32) for one proj."""
    if f"{base}.qweight" in tensors:  # packed cache
        return tensors[f"{base}.qweight"], np.float32(
            _to_float(tensors[f"{base}.weight_scale"]).reshape(-1)[0]
        )
    w = tensors[f"{base}.weight"]
    scale_t = tensors.get(f"{base}.weight_scale")
    scale = (np.float32(_to_float(scale_t).reshape(-1)[0]) if scale_t is not None
             else np.float32(1.0))
    if w.dtype == np.uint8:  # HF packed [out/4, in]
        return hf_packed_to_wf(w), scale
    # float ternary [out, in]
    return pack_ternary_np(_to_float(w).T), scale


def to_dtype(x: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A float array (f16/f32, or bf16 bits) as ``dtype`` on ``device``:
    widened to f32, then rounded half-to-even, as ``jnp.asarray(f32,
    dtype)`` rounds."""
    return torch.from_numpy(np.ascontiguousarray(_to_float(x))).to(dtype).to(device)


def load_params(model_path, cfg: BitNetConfig | None = None, device=None,
                dtype: torch.dtype = torch.bfloat16):
    """Load a model directory -> (params, config); params on ``device``
    (default CUDA; ``device="cpu"`` on a host without it)."""
    dev = resolve_device(device)
    path = Path(model_path)
    if cfg is None:
        cfg = BitNetConfig.from_hf_config(path)
    tensors = _load_safetensors_dir(path)

    L = cfg.num_layers
    sub_dims = {"attn_sub": cfg.q_dim, "ffn_sub": cfg.intermediate_size}
    stacked = {}
    for short, sub in NORMS.items():
        rows = []
        for i in range(L):
            key = f"model.layers.{i}.{sub}"
            if key not in tensors and short in sub_dims:
                # Llama-family ternary conversions have no sub-norms
                # (cfg.sub_norms False): placeholder ones keep the stacked
                # layer params uniform
                rows.append(np.ones((sub_dims[short],), np.float32))
            else:
                rows.append(_to_float(tensors[key]))
        stacked[short] = to_dtype(np.stack(rows), dtype, dev)
    for short, sub in PROJS.items():
        qw, scales = None, np.zeros((L,), np.float32)
        for i in range(L):
            q, scales[i] = _proj_to_wf(tensors, f"model.layers.{i}.{sub}")
            if qw is None:
                qw = np.empty((L,) + q.shape, np.uint8)
            qw[i] = q
        stacked[f"{short}_qw"] = torch.from_numpy(qw).to(dev)
        stacked[f"{short}_scale"] = torch.from_numpy(scales).to(dev)
        logger.info("loaded %s projections of %d layers", short, L)

    params = {
        "embed": to_dtype(tensors["model.embed_tokens.weight"], dtype, dev),
        "final_norm": to_dtype(tensors["model.norm.weight"], dtype, dev),
        "layers": stacked,
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in tensors:
        params["lm_head"] = to_dtype(tensors["lm_head.weight"], dtype, dev)
    return params, cfg


def load_tokenizer(model_path):
    """The model's HF tokenizer (``transformers.AutoTokenizer``). Raises
    ImportError where ``transformers`` is missing: a model that was asked to
    load never falls back to the byte tokenizer."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"loading the tokenizer of {model_path} needs the transformers package, "
            "which is not installed") from e
    return AutoTokenizer.from_pretrained(str(model_path))
