"""Model-directory validation.

Counterpart of ``wrinklefree_tpu/convert/validate.py``: check that a model
directory is a loadable ternary checkpoint (config present, every
projection either packed (qweight + scale) or ternary float, shapes
consistent with the config, packed payloads unpack to ternary values).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from ..config import BitNetConfig
from ..models.loader import PROJS, _load_safetensors_dir
from ..ops.ternary import unpack_ternary_np
from .convert import _is_ternary_float


def validate_model(model_path: str | Path) -> Dict:
    """Returns {"valid": bool, "errors": [...], "packed": n, "float_ternary": n}.

    Never raises on content problems: it collects them.
    """
    errors: List[str] = []
    path = Path(model_path)
    report = {"valid": False, "errors": errors, "packed": 0, "float_ternary": 0}

    if not (path / "config.json").exists():
        errors.append("missing config.json")
        return report
    try:
        cfg = BitNetConfig.from_hf_config(path)
    except Exception as e:
        errors.append(f"bad config.json: {e}")
        return report
    try:
        tensors = _load_safetensors_dir(path)
    except Exception as e:
        errors.append(str(e))
        return report

    dims = {
        "q": (cfg.hidden_size, cfg.q_dim),
        "k": (cfg.hidden_size, cfg.kv_dim),
        "v": (cfg.hidden_size, cfg.kv_dim),
        "o": (cfg.q_dim, cfg.hidden_size),
        "gate": (cfg.hidden_size, cfg.intermediate_size),
        "up": (cfg.hidden_size, cfg.intermediate_size),
        "down": (cfg.intermediate_size, cfg.hidden_size),
    }
    for layer in range(cfg.num_layers):
        for short, sub in PROJS.items():
            base = f"model.layers.{layer}.{sub}"
            K, N = dims[short]
            if f"{base}.qweight" in tensors:
                qw = tensors[f"{base}.qweight"]
                if qw.shape != (K // 4, N):
                    errors.append(f"{base}.qweight shape {qw.shape} != {(K//4, N)}")
                elif f"{base}.weight_scale" not in tensors:
                    errors.append(f"{base}: qweight without weight_scale")
                else:
                    tern = unpack_ternary_np(qw)
                    if not (np.abs(tern) <= 1).all():
                        errors.append(f"{base}: non-ternary values after unpack")
                    report["packed"] += 1
            elif f"{base}.weight" in tensors:
                w = tensors[f"{base}.weight"]
                if w.dtype == np.uint8:
                    if w.shape != (N // 4, K):
                        errors.append(f"{base}.weight (HF packed) shape {w.shape}")
                    report["packed"] += 1
                elif _is_ternary_float(w):
                    if w.shape != (N, K):
                        errors.append(f"{base}.weight shape {w.shape} != {(N, K)}")
                    report["float_ternary"] += 1
                else:
                    errors.append(f"{base}.weight is dense float (not ternary); "
                                  "run convert --ternarize")
            else:
                errors.append(f"missing projection: {base}")
    if "model.embed_tokens.weight" not in tensors:
        errors.append("missing model.embed_tokens.weight")
    if not cfg.tie_word_embeddings and "lm_head.weight" not in tensors:
        errors.append("untied model missing lm_head.weight")

    report["valid"] = not errors
    return report
