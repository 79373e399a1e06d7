"""Offline model conversion: HF checkpoint -> the packed cache.

Counterpart of ``wrinklefree_tpu/convert/convert.py``, writing the same
files: every ternary projection packed to the plane-major layout
(``*.qweight`` uint8 ``[in/4, out]`` + ``*.weight_scale``), config and
tokenizer files copied, ``cache_metadata.json`` written, other tensors
copied as they are (dtype included: ``BF16`` stays ``BF16``, ``U16`` stays
``U16``). ``ternarize=True`` converts a dense float model to ternary
(``round(clip(w / mean|w|))``). Files are read and written with
``safetensors_io``; ``huggingface_hub`` is imported only to fetch a hub id
that is not a local path.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.ternary import hf_packed_to_wf, pack_ternary_np, quantize_weights_ternary
from .cache_key import PACK_FORMAT
from .safetensors_io import load_file, save_file
from .safetensors_io import to_float as _to_float

logger = logging.getLogger(__name__)

TERNARY_PROJ_SUFFIXES = (
    "q_proj.weight",
    "k_proj.weight",
    "v_proj.weight",
    "o_proj.weight",
    "gate_proj.weight",
    "up_proj.weight",
    "down_proj.weight",
)

CONFIG_FILES = (
    "config.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "tokenizer.model",
    "generation_config.json",
)


def _is_ternary_float(w: np.ndarray) -> bool:
    if w.ndim != 2 or w.shape[0] % 4 != 0:
        return False
    wf = _to_float(w)
    r = np.rint(wf)
    return bool(np.abs(r).max() <= 1.0 and np.abs(wf - r).max() < 1e-3)


def convert_and_save(
    source_model_path: str,
    output_path: str | Path,
    revision: Optional[str] = None,
    ternarize: bool = False,
) -> Path:
    """Convert a model directory (or HF hub id) to a packed cache dir."""
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)

    src = Path(source_model_path)
    if not src.exists():
        from huggingface_hub import snapshot_download

        src = Path(
            snapshot_download(
                source_model_path,
                revision=revision,
                allow_patterns=["*.safetensors", "*.json", "*.txt", "*.model"],
            )
        )

    for name in CONFIG_FILES:
        f = src / name
        if f.exists():
            shutil.copy(f, output_path / name)

    n_packed = 0
    for wf_file in sorted(src.glob("*.safetensors")):
        out_tensors = {}
        tensors = load_file(wf_file)
        keys = list(tensors)
        for name in keys:
            t = tensors[name]
            base = name[: -len(".weight")] if name.endswith(".weight") else name
            is_proj = any(name.endswith(s) for s in TERNARY_PROJ_SUFFIXES)
            scale_name = f"{base}.weight_scale"

            if is_proj and t.dtype == np.uint8:
                # HF-packed ternary [out/4, in] -> [in/4, out]
                out_tensors[f"{base}.qweight"] = hf_packed_to_wf(t)
                n_packed += 1
            elif is_proj and _is_ternary_float(t):
                out_tensors[f"{base}.qweight"] = pack_ternary_np(_to_float(t).T)
                if scale_name not in keys:
                    out_tensors[scale_name] = np.asarray([1.0], np.float32)
                n_packed += 1
            elif is_proj and ternarize and t.dtype != np.uint8:
                tern, scale = quantize_weights_ternary(_to_float(t))
                out_tensors[f"{base}.qweight"] = pack_ternary_np(tern.T)
                out_tensors[scale_name] = np.asarray([scale], np.float32)
                n_packed += 1
            elif name.endswith(".weight_scale"):
                out_tensors[name] = _to_float(t).reshape(-1)[:1]
            else:
                out_tensors[name] = t
        out_file = output_path / wf_file.name
        save_file(out_tensors, out_file)
        logger.info("wrote %s", out_file)

    meta = {
        "format_version": PACK_FORMAT,
        "source_model": str(source_model_path),
        "revision": revision,
        "ternarized": ternarize,
        "packed_tensors": n_packed,
    }
    (output_path / "cache_metadata.json").write_text(json.dumps(meta, indent=2))
    return output_path
