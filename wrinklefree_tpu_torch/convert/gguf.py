"""HF checkpoint -> GGUF export, the GGUF reader, and loading a GGUF model.

Counterpart of ``wrinklefree_tpu/convert/gguf.py``, writing and reading the
same files: a self-contained GGUF v3 writer/reader with llama.cpp tensor
naming (``token_embd``, ``blk.N.attn_q``, ...), for

- ``f32`` / ``f16``: dequantized export;
- ``i2_s``: BitNet.cpp's 2-bit ternary wire format (row-major
  ``[out, in//4]`` uint8, byte c = columns 4c..4c+3 encoded w+1, the first
  column in the top bits; ``ops.ternary.pack_i2s_np``) plus a per-tensor f32
  scale tensor ``<name>.scale``, under type id 36 and the
  ``bitnet.i2s_layout = "ggml"`` marker. An i2_s file without the marker
  carries the legacy plane-major payload, loaded as it is;
- ``tl1`` / ``tl2`` (type ids 31/32) and the I2_S id 30: the same 2-bit
  payload, loaded through the same byte spec.

Non-projection tensors of a ternary export are stored in f16, so a bf16
value below f16's normal range comes back rounded. ``load_params_gguf``
returns the port's unfused params and the config read from the metadata;
``tie_word_embeddings`` follows from the absence of ``output.weight``.
Tensor data is aligned to 32 (``general.alignment``). The reader takes
metadata of every GGUF value type, arrays included (a BitNet.cpp file's
vocabulary is one); the writer writes bool, u32, f32 and string values.
"""

from __future__ import annotations

import logging
import struct
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
ALIGNMENT = 32

# GGML tensor dtypes (ggml.h)
GGML_F32 = 0
GGML_F16 = 1
GGML_I8 = 24
GGML_I2_S = 36  # BitNet fork's 2-bit ternary id
# the BitNet quant-type family's enum (I2_S=30, TL1=31, TL2=32): all three
# carry the same 2-bit byte spec, dequantized alike
GGML_I2_S_REF = 30
GGML_TL1 = 31
GGML_TL2 = 32
_QUANT_TYPE_IDS = {"i2_s": GGML_I2_S, "tl1": GGML_TL1, "tl2": GGML_TL2}

# GGUF metadata value types
_U8, _I8T, _U16, _I16, _U32, _I32T, _F32T, _BOOL, _STR, _ARR, _U64, _I64, _F64 = range(13)
_SCALARS = {_U8: "<B", _I8T: "<b", _U16: "<H", _I16: "<h", _U32: "<I", _I32T: "<i",
            _F32T: "<f", _BOOL: "<?", _U64: "<Q", _I64: "<q", _F64: "<d"}


def _w_str(f, s: str):
    b = s.encode()
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _w_kv(f, key: str, val):
    _w_str(f, key)
    if isinstance(val, bool):
        f.write(struct.pack("<I", _BOOL) + struct.pack("<?", val))
    elif isinstance(val, int):
        f.write(struct.pack("<I", _U32) + struct.pack("<I", val))
    elif isinstance(val, float):
        f.write(struct.pack("<I", _F32T) + struct.pack("<f", val))
    elif isinstance(val, str):
        f.write(struct.pack("<I", _STR))
        _w_str(f, val)
    else:
        raise TypeError(f"unsupported metadata type for {key}: {type(val)}")


def _r_str(f) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode()


def _r_val(f, vt: int, key: str):
    if vt in _SCALARS:
        fmt = _SCALARS[vt]
        (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
        return v
    if vt == _STR:
        return _r_str(f)
    if vt == _ARR:  # element type, count, elements
        et, n = struct.unpack("<IQ", f.read(12))
        return [_r_val(f, et, key) for _ in range(n)]
    raise ValueError(f"unsupported GGUF metadata value type {vt} for {key}")


def _r_kv(f):
    key = _r_str(f)
    (vt,) = struct.unpack("<I", f.read(4))
    return key, _r_val(f, vt, key)


# llama.cpp tensor naming (what BitNet.cpp's GGUF models use)
_NAME_MAP = {
    "model.embed_tokens.weight": "token_embd.weight",
    "model.norm.weight": "output_norm.weight",
    "lm_head.weight": "output.weight",
}
_LAYER_MAP = {
    "self_attn.q_proj.weight": "attn_q.weight",
    "self_attn.k_proj.weight": "attn_k.weight",
    "self_attn.v_proj.weight": "attn_v.weight",
    "self_attn.o_proj.weight": "attn_output.weight",
    "mlp.gate_proj.weight": "ffn_gate.weight",
    "mlp.up_proj.weight": "ffn_up.weight",
    "mlp.down_proj.weight": "ffn_down.weight",
    "input_layernorm.weight": "attn_norm.weight",
    "post_attention_layernorm.weight": "ffn_norm.weight",
    "self_attn.attn_sub_norm.weight": "attn_sub_norm.weight",
    "mlp.ffn_sub_norm.weight": "ffn_sub_norm.weight",
}


def hf_name_to_gguf(name: str) -> Optional[str]:
    if name in _NAME_MAP:
        return _NAME_MAP[name]
    if name.startswith("model.layers."):
        rest = name[len("model.layers."):]
        idx, sub = rest.split(".", 1)
        mapped = _LAYER_MAP.get(sub)
        if mapped:
            return f"blk.{idx}.{mapped}"
    return None


def write_gguf(
    path: Path | str,
    metadata: Dict[str, object],
    tensors: Dict[str, Tuple[np.ndarray, int]],
) -> Path:
    """Write a GGUF v3 file. tensors: name -> (array, ggml_type).

    Arrays must already be in the on-disk dtype (f32/f16/uint8 for i2_s).
    GGUF dims are stored innermost-first (ne[0] = contiguous axis).
    """
    path = Path(path)
    with open(path, "wb") as f:
        f.write(GGUF_MAGIC)
        f.write(struct.pack("<I", GGUF_VERSION))
        f.write(struct.pack("<Q", len(tensors)))
        meta = {"general.alignment": ALIGNMENT, **metadata}
        f.write(struct.pack("<Q", len(meta)))
        for k, v in meta.items():
            _w_kv(f, k, v)

        # tensor infos
        offset = 0
        arrays = []
        for name, (arr, gtype) in tensors.items():
            arr = np.ascontiguousarray(arr)
            _w_str(f, name)
            dims = arr.shape[::-1]  # GGUF: innermost first
            f.write(struct.pack("<I", len(dims)))
            for d in dims:
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<I", gtype))
            f.write(struct.pack("<Q", offset))
            arrays.append(arr)
            offset += arr.nbytes + (-arr.nbytes) % ALIGNMENT

        # align data section start
        pos = f.tell()
        f.write(b"\x00" * ((-pos) % ALIGNMENT))
        for arr in arrays:
            if arr.size:
                f.write(arr.reshape(-1).view(np.uint8).data)
            f.write(b"\x00" * ((-arr.nbytes) % ALIGNMENT))
    return path


def read_gguf(path: Path | str):
    """Parse a GGUF file -> (metadata, {name: (array, ggml_type)}).

    Arrays are read-only views of a map of the file. i2_s tensors come back
    as their packed uint8 payload (pair with the ``<name>.scale`` f32
    tensor).
    """
    path = Path(path)
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError("Invalid GGUF magic")
        (version,) = struct.unpack("<I", f.read(4))
        if version != GGUF_VERSION:
            raise ValueError(f"unsupported GGUF version {version}")
        (n_tensors,) = struct.unpack("<Q", f.read(8))
        (n_kv,) = struct.unpack("<Q", f.read(8))
        metadata = dict(_r_kv(f) for _ in range(n_kv))

        infos = []
        for _ in range(n_tensors):
            name = _r_str(f)
            (n_dims,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
            gtype, = struct.unpack("<I", f.read(4))
            off, = struct.unpack("<Q", f.read(8))
            infos.append((name, dims[::-1], gtype, off))

        align = metadata.get("general.alignment", ALIGNMENT)
        pos = f.tell()
    data_start = pos + ((-pos) % align)

    dtypes = {GGML_F32: np.float32, GGML_F16: np.float16,
              GGML_I8: np.int8, GGML_I2_S: np.uint8,
              GGML_I2_S_REF: np.uint8, GGML_TL1: np.uint8,
              GGML_TL2: np.uint8}
    size = path.stat().st_size
    mm = np.memmap(path, dtype=np.uint8, mode="r") if size > data_start else None
    tensors = {}
    for name, shape, gtype, off in infos:
        dt = dtypes.get(gtype)
        if dt is None:
            raise ValueError(f"unsupported ggml type {gtype} for {name}")
        count = int(np.prod(shape)) if shape else 1
        nbytes = count * np.dtype(dt).itemsize
        if data_start + off + nbytes > size:
            raise ValueError(f"tensor {name} runs past the end of {path}")
        arr = (np.frombuffer(mm, dt, count=count, offset=data_start + off) if count
               else np.zeros((0,), dt))
        tensors[name] = (arr.reshape(shape), gtype)
    return metadata, tensors


def validate_gguf(path: Path | str, min_size_bytes: int = 1024) -> dict:
    """Existence / size / magic / header checks."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"GGUF file not found: {path}")
    size = path.stat().st_size
    if size < min_size_bytes:
        raise ValueError(f"GGUF file too small: {size} bytes")
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError("Invalid GGUF magic")
        (version,) = struct.unpack("<I", f.read(4))
        (n_tensors,) = struct.unpack("<Q", f.read(8))
    return {"size_bytes": size, "version": version, "n_tensors": n_tensors}


def convert_hf_to_gguf(
    model_dir: Path | str,
    output_path: Path | str,
    quant_type: str = "i2_s",
) -> Path:
    """Convert an HF or packed-cache model dir to one GGUF file.

    quant_type 'i2_s' / 'tl1' / 'tl2': ternary projections packed 2-bit
    (+ .scale tensors), other tensors f16; 'f16'/'f32': everything
    dequantized to float.
    """
    from ..config import BitNetConfig
    from ..models.loader import _load_safetensors_dir, _proj_to_wf, _to_float
    from ..ops.ternary import pack_i2s_np, unpack_ternary_np
    from .convert import TERNARY_PROJ_SUFFIXES

    model_dir = Path(model_dir)
    cfg = BitNetConfig.from_hf_config(model_dir)
    raw = _load_safetensors_dir(model_dir)

    meta = {
        "general.architecture": "bitnet" if cfg.sub_norms else "llama",
        "general.name": model_dir.name,
        "general.file_type": 1 if quant_type != "f32" else 0,
        "bitnet.quant_type": quant_type,
        # byte-layout marker: "ggml" = BitNet.cpp i2_s wire bytes (absence =
        # the legacy plane-major payload)
        "bitnet.i2s_layout": "ggml",
        "llama.context_length": cfg.max_position,
        "llama.embedding_length": cfg.hidden_size,
        "llama.block_count": cfg.num_layers,
        "llama.feed_forward_length": cfg.intermediate_size,
        "llama.attention.head_count": cfg.num_heads,
        "llama.attention.head_count_kv": cfg.num_kv_heads,
        "llama.attention.key_length": cfg.head_dim,
        "llama.rope.freq_base": float(cfg.rope_theta),
        "llama.attention.layer_norm_rms_epsilon": float(cfg.rms_norm_eps),
        "llama.vocab_size": cfg.vocab_size,
    }

    out: Dict[str, Tuple[np.ndarray, int]] = {}
    for name in sorted(raw):
        if name.endswith(".weight_scale"):
            continue  # handled with its projection below
        # a packed cache (convert_and_save) keeps a projection as .qweight;
        # it stands for the HF directory's .weight of the same projection
        if name.endswith(".qweight"):
            name = name[: -len(".qweight")] + ".weight"
        gname = hf_name_to_gguf(name)
        if gname is None:
            continue
        is_proj = any(name.endswith(s) for s in TERNARY_PROJ_SUFFIXES)
        if is_proj:
            base = name[: -len(".weight")]
            qw, scale = _proj_to_wf(raw, base)  # [K/4, N] packed, f32 scale
            if quant_type in _QUANT_TYPE_IDS:
                # plane-major -> BitNet wire bytes [N, K/4]; tl1/tl2 write
                # the same 2-bit payload under their own type ids
                out[gname] = (pack_i2s_np(unpack_ternary_np(qw).T),
                              _QUANT_TYPE_IDS[quant_type])
                out[gname + ".scale"] = (np.asarray([scale], np.float32), GGML_F32)
            else:
                tern = unpack_ternary_np(qw).astype(np.float32) / max(scale, 1e-9)
                w = tern.T  # [N, K] -> llama.cpp row-major [out, in]
                dt = np.float16 if quant_type == "f16" else np.float32
                out[gname] = (w.astype(dt), GGML_F16 if quant_type == "f16" else GGML_F32)
        else:
            w = _to_float(raw[name])
            if quant_type == "f32":
                out[gname] = (w.astype(np.float32), GGML_F32)
            else:
                out[gname] = (w.astype(np.float16), GGML_F16)

    path = write_gguf(output_path, meta, out)
    logger.info("wrote GGUF (%s, %d tensors): %s", quant_type, len(out), path)
    return path


# llama.cpp block-tensor naming -> loader shorts (inverse of _LAYER_MAP)
_GGUF_PROJS = {
    "q": "attn_q.weight", "k": "attn_k.weight", "v": "attn_v.weight",
    "o": "attn_output.weight", "gate": "ffn_gate.weight",
    "up": "ffn_up.weight", "down": "ffn_down.weight",
}
_GGUF_NORMS = {
    "input_ln": "attn_norm.weight", "post_ln": "ffn_norm.weight",
    "attn_sub": "attn_sub_norm.weight", "ffn_sub": "ffn_sub_norm.weight",
}


def load_params_gguf(path: Path | str, device=None, dtype=None):
    """Load an i2_s / tl1 / tl2 GGUF -> (params, BitNetConfig): the inverse
    of ``convert_hf_to_gguf``. Params on ``device`` (default CUDA)."""
    import torch

    from ..config import BitNetConfig
    from ..models.bitnet import resolve_device
    from ..models.loader import to_dtype
    from ..ops.ternary import pack_ternary_np, unpack_i2s_np

    dev = resolve_device(device)
    dtype = torch.bfloat16 if dtype is None else dtype
    meta, tensors = read_gguf(path)
    qt = meta.get("bitnet.quant_type", "i2_s")
    if qt not in ("i2_s", "tl1", "tl2"):
        raise ValueError(
            f"quant_type {qt!r} GGUF is not loadable; f16/f32 exports need the HF-dir "
            "path (convert + load_params). Supported: i2_s, tl1, tl2")
    n_heads = int(meta["llama.attention.head_count"])
    hidden = int(meta["llama.embedding_length"])
    vocab = int(meta["llama.vocab_size"])
    cfg = BitNetConfig(
        vocab_size=vocab,
        hidden_size=hidden,
        intermediate_size=int(meta["llama.feed_forward_length"]),
        num_layers=int(meta["llama.block_count"]),
        num_heads=n_heads,
        num_kv_heads=int(meta["llama.attention.head_count_kv"]),
        head_dim=int(meta.get("llama.attention.key_length", hidden // n_heads)),
        rms_norm_eps=float(meta["llama.attention.layer_norm_rms_epsilon"]),
        rope_theta=float(meta["llama.rope.freq_base"]),
        max_position=int(meta["llama.context_length"]),
        sub_norms=meta.get("general.architecture") == "bitnet",
        mlp_act="relu2" if meta.get("general.architecture") == "bitnet" else "silu",
        tie_word_embeddings="output.weight" not in tensors,
    )

    def arr(name):
        return tensors[name][0]

    L = cfg.num_layers
    stacked = {}
    norm_dims = {"input_ln": cfg.hidden_size, "post_ln": cfg.hidden_size,
                 "attn_sub": cfg.q_dim, "ffn_sub": cfg.intermediate_size}
    for short, g in _GGUF_NORMS.items():
        rows = []
        for i in range(L):
            key = f"blk.{i}.{g}"
            if key in tensors:
                rows.append(arr(key).astype(np.float32))
            else:  # Llama-family: placeholder ones (models/loader.py)
                rows.append(np.ones((norm_dims[short],), np.float32))
        stacked[short] = to_dtype(np.stack(rows), dtype, dev)
    ggml_bytes = meta.get("bitnet.i2s_layout") == "ggml"
    for short, g in _GGUF_PROJS.items():
        qw, scales = None, np.zeros((L,), np.float32)
        for i in range(L):
            qb, gtype = tensors[f"blk.{i}.{g}"]
            # TL1/TL2 and the I2_S id 30 are always BitNet wire bytes; an
            # id-36 file is too when it carries the layout marker (else it
            # is the legacy plane-major payload, used as it is)
            if gtype in (GGML_I2_S_REF, GGML_TL1, GGML_TL2) or (
                gtype == GGML_I2_S and ggml_bytes
            ):
                qb = pack_ternary_np(unpack_i2s_np(qb).T)  # [N, K/4] -> [K/4, N]
            if qw is None:
                qw = np.empty((L,) + qb.shape, np.uint8)
            qw[i] = qb
            scales[i] = float(arr(f"blk.{i}.{g}.scale")[0])
        stacked[f"{short}_qw"] = torch.from_numpy(qw).to(dev)
        stacked[f"{short}_scale"] = torch.from_numpy(scales).to(dev)

    params = {
        "embed": to_dtype(arr("token_embd.weight"), dtype, dev),
        "final_norm": to_dtype(arr("output_norm.weight"), dtype, dev),
        "layers": stacked,
    }
    if "output.weight" in tensors:
        params["lm_head"] = to_dtype(arr("output.weight"), dtype, dev)
    return params, cfg
