"""The safetensors format on the standard library and numpy.

The GPU machine has no ``safetensors`` package, so the port reads and writes
the files itself. A file is an 8-byte little-endian header length, a JSON
header ``{name: {"dtype", "shape", "data_offsets"}}`` (plus an optional
``"__metadata__"`` of strings), then the raw little-endian bytes, with
offsets relative to the end of the header.

``load_file`` maps the file and returns read-only arrays over it. ``BF16``
comes back as its ``uint16`` bits (``to_float`` widens them to f32, as the
reference's loaders read bf16), under a dtype that remembers the tag, so that copying such an
array into ``save_file`` writes ``BF16`` again while a plain ``uint16`` array
stays ``U16``. ``save_file`` writes what the ``safetensors`` package writes:
tensors ordered by dtype (largest first, in that package's order) then by
name, the header padded with spaces to a multiple of 8.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# bf16 bits: uint16, tagged so that a copy is written back as BF16
BF16 = np.dtype(np.uint16, metadata={"safetensors_dtype": "BF16"})

# the dtypes of the model files, in the safetensors package's dtype order
# (its writer puts the last first)
DTYPES = {
    "U8": np.dtype(np.uint8), "I8": np.dtype(np.int8), "U16": np.dtype("<u2"),
    "F16": np.dtype("<f2"), "BF16": BF16, "I32": np.dtype("<i4"), "F32": np.dtype("<f4"),
    "I64": np.dtype("<i8"),
}
_ORDER = tuple(DTYPES)
_MAX_HEADER = 100 << 20


def dtype_name(a: np.ndarray) -> str:
    """The safetensors dtype of an array: tagged uint16 and ml_dtypes'
    bfloat16 are ``BF16``, a plain uint16 is ``U16``."""
    dt = a.dtype
    if (dt.metadata or {}).get("safetensors_dtype") == "BF16" or dt.name == "bfloat16":
        return "BF16"
    for name, want in DTYPES.items():
        if name != "BF16" and dt.kind == want.kind and dt.itemsize == want.itemsize:
            return name
    raise TypeError(f"dtype {dt} has no safetensors name")


def to_float(x: np.ndarray) -> np.ndarray:
    """f32 of a float array; a ``uint16`` array is bf16 bits, widened."""
    if x.dtype == np.uint16:
        return (x.astype(np.uint32) << 16).view(np.float32)
    return x.astype(np.float32)


def read_header(path) -> tuple:
    """(header dict, byte offset of the data) of a safetensors file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", head)
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes")
        raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: header cut short")
    return json.loads(raw), 8 + n


def load_file(path) -> Dict[str, np.ndarray]:
    """Every tensor of a file: read-only arrays over a map of it."""
    header, start = read_header(path)
    size = Path(path).stat().st_size
    mm = np.memmap(path, dtype=np.uint8, mode="r") if size > start else None
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        shape = tuple(int(d) for d in info["shape"])
        lo, hi = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        if hi - lo != count * dt.itemsize or not 0 <= lo <= hi <= size - start:
            raise ValueError(f"{path}: tensor {name} has offsets {lo}..{hi} for {shape} "
                             f"{info['dtype']}")
        if count == 0:
            arr = np.zeros(shape, dt)
        else:
            arr = np.frombuffer(mm, dtype=dt, count=count, offset=start + lo).reshape(shape)
        out[name] = arr
    return out


def save_file(tensors: Dict[str, np.ndarray], path, metadata: Optional[Dict[str, str]] = None):
    """Write ``tensors`` (name -> array, any strides) as one file."""
    named = [(name, np.asarray(a), dtype_name(np.asarray(a))) for name, a in tensors.items()]
    named.sort(key=lambda t: (-_ORDER.index(t[2]), t[0]))
    header = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for name, a, dt in named:
        header[name] = {"dtype": dt, "shape": list(a.shape), "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, a, _ in named:
            a = np.ascontiguousarray(a)
            if a.dtype.byteorder == ">":
                a = a.astype(a.dtype.newbyteorder("<"))
            f.write(a.reshape(-1).view(np.uint8).data if a.size else b"")
    return Path(path)
