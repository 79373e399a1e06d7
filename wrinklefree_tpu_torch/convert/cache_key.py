"""Content-addressed cache keys for converted model artifacts.

Counterpart of ``wrinklefree_tpu/convert/cache_key.py`` (the same keys:
both packages read and write the same packed cache): sha256 over {model
path/id, revision, pack format version}; a local path also hashes the head
and tail of its files, so edits change the key.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Optional

PACK_FORMAT = "wf_tpu_plane_major_v1"


def compute_cache_key(
    model_path: str, revision: Optional[str] = None, pack_format: str = PACK_FORMAT
) -> str:
    h = hashlib.sha256()
    ident = {"path": str(model_path), "revision": revision, "pack_format": pack_format}
    h.update(json.dumps(ident, sort_keys=True).encode())

    p = Path(model_path)
    if p.exists():
        for f in sorted(p.glob("*.safetensors")) + sorted(p.glob("config.json")):
            h.update(f.name.encode())
            h.update(str(f.stat().st_size).encode())
            with open(f, "rb") as fh:  # hash head+tail (fast, detects edits)
                h.update(fh.read(1 << 20))
                fh.seek(max(f.stat().st_size - (1 << 20), 0))
                h.update(fh.read(1 << 20))
    return h.hexdigest()[:16]
