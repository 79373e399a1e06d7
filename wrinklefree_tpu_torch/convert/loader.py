"""Model-fetch orchestration: local cache -> GCS -> convert -> upload.

Counterpart of ``wrinklefree_tpu/convert/loader.py``, keyed by content hash
(``cache_key.py``).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import List, Optional

from .cache_key import compute_cache_key
from .convert import convert_and_save
from .gcs import LOCAL_CACHE, GCSModelCache

logger = logging.getLogger(__name__)


def get_cached_or_convert(
    model_path: str,
    revision: Optional[str] = None,
    *,
    ternarize: bool = False,
    skip_gcs: bool = False,
) -> Path:
    key = compute_cache_key(model_path, revision)
    local = LOCAL_CACHE / key
    if (local / "cache_metadata.json").exists():
        logger.info("cache hit (local): %s", local)
        return local

    gcs = None if skip_gcs else GCSModelCache()
    if gcs is not None and gcs.exists(key):
        got = gcs.download(key, local)
        if got is not None and (local / "cache_metadata.json").exists():
            logger.info("cache hit (GCS): %s", local)
            return local

    logger.info("cache miss: converting %s -> %s", model_path, local)
    convert_and_save(model_path, local, revision=revision, ternarize=ternarize)

    if gcs is not None:
        gcs.upload(key, local)
    return local


def list_cached_models() -> List[str]:
    if not LOCAL_CACHE.exists():
        return []
    out = []
    for d in sorted(LOCAL_CACHE.iterdir()):
        meta = d / "cache_metadata.json"
        if meta.exists():
            m = json.loads(meta.read_text())
            out.append(f"{d.name}  {m.get('source_model', '?')}  ({m.get('format_version')})")
    return out
