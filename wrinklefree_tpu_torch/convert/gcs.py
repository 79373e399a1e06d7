"""Remote artifact cache (GCS), import-gated.

Counterpart of ``wrinklefree_tpu/convert/gcs.py``. google-cloud-storage is
not a dependency: when it is missing, offline, or ``WF_SKIP_GCS=1``, every
method is a cache miss, so the loader falls through to conversion. The
local mirror (``WF_CACHE_DIR``, default ``~/.cache/wrinklefree_tpu/models``)
is the reference's: both packages read and write the same packed cache.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

DEFAULT_BUCKET = os.environ.get("WF_GCS_BUCKET", "wrinklefree-models")
LOCAL_CACHE = Path(
    os.environ.get("WF_CACHE_DIR", Path.home() / ".cache" / "wrinklefree_tpu" / "models")
)


class GCSModelCache:
    def __init__(self, bucket_name: str = DEFAULT_BUCKET):
        self.bucket_name = bucket_name
        self._client = None
        self.enabled = os.environ.get("WF_SKIP_GCS", "0") != "1"

    def _bucket(self):
        if not self.enabled:
            return None
        if self._client is None:
            try:
                from google.cloud import storage  # type: ignore

                self._client = storage.Client()
            except Exception as e:  # lib missing / no creds / offline
                logger.info("GCS unavailable (%s); remote cache disabled", e)
                self.enabled = False
                return None
        try:
            return self._client.bucket(self.bucket_name)
        except Exception:
            self.enabled = False
            return None

    def exists(self, key: str) -> bool:
        b = self._bucket()
        if b is None:
            return False
        try:
            return any(True for _ in b.list_blobs(prefix=f"cache/{key}/", max_results=1))
        except Exception:
            return False

    def download(self, key: str, dest: Path) -> Optional[Path]:
        b = self._bucket()
        if b is None:
            return None
        try:
            dest.mkdir(parents=True, exist_ok=True)
            n = 0
            for blob in b.list_blobs(prefix=f"cache/{key}/"):
                rel = blob.name[len(f"cache/{key}/"):]
                if not rel:
                    continue
                target = dest / rel
                target.parent.mkdir(parents=True, exist_ok=True)
                blob.download_to_filename(str(target))
                n += 1
            return dest if n else None
        except Exception as e:
            logger.warning("GCS download failed: %s", e)
            return None

    def upload(self, key: str, src: Path) -> bool:
        b = self._bucket()
        if b is None:
            return False
        try:
            for f in Path(src).rglob("*"):
                if f.is_file():
                    rel = f.relative_to(src)
                    b.blob(f"cache/{key}/{rel}").upload_from_filename(str(f))
            return True
        except Exception as e:
            logger.warning("GCS upload failed: %s", e)
            return False
