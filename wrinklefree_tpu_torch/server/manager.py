"""Server subprocess lifecycle management (PyTorch port of
``wrinklefree_tpu/server/manager.py``, starting the port's server).

Analog of the reference's server manager (reference
legacy/src/server/bitnet_server.py:48-137 and
scripts/benchmark_compare.py:151-181): spawn the HTTP server as a
subprocess, poll /health until ready, raise if the process dies during
startup, and stop with terminate->kill escalation. This is the failure
-detection layer SURVEY.md §5.3 inventories.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time
import urllib.request
from typing import List, Optional

logger = logging.getLogger(__name__)


class ServerDiedError(RuntimeError):
    pass


class ServerManager:
    """Spawn/supervise `python -m wrinklefree_tpu_torch.server`. The
    default arguments serve the tiny model on the card; pass
    ``["--tiny", "--device", "cpu"]`` for the CPU."""

    def __init__(
        self,
        args: Optional[List[str]] = None,
        host: str = "127.0.0.1",
        port: int = 30000,
        env: Optional[dict] = None,
    ):
        self.host = host
        self.port = port
        self.args = args if args is not None else ["--tiny"]
        self.env = {**os.environ, **(env or {})}
        self.proc: Optional[subprocess.Popen] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def health_ok(self, timeout: float = 2.0) -> bool:
        try:
            with urllib.request.urlopen(f"{self.url}/health", timeout=timeout) as r:
                return r.status == 200
        except Exception:
            return False

    def start(self, startup_timeout: float = 180.0, poll_interval: float = 1.0):
        """Spawn and block until /health answers.

        Raises ServerDiedError if the process exits first, TimeoutError if
        it never becomes healthy (then kills it).
        """
        if self.proc is not None:
            raise RuntimeError("server already started")
        cmd = [
            sys.executable, "-m", "wrinklefree_tpu_torch.server",
            "--host", self.host, "--port", str(self.port), *self.args,
        ]
        logger.info("starting server: %s", " ".join(cmd))
        self.proc = subprocess.Popen(cmd, env=self.env)
        deadline = time.monotonic() + startup_timeout
        while time.monotonic() < deadline:
            rc = self.proc.poll()
            if rc is not None:
                self.proc = None
                raise ServerDiedError(f"server exited with code {rc} during startup")
            if self.health_ok():
                logger.info("server ready at %s", self.url)
                return self
            time.sleep(poll_interval)
        self.stop()
        raise TimeoutError(f"server not healthy after {startup_timeout}s")

    def is_alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def stop(self, grace_s: float = 10.0):
        """terminate -> wait -> kill escalation (reference
        bitnet_server.py pattern)."""
        if self.proc is None:
            return
        proc, self.proc = self.proc, None
        if proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            logger.warning("server did not exit in %.0fs; killing", grace_s)
            proc.kill()
            proc.wait(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
