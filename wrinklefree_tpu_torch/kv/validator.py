"""Black-box KV-cache validation against a live server (PyTorch port of
``wrinklefree_tpu/kv/validator.py``).

Prefix-caching speedup, context-limit grace and concurrent success rate,
measured purely over HTTP so it works against any backend serving the API.
Standard library only: the port's client (``client/client.py``) and
``urllib``.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import logging
import time
import urllib.error
import urllib.request

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class KVCacheMetrics:
    prefix_cache_speedup: float = 0.0
    context_limit_graceful: bool = False
    concurrent_success_rate: float = 0.0
    details: dict = dataclasses.field(default_factory=dict)

    @property
    def passed(self) -> bool:
        return (
            self.prefix_cache_speedup >= 0.9  # no slower with cache
            and self.context_limit_graceful
            and self.concurrent_success_rate >= 0.95
        )


class KVCacheValidator:
    def __init__(self, base_url: str):
        from ..client import InferenceClient

        self.client = InferenceClient(base_url)
        self.base_url = base_url.rstrip("/")

    def validate_prefix_caching(self, prefix_len: int = 512, trials: int = 3) -> float:
        """TTFT of a repeated long-prefix prompt should not regress vs the
        first (cold) call; with the radix cache it should improve."""
        prefix = "The quick brown fox jumps over the lazy dog. " * (prefix_len // 45)

        def ttft(prompt):
            t0 = time.perf_counter()
            for _ in self.client.generate_stream(prompt, max_tokens=2, temperature=0.0):
                return time.perf_counter() - t0
            return time.perf_counter() - t0

        cold = ttft(prefix + " Tell me a story.")
        warm = min(ttft(prefix + " Tell me a story.") for _ in range(trials))
        speedup = cold / max(warm, 1e-6)
        logger.info("prefix caching: cold %.3fs warm %.3fs speedup %.2fx", cold, warm, speedup)
        return speedup

    def validate_context_limits(self) -> bool:
        """Over-limit prompts must produce a clean HTTP error, not a hang or
        a 5xx crash."""
        huge = "word " * 100_000
        req = urllib.request.Request(
            f"{self.base_url}/completion",
            data=json.dumps({"prompt": huge, "n_predict": 4}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status == 200
        except urllib.error.HTTPError as e:
            return e.code in (400, 413, 422)
        except OSError:  # no answer: a timeout, a refused or reset connection
            return False

    def validate_continuous_batching(self, n: int = 8) -> float:
        def one(i):
            try:
                out = self.client.generate(f"request {i}:", max_tokens=8, temperature=0.0)
                return isinstance(out, str)
            except Exception:
                return False

        with cf.ThreadPoolExecutor(n) as ex:
            ok = list(ex.map(one, range(n)))
        return sum(ok) / n

    def run(self) -> KVCacheMetrics:
        m = KVCacheMetrics()
        m.prefix_cache_speedup = self.validate_prefix_caching()
        m.context_limit_graceful = self.validate_context_limits()
        m.concurrent_success_rate = self.validate_continuous_batching()
        return m


def run_kv_cache_validation(base_url: str) -> bool:
    v = KVCacheValidator(base_url)
    m = v.run()
    print(
        f"prefix speedup: {m.prefix_cache_speedup:.2f}x | "
        f"context-limit graceful: {m.context_limit_graceful} | "
        f"concurrent success: {m.concurrent_success_rate:.0%} | "
        f"{'PASS' if m.passed else 'FAIL'}"
    )
    return m.passed
