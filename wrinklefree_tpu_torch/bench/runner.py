"""Server benchmark harness: streaming TTFT + throughput + percentiles
(PyTorch port of ``wrinklefree_tpu/bench/runner.py``, driving the port's
standard-library client).

The analog of the reference's comparison harness
(reference scripts/benchmark_compare.py:185-331: warmups, SSE-streamed
TTFT = first content delta, tok/s = tokens/total) against any server
implementing the API.
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from typing import Dict, List

from .metrics import BenchmarkMetrics


def _bench_one(url: str, prompt: str, max_tokens: int) -> Dict:
    from ..client import InferenceClient

    c = InferenceClient(url)
    t0 = time.perf_counter()
    ttft = None
    n = 0
    for _chunk in c.generate_stream(prompt, max_tokens=max_tokens, temperature=0.0):
        if ttft is None:
            ttft = time.perf_counter() - t0
        n += 1
    total = time.perf_counter() - t0
    return {"latency": total, "ttft": ttft or total, "tokens": n}


def run_server_benchmark(
    url: str,
    num_requests: int = 8,
    max_tokens: int = 64,
    concurrency: int = 1,
    prompt: str = "Explain how a ternary neural network works.",
    warmups: int = 2,
) -> Dict:
    for _ in range(warmups):
        _bench_one(url, prompt, 8)

    t0 = time.perf_counter()
    if concurrency <= 1:
        results = [
            _bench_one(url, f"{prompt} ({i})", max_tokens) for i in range(num_requests)
        ]
    else:
        with cf.ThreadPoolExecutor(concurrency) as ex:
            results = list(
                ex.map(
                    lambda i: _bench_one(url, f"{prompt} ({i})", max_tokens),
                    range(num_requests),
                )
            )
    wall = time.perf_counter() - t0

    metrics = BenchmarkMetrics.from_latencies(
        [r["latency"] for r in results],
        [r["ttft"] for r in results],
        total_tokens=sum(r["tokens"] for r in results),
        total_time_s=wall,
    )
    return {
        "url": url,
        "num_requests": num_requests,
        "concurrency": concurrency,
        "max_tokens": max_tokens,
        **metrics.to_dict(),
    }
