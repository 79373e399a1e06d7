"""Benchmark metrics schema (PyTorch port; a copy of
``wrinklefree_tpu/bench/metrics.py`` whose ``roofline_report`` defaults to
the H100's memory rate).

Replicates the reference metrics surface (reference
legacy/benchmark/metrics.py:15-52): latency avg/p50/p95/p99/min/max,
TTFT percentiles, req/s, tok/s, plus memory-bandwidth utilization
estimates for the roofline report.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional


def _pct(xs: List[float], p: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    k = min(int(round((p / 100) * (len(xs) - 1))), len(xs) - 1)
    return xs[k]


@dataclasses.dataclass
class BenchmarkMetrics:
    num_requests: int = 0
    total_time_s: float = 0.0
    total_tokens: int = 0
    latency_avg_s: float = 0.0
    latency_p50_s: float = 0.0
    latency_p95_s: float = 0.0
    latency_p99_s: float = 0.0
    latency_min_s: float = 0.0
    latency_max_s: float = 0.0
    ttft_avg_s: float = 0.0
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    requests_per_s: float = 0.0
    tokens_per_s: float = 0.0

    @classmethod
    def from_latencies(
        cls,
        latencies_s: List[float],
        ttfts_s: Optional[List[float]] = None,
        total_tokens: int = 0,
        total_time_s: Optional[float] = None,
    ) -> "BenchmarkMetrics":
        ttfts_s = ttfts_s or []
        total = total_time_s if total_time_s is not None else sum(latencies_s)
        n = len(latencies_s)
        return cls(
            num_requests=n,
            total_time_s=total,
            total_tokens=total_tokens,
            latency_avg_s=statistics.mean(latencies_s) if latencies_s else 0.0,
            latency_p50_s=_pct(latencies_s, 50),
            latency_p95_s=_pct(latencies_s, 95),
            latency_p99_s=_pct(latencies_s, 99),
            latency_min_s=min(latencies_s) if latencies_s else 0.0,
            latency_max_s=max(latencies_s) if latencies_s else 0.0,
            ttft_avg_s=statistics.mean(ttfts_s) if ttfts_s else 0.0,
            ttft_p50_s=_pct(ttfts_s, 50),
            ttft_p95_s=_pct(ttfts_s, 95),
            requests_per_s=n / total if total > 0 else 0.0,
            tokens_per_s=total_tokens / total if total > 0 else 0.0,
        )

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


# NVIDIA H100 SXM (80 GB HBM3): the published memory rate, 3.35 TB/s
H100_HBM_GBPS = 3350.0


def roofline_report(
    bytes_moved: float, elapsed_s: float, hbm_bw_gbps: float = H100_HBM_GBPS
) -> Dict:
    """Achieved vs theoretical HBM bandwidth (default: the H100 SXM's
    3.35 TB/s). The analog of the reference's memory_profiler bandwidth
    utilization (reference legacy/benchmark/memory_profiler.py:1-78)."""
    achieved = bytes_moved / max(elapsed_s, 1e-9) / 1e9
    return {
        "achieved_gb_s": round(achieved, 1),
        "theoretical_gb_s": hbm_bw_gbps,
        "utilization": round(achieved / hbm_bw_gbps, 3),
    }
