"""Markdown + JSON benchmark report generator (PyTorch port; a copy of
``wrinklefree_tpu/bench/report.py``).

Analog of the reference's report generator (reference
legacy/benchmark/report_generator.py — dated JSON in results/raw/ plus
markdown summaries in results/reports/).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

from .cost import CostMetrics
from .metrics import BenchmarkMetrics


def _fmt_row(cells) -> str:
    return "| " + " | ".join(str(c) for c in cells) + " |"


def render_markdown(
    title: str,
    metrics: BenchmarkMetrics,
    cost: Optional[CostMetrics] = None,
    roofline_points: Optional[List[Dict]] = None,
    notes: Optional[Dict[str, object]] = None,
) -> str:
    lines = [f"# {title}", "", f"_generated {time.strftime('%Y-%m-%d %H:%M:%S')}_", ""]
    lines += [
        "## Throughput & latency", "",
        _fmt_row(["metric", "value"]),
        _fmt_row(["---", "---"]),
        _fmt_row(["requests", metrics.num_requests]),
        _fmt_row(["tokens/s", f"{metrics.tokens_per_s:.2f}"]),
        _fmt_row(["requests/s", f"{metrics.requests_per_s:.2f}"]),
        _fmt_row(["latency avg (s)", f"{metrics.latency_avg_s:.3f}"]),
        _fmt_row(["latency p50/p95/p99 (s)",
                  f"{metrics.latency_p50_s:.3f} / {metrics.latency_p95_s:.3f} / {metrics.latency_p99_s:.3f}"]),
        _fmt_row(["TTFT avg/p50/p95 (s)",
                  f"{metrics.ttft_avg_s:.3f} / {metrics.ttft_p50_s:.3f} / {metrics.ttft_p95_s:.3f}"]),
        "",
    ]
    if cost is not None:
        lines += [
            "## Cost", "",
            _fmt_row(["utilization", "$/1M tokens"]),
            _fmt_row(["---", "---"]),
            *(
                _fmt_row([f"{int(u*100)}%", f"${cost.cost_per_million_tokens(u):.2f}"])
                for u in (1.0, 0.7, 0.5)
            ),
            "",
        ]
    if roofline_points:
        lines += [
            "## Kernel roofline", "",
            _fmt_row(["kernel", "ms", "GB/s", "GFLOP/s", "% HBM BW", "bound"]),
            _fmt_row(["---"] * 6),
            *(
                _fmt_row([
                    p["name"], f"{p['time_ms']:.3f}", f"{p['gbytes_per_s']:.1f}",
                    f"{p['gflops']:.1f}", f"{100*p['bw_utilization']:.1f}%", p["bound"],
                ])
                for p in roofline_points
            ),
            "",
        ]
    if notes:
        lines += ["## Notes", ""]
        lines += [f"- **{k}**: {v}" for k, v in notes.items()]
        lines += [""]
    return "\n".join(lines)


def write_report(
    out_dir: Path | str,
    name: str,
    metrics: BenchmarkMetrics,
    cost: Optional[CostMetrics] = None,
    roofline_points: Optional[List[Dict]] = None,
    notes: Optional[Dict[str, object]] = None,
) -> Dict[str, Path]:
    """Write results/raw/<ts>_<name>.json + results/reports/<name>.md."""
    out_dir = Path(out_dir)
    raw_dir = out_dir / "raw"
    rep_dir = out_dir / "reports"
    raw_dir.mkdir(parents=True, exist_ok=True)
    rep_dir.mkdir(parents=True, exist_ok=True)

    ts = time.strftime("%Y%m%d_%H%M%S")
    payload = {
        "name": name,
        "timestamp": ts,
        "metrics": dataclasses.asdict(metrics),
        "cost": dataclasses.asdict(cost) if cost else None,
        "roofline": roofline_points,
        "notes": notes,
    }
    raw = raw_dir / f"{ts}_{name}.json"
    raw.write_text(json.dumps(payload, indent=2))
    md = rep_dir / f"{name}.md"
    md.write_text(render_markdown(name, metrics, cost, roofline_points, notes))
    return {"json": raw, "markdown": md}
