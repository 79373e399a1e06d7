"""Cost tracking: $/1M tokens at utilization tiers (PyTorch port; a copy of
``wrinklefree_tpu/bench/cost.py``).

Replicates the reference cost math (reference
legacy/benchmark/cost_tracker.py:14-51: cost_per_million_tokens at
100/70/50% utilization from hourly hardware pricing) with TPU prices in
the default table.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

# on-demand $/hr (public list prices, editable)
HARDWARE_PRICING = {
    "tpu-v5e-1": 1.20,
    "tpu-v5e-4": 4.80,
    "tpu-v5e-8": 9.60,
    "tpu-v5p-1": 4.20,
    "cpu-c3d-16": 0.80,
    "ryzen-7700-ref": 0.25,  # the reference's desktop, amortized
}


@dataclasses.dataclass
class CostMetrics:
    tokens_per_second: float
    hourly_cost: float

    def cost_per_million_tokens(self, utilization: float = 1.0) -> float:
        eff = self.tokens_per_second * utilization
        if eff <= 0:
            return float("inf")
        tokens_per_hour = eff * 3600
        return self.hourly_cost / tokens_per_hour * 1_000_000


class CostTracker:
    def __init__(self, hourly_cost: float = None, hardware: str = "tpu-v5e-1"):
        self.hourly_cost = (
            hourly_cost if hourly_cost is not None else HARDWARE_PRICING[hardware]
        )
        self.hardware = hardware

    def report(self, tokens_per_second: float) -> Dict:
        m = CostMetrics(tokens_per_second, self.hourly_cost)
        return {
            "hardware": self.hardware,
            "hourly_cost_usd": self.hourly_cost,
            "tokens_per_second": tokens_per_second,
            "cost_per_1m_tokens": {
                "100pct_util": round(m.cost_per_million_tokens(1.0), 2),
                "70pct_util": round(m.cost_per_million_tokens(0.7), 2),
                "50pct_util": round(m.cost_per_million_tokens(0.5), 2),
            },
        }
