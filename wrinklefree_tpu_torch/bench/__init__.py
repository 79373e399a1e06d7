"""Benchmarks of the PyTorch port: the serving bench
(``python -m wrinklefree_tpu_torch.bench.serving``), the batch-1 decode
bench (``python -m wrinklefree_tpu_torch.bench.decode``), the kernel
benches, and the reference's metrics, cost and report helpers."""

from .cost import CostMetrics, CostTracker
from .metrics import BenchmarkMetrics, roofline_report
from .runner import run_server_benchmark
