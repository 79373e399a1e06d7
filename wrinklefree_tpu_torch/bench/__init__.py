"""Benchmarks of the PyTorch port (``python -m wrinklefree_tpu_torch.bench.decode``)."""
