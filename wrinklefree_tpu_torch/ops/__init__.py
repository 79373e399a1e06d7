"""Ops: ternary format, norms, rope, sampling, and the CUDA kernels with
their plain PyTorch versions (``ternary_cuda``, ``kv_update_cuda``,
``flash_attention``)."""
