"""wrinklefree_tpu_torch — the PyTorch/CUDA port of wrinklefree_tpu.

A second package beside the JAX reference: plain PyTorch around kernels
written by hand for NVIDIA Hopper (``csrc/*.cu``, built with nvcc for
sm_90a at first use and bound with ctypes). Module names follow the
reference so each counterpart is easy to find. Each kernel's wrapper runs a
plain PyTorch version of the same function on CPU tensors; entry points
(``Engine``, ``models.bitnet.init_params``, ``weights.params_from_numpy``)
default to ``device="cuda"`` and raise on a host without CUDA unless the
caller passes ``device="cpu"``.

This package imports neither jax nor anything of ``wrinklefree_tpu``.
"""

__version__ = "0.1.0"
