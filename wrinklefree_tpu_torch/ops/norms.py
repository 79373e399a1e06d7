"""RMSNorm, numerically as HF LlamaRMSNorm/BitNetRMSNorm: variance in
float32, normalized value cast back to the input dtype, then scaled by the
(bf16) weight. Counterpart of ``wrinklefree_tpu/ops/norms.py``.

``1/sqrt`` is written out (IEEE sqrt and division) instead of
``torch.rsqrt``, whose CUDA form is an approximation: the fused kernels'
prologues use the same correctly rounded form.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * (1.0 / torch.sqrt(var + eps))).to(x.dtype)
    return normed * weight.to(x.dtype)
