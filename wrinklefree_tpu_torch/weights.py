"""Carry the reference package's parameters over to the port.

``params_from_numpy`` takes the reference's params as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``, unfused or after
``fuse_projections``) and returns the port's params under the same key
names on the requested device, so both packages compute on identical
weights. The reference's fused scale rows ``[L, 8, N]`` (eight identical
rows, a TPU tiling artifact) become the port's ``[L, N]``; bf16 arrays
(numpy dtype ``bfloat16`` from ml_dtypes) keep their bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import BitNetConfig
from .models.bitnet import resolve_device


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.uint16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(np_params, cfg: BitNetConfig, device=None):
    """Reference params (nested dict of numpy arrays) -> port params."""
    dev = resolve_device(device)

    def convert(tree, key=""):
        if isinstance(tree, dict):
            return {k: convert(v, k) for k, v in tree.items()}
        t = _tensor(tree, dev)
        if key.endswith("_scale") and t.dim() == 3:
            t = t[:, 0, :].contiguous()  # [L, 8, N] rows -> [L, N]
        return t

    out = convert(np_params)
    dt = cfg.dtype
    for name in ("embed", "lm_head", "final_norm"):
        if name in out and out[name].dtype != dt:
            raise ValueError(f"{name} has dtype {out[name].dtype}, config says {dt}")
    return out
