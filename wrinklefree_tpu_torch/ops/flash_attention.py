"""Paged-prefill flash attention (K4): CUDA kernel and plain PyTorch version.

Counterpart of ``wrinklefree_tpu/ops/flash_attention.py::flash_paged_prefill``
(the other flash entry points of that module are not ported yet). The plain
version is the masked-softmax GQA core of the paged forward
(``kv/paged.py::_gqa_core``) on the same inputs.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel (``csrc/flash_prefill.cu``) or raises.
``flash_paged_prefill.launches`` counts launches.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib


def _lengths(x, b: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1).expand(b)


def flash_paged_prefill_plain(q, k_full, v_full, kv_valid, new_len, *, hist_len: int):
    """Plain version: ``_gqa_core`` over [history(hist_len) ++ chunk]."""
    from ..kv.paged import _gqa_core

    B, S = q.shape[:2]
    kv_valid = _lengths(kv_valid, B, q.device)
    new_len = _lengths(new_len, B, q.device)
    hist_ok = torch.arange(hist_len, device=q.device)[None, :] < kv_valid[:, None]
    return _gqa_core(
        q, k_full[:, hist_len:hist_len + S], v_full[:, hist_len:hist_len + S],
        k_full[:, :hist_len], v_full[:, :hist_len], hist_ok, new_len,
    )


def flash_paged_prefill(
    q: torch.Tensor,  # [B, S, NH, D] current chunk queries
    k_full: torch.Tensor,  # [B, Tt, KV, D] history(hist_len) ++ current(S)
    v_full: torch.Tensor,
    kv_valid,  # [B] int (or scalar): valid history length per row
    new_len,  # [B] int (or scalar): real tokens in each row's chunk
    *,
    hist_len: int,
) -> torch.Tensor:
    """Online-softmax attention for chunked-prefill rows over a gathered
    paged history, without materializing the [B, S, T] scores."""
    if q.device.type == "cpu":
        return flash_paged_prefill_plain(q, k_full, v_full, kv_valid, new_len,
                                         hist_len=hist_len)
    cuda_lib.require_cuda(q, "flash_paged_prefill")
    B, S, NH, D = q.shape
    Tt, KV = k_full.shape[1], k_full.shape[2]
    if (
        q.dtype != torch.bfloat16 or k_full.dtype != torch.bfloat16
        or v_full.dtype != torch.bfloat16
    ):
        raise ValueError("the CUDA kernel takes bfloat16")
    if D != 128 or NH % KV or k_full.shape != v_full.shape or k_full.shape[0] != B:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k {tuple(k_full.shape)}")
    if not hist_len + S <= Tt:
        raise ValueError(f"hist_len {hist_len} + S {S} exceeds key length {Tt}")
    qc, kc, vc = q.contiguous(), k_full.contiguous(), v_full.contiguous()
    kvv = _lengths(kv_valid, B, q.device).contiguous()
    nl = _lengths(new_len, B, q.device).contiguous()
    out = torch.empty_like(qc)
    cuda_lib.call(
        "wf_flash_paged_prefill", qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        kvv.data_ptr(), nl.data_ptr(), out.data_ptr(), B, S, NH, KV, D, Tt, hist_len,
        1.0 / math.sqrt(D), cuda_lib.stream(q),
    )
    flash_paged_prefill.launches += 1
    return out


flash_paged_prefill.launches = 0
