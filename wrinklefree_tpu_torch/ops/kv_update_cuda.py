"""In-place paged-KV row writer (K3): CUDA kernel and plain PyTorch version.

Counterpart of ``wrinklefree_tpu/ops/kv_update_pallas.py::kv_write_pallas``:
``pool[flat_ids[i], offsets[i]] = vals[i]`` in place, where a pool row is
everything after its first two axes (a staging row ``[2L, KV*D]``, or a whole
page ``[2L*ps, KV*D]`` when the caller views the main pool with ps = 1).
The TPU version padded KV heads to Mosaic's DMA tile (``kv_pad``); rows here
need only a byte size that is a multiple of 16.

The wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel (``csrc/kv_write.cu``) or raises. ``kv_write.launches``
counts launches. ``paged_kv_update`` (the reference's per-layer pool writer)
is a thin wrapper on the same kernel.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def kv_write_plain(
    pool: torch.Tensor, vals: torch.Tensor, flat_ids: torch.Tensor, offsets: torch.Tensor
) -> torch.Tensor:
    """Plain version: indexed assignment into ``pool`` (in place)."""
    pool[flat_ids.long(), offsets.long()] = vals.to(pool.dtype)
    return pool


def kv_write(
    pool: torch.Tensor,  # [LP, ps, *row] — written in place and returned
    vals: torch.Tensor,  # [N, *row]
    flat_ids: torch.Tensor,  # [N] int32 page ids
    offsets: torch.Tensor,  # [N] int32 slot within page
) -> torch.Tensor:
    """``pool[flat_ids[i], offsets[i]] = vals[i]``, in place."""
    if pool.device.type == "cpu":
        return kv_write_plain(pool, vals, flat_ids, offsets)
    cuda_lib.require_cuda(pool, "kv_write")
    n = vals.shape[0]
    row = pool.shape[2:]
    if tuple(vals.shape[1:]) != tuple(row) or vals.dtype != pool.dtype:
        raise ValueError(f"rows {tuple(vals.shape)} {vals.dtype} do not fit pool "
                         f"{tuple(pool.shape)} {pool.dtype}")
    if flat_ids.shape != (n,) or offsets.shape != (n,):
        raise ValueError("flat_ids and offsets must be [N]")
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous")
    if n == 0:
        return pool
    row_bytes = vals[0].numel() * vals.element_size()
    vals_c = vals.contiguous()
    if row_bytes % 16 or pool.data_ptr() % 16 or vals_c.data_ptr() % 16:
        raise ValueError("pool rows must be 16-byte sized and aligned")
    ids = flat_ids.to(torch.int32).contiguous()
    offs = offsets.to(torch.int32).contiguous()
    cuda_lib.call(
        "wf_kv_write", pool.data_ptr(), vals_c.data_ptr(), ids.data_ptr(), offs.data_ptr(),
        n, pool.shape[1], pool.shape[0] * pool.shape[1], row_bytes, cuda_lib.stream(pool),
    )
    kv_write.launches += 1
    return pool


kv_write.launches = 0


def paged_kv_update(pool, vals, page_ids, offsets, layer_stride: int):
    """Write [L, B, S, *row] ``vals`` into an [L, P, ps, *row] pool in place
    through K3 (the reference's ``paged_kv_update``, which no path of either
    package calls): layer l's row (b, s) goes to page ``page_ids[b, s] + l *
    layer_stride`` of the layer-flattened pool at ``offsets[b, s]``."""
    L = vals.shape[0]
    B, S = page_ids.shape
    row = tuple(vals.shape[3:])
    flat_pool = pool.view(L * layer_stride, pool.shape[2], *row)
    layer_base = torch.arange(L, device=page_ids.device) * layer_stride
    flat_ids = (page_ids[None] + layer_base[:, None, None]).reshape(-1)
    flat_offs = offsets[None].expand(L, B, S).reshape(-1)
    kv_write(flat_pool, vals.reshape(L * B * S, *row), flat_ids.to(torch.int32),
             flat_offs.to(torch.int32))
    return pool
