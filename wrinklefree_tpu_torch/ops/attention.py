"""Attention oracle in PyTorch: the counterpart of
``wrinklefree_tpu/ops/attention.py``.

GQA scaled-dot-product attention, causal, with an absolute ``q_offset`` so
a chunk of S query tokens attends into T keys: key t is visible to query
row s iff t <= q_offset + s (and t < kv_len when given). Scores and softmax
in f32, probabilities rounded to the value dtype before the PV product.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def gqa_attention_reference(
    q: torch.Tensor,  # [B, S, NH, D]
    k: torch.Tensor,  # [B, T, KV, D]
    v: torch.Tensor,  # [B, T, KV, D]
    q_offset=0,  # [B] tensor or an int
    *,
    kv_len: Optional[torch.Tensor] = None,  # [B] valid key count
) -> torch.Tensor:
    B, S, NH, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = NH // KV
    dev = q.device
    q_off = torch.as_tensor(q_offset, dtype=torch.int64, device=dev).reshape(-1).expand(B)
    qg = q.reshape(B, S, KV, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * (1.0 / math.sqrt(D))
    key_idx = torch.arange(T, device=dev)[None, None, None, None, :]
    q_pos = (q_off[:, None] + torch.arange(S, device=dev)[None, :])[:, None, None, :, None]
    mask = key_idx <= q_pos
    if kv_len is not None:
        mask = mask & (key_idx < kv_len.to(dev)[:, None, None, None, None])
    scores = torch.where(mask, scores, torch.tensor(float("-inf"), device=dev))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs.float(), v.float()).to(v.dtype)
    return out.reshape(B, S, NH, D)
