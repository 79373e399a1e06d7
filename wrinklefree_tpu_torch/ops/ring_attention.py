"""Ring attention: sequence-parallel attention over a process group
(PyTorch port of ``wrinklefree_tpu/ops/ring_attention.py``).

Q, K, V are sequence-sharded over the ranks of a ``torch.distributed``
group (the reference's 1-axis ``seq`` mesh): rank i holds global positions
``[i*S_local, (i+1)*S_local)``. K/V blocks rotate around the ring (each rank
sends to rank ``(r+1) % P`` and receives from ``(r-1) % P``, the reference's
``ppermute``) while each rank folds every block into a running
online-softmax (flash-attention style m/l/acc state), so the full [S, S]
score matrix never exists and each rank holds S/P of the KV.

The block attention is einsums in PyTorch, as the reference's are XLA
einsums outside any Pallas kernel; scores are f32 products of the inputs
(bf16 q and k are upcast first, the reference's
``preferred_element_type=float32``). Exact (up to float reduction order)
against full attention. On a group of one the rotation is the identity.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist


def _block_attend(q, k, v, q_pos, k_pos, scale):
    """One block's contribution, GQA-aware.

    q [B,Sq,NH,D], k/v [B,Sk,KV,D], q_pos [B,Sq], k_pos [Sk]; key t is
    visible to row s iff ``k_pos[t] <= q_pos[b, s]``. Returns (scores-max m
    [B,KV,G,Sq] with 0 for rows that see no key, exp-sum l [B,KV,G,Sq],
    weighted acc [B,Sq,NH,D]) in f32, in the reference's order: scores,
    ``* scale``, the mask, ``exp(s - m)``, the mask again, the sums. The
    score-sized steps run in place (the same values, a third of the
    memory)."""
    B, Sq, NH, D = q.shape
    KV = k.shape[2]
    G = NH // KV
    qg = q.reshape(B, Sq, KV, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    s.mul_(scale)
    hidden = ~(k_pos[None, None, None, None, :] <= q_pos[:, None, None, :, None])
    s.masked_fill_(hidden, float("-inf"))
    m = s.amax(dim=-1)  # [B,KV,G,Sq]
    # rows with no visible keys: exp(-inf - -inf) guarded by a 0 max
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = s.sub_(m_safe[..., None]).exp_()
    p.masked_fill_(hidden, 0.0)
    l = p.sum(dim=-1)  # [B,KV,G,Sq]
    acc = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return m_safe, l, acc.reshape(B, Sq, NH, D)


def _bshape(f, B, Sq, NH):
    """[B,KV,G,Sq] factors onto [B,Sq,NH,D] accumulators."""
    return f.permute(0, 3, 1, 2).reshape(B, Sq, NH)[..., None]


def group_size_rank(group) -> tuple:
    """(P, this rank's index) of ``group`` (None: the default group)."""
    return dist.get_world_size(group), dist.get_rank(group)


def ring_shift(tensors, group):
    """Send each tensor to rank ``(r+1) % P`` of ``group`` and return the
    ones received from ``(r-1) % P`` (one batch of isend/irecv, a tag per
    tensor). The identity on a group of one."""
    P, r = group_size_rank(group)
    if P == 1:
        return list(tensors)
    g = group if group is not None else dist.group.WORLD
    dst = dist.get_global_rank(g, (r + 1) % P)
    src = dist.get_global_rank(g, (r - 1) % P)
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for tag, (t, o) in enumerate(zip(tensors, out)):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, g, tag))
        ops.append(dist.P2POp(dist.irecv, o, src, g, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def ring_attention(
    q: torch.Tensor,  # [B, Sq_local, NH, D]
    k: torch.Tensor,  # [B, Skv_local, KV, D]
    v: torch.Tensor,
    group=None,
    causal: bool = True,
    q_offset: Optional[torch.Tensor] = None,  # [B] global start of the q block
) -> torch.Tensor:
    """Sequence-parallel attention of this rank's q block over every rank's
    K/V block (collective: every rank of ``group`` calls it).

    Block ownership: rank i holds global positions ``[i*S_local,
    (i+1)*S_local)``; q's global start is ``i*Sq + q_offset``. With
    ``causal=True`` the mask uses global positions, so the result equals
    full causal attention over the gathered sequence."""
    B, Sq, NH, D = q.shape
    Skv = k.shape[1]
    KV = k.shape[2]
    G = NH // KV
    P, idx = group_size_rank(group)
    dev = q.device
    scale = 1.0 / math.sqrt(D)

    base = idx * Sq + (q_offset.to(dev, torch.int64)[:, None] if q_offset is not None else 0)
    q_pos = base + torch.arange(Sq, device=dev)[None, :]  # [B, Sq]
    if not causal:
        q_pos = torch.full_like(q_pos, 2**30)
    q_pos = q_pos.expand(B, Sq)

    m = torch.full((B, KV, G, Sq), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, NH, D), dtype=torch.float32, device=dev)
    kb, vb = k, v
    for step in range(P):
        src = (idx - step) % P  # whose block this rank holds now
        k_pos = src * Skv + torch.arange(Skv, device=dev)
        mb, lb, accb = _block_attend(q, kb, vb, q_pos, k_pos, scale)
        # mb is always finite (fully masked rows come back as 0 with l = 0),
        # so m_new is finite and exp(m - m_new) -> 0 for the initial -inf m
        m_new = torch.maximum(m, mb)
        a_old = torch.exp(m - m_new)
        a_new = torch.exp(mb - m_new)
        l = l * a_old + lb * a_new
        acc = acc * _bshape(a_old, B, Sq, NH) + accb * _bshape(a_new, B, Sq, NH)
        m = m_new
        if step < P - 1:  # the reference's last rotation only restores the blocks
            kb, vb = ring_shift((kb, vb), group)
    l = torch.clamp_min(l, 1e-30)
    return (acc / _bshape(l, B, Sq, NH)).to(q.dtype)


def make_ring_attention(group=None, causal: bool = True):
    """The counterpart of the reference's shard_map wrapper: ``apply(q, k,
    v)`` takes the full [B,S,NH,D] q/k/v (the same on every rank; S a
    multiple of the group's size), runs :func:`ring_attention` on this
    rank's sequence shard and returns the full [B,S,NH,D] output, gathered
    from every rank."""

    def apply(q, k, v):
        P, idx = group_size_rank(group)
        S = q.shape[1]
        if S % P:
            raise ValueError(f"sequence length {S} is not a multiple of the group's size {P}")
        n = S // P
        sl = slice(idx * n, (idx + 1) * n)
        out = ring_attention(q[:, sl].contiguous(), k[:, sl].contiguous(),
                             v[:, sl].contiguous(), group, causal=causal)
        parts = [torch.empty_like(out) for _ in range(P)]
        dist.all_gather(parts, out.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    return apply
