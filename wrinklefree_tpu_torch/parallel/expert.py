"""Expert parallelism: capacity-bucketed all-to-all MoE dispatch (PyTorch
port of ``wrinklefree_tpu/parallel/expert.py``).

On an ``expert`` axis (``parallel.sharding.make_named_mesh({"expert":
ep})``) the tokens are data-sharded and the experts weight-sharded, the
Switch/GShard layout. Each rank runs ``ep_moe_ffn`` on its rows, as the
reference's ``shard_map`` body runs on each device:

- route its tokens against the whole router; bucket each (token, choice)
  into its expert's ``C`` capacity slots (an exclusive running count in
  token-major order; assignments past ``C`` are dropped, their combine
  weight zeroed);
- ``Axis.all_to_all`` the ``[ep, E/ep, C, H]`` dispatch, so each rank
  receives every rank's slots for its own experts; run its experts on
  ``[E/ep, ep*C, H]`` (empty slots are zero rows and run too);
- all_to_all the outputs back and combine each token's k gathered rows
  weighted in ``x.dtype``.

The experts' linears are ``ops.ternary_cuda.make_linear()``: K7 on CUDA
tensors, the plain ``ternary_linear`` arithmetic on the CPU. The dense
psum form for few experts is ``models.moe.moe_ffn(ep_axis=)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.moe import _expert_ffn, load_balancing_loss, router_logits, top_k_route
from ..ops.ternary_cuda import make_linear
from .sharding import shard_leaf


def capacity_for(num_tokens: int, top_k: int, num_experts: int, factor: float) -> int:
    """Per-expert slot count: ceil(T*k/E * factor), at least 1 (the
    reference's float floor division, as written there)."""
    return max(1, int(-(-num_tokens * top_k * factor // num_experts)))


def _bucket_assignments(top_i: torch.Tensor, num_experts: int, capacity: int):
    """Slot each (token, choice) assignment into its expert's capacity
    buffer: its rank among the assignments to that expert in token-major
    order of the flattened ``[T*k]``. Returns (pos [T, k] int32, keep [T, k]
    bool)."""
    T, k = top_i.shape
    onehot = torch.nn.functional.one_hot(top_i.reshape(-1).long(), num_experts).to(torch.int32)
    rank = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot  # exclusive count
    pos = (rank * onehot).sum(dim=1, dtype=torch.int32).reshape(T, k)
    return pos, pos < capacity


def ep_moe_ffn(
    x: torch.Tensor,  # [T_local, H]: this rank's tokens
    experts,  # {gate,up,down}_{qw,scale} with a leading [E/ep] axis: this rank's experts
    ffn_sub: torch.Tensor,
    w_router: torch.Tensor,  # [H, E] whole
    *,
    ep_axis,
    top_k: int = 2,
    capacity_factor: float = 2.0,
    eps: float = 1e-5,
    lf=None,
    route_override=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-to-all expert-parallel MoE FFN on this rank of ``ep_axis`` (a
    ``parallel.sharding.Axis``; every rank calls it together). Returns (y
    [T_local, H] in ``x.dtype``, aux): aux is the mean over the ranks of
    each rank's load-balancing loss on its own tokens (``lax.pmean``), not
    the loss of the whole batch.

    Tokens over an expert's capacity lose that expert's contribution, as in
    the reference; a ``capacity_factor`` of E/k keeps every assignment.
    ``lf`` ``(x, qweight, scale) -> bf16`` defaults to ``make_linear()``;
    ``route_override`` (weights [T, k], ids [T, k]) replaces the router's
    choice (the identity-router oracle)."""
    T, H = x.shape
    E = w_router.shape[1]
    ep = ep_axis.size
    e_local = experts["gate_qw"].shape[0]
    if e_local * ep != E:
        raise ValueError(f"{e_local} experts a rank x {ep} ranks != router {E}")
    C = capacity_for(T, top_k, E, capacity_factor)
    lf = lf or make_linear()

    logits = router_logits(x, w_router)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = route_override if route_override is not None else top_k_route(logits, top_k)
    top_i = top_i.to(x.device)
    pos, keep = _bucket_assignments(top_i, E, C)
    w_eff = torch.where(keep, top_w.to(x.device), 0.0)

    # scatter into [E, C, H]: an over-capacity assignment goes to slot C,
    # a row past the buffer that is cut off (the reference's mode="drop")
    dispatch = torch.zeros((E, C + 1, H), dtype=x.dtype, device=x.device)
    t_idx = torch.arange(T, device=x.device)[:, None].expand(T, top_k)
    dispatch[top_i.long(), torch.where(keep, pos, C).long()] = x[t_idx]
    dispatch = dispatch[:, :C].reshape(ep, e_local, C, H)

    received = ep_axis.all_to_all(dispatch)  # [ep sources, E/ep, C, H]
    tokens_in = received.transpose(0, 1).reshape(e_local, ep * C, H)
    outs = torch.stack([
        _expert_ffn(tokens_in[e], {k: v[e] for k, v in experts.items()}, ffn_sub, eps, lf)
        for e in range(e_local)])
    outs = outs.reshape(e_local, ep, C, H).transpose(0, 1)
    returned = ep_axis.all_to_all(outs).reshape(E, C, H)

    # dropped assignments gather slot C-1's row but carry weight 0. The
    # combine is the reference's ``sum(gathered * w_eff.astype(x.dtype))``
    # as XLA computes it: the products and their sum over k in f32, rounded
    # to x.dtype once (its output, not a rounding at each op)
    gathered = returned[top_i.long(), pos.clamp(0, C - 1).long()]  # [T, k, H]
    w = w_eff[..., None].to(gathered.dtype).float()
    y = (gathered.float() * w).sum(dim=1)
    aux = ep_axis.psum(load_balancing_loss(probs, top_i, E).reshape(1))[0] / ep
    return y.to(x.dtype), aux


def make_ep_moe(mesh, experts, ffn_sub, w_router, *, ep_axis: str = "expert",
                top_k: int = 2, capacity_factor: float = 2.0, eps: float = 1e-5):
    """``apply(x [T, H]) -> (y [T, H], aux)`` on this rank of ``mesh``'s
    ``ep_axis``: the rank keeps experts ``[i*E/ep, (i+1)*E/ep)`` on the
    mesh's device (the router and ``ffn_sub`` whole), runs ``ep_moe_ffn`` on
    its ``T/ep`` rows of ``x`` and returns the whole ``y``, gathered over
    the axis, on every rank. Raises ``ValueError`` if ``ep`` does not divide
    the experts or the tokens."""
    ax = mesh.axis[ep_axis]
    if experts["gate_qw"].shape[0] % ax.size:
        raise ValueError(f"{experts['gate_qw'].shape[0]} experts are not divisible by "
                         f"{ep_axis} size {ax.size}")
    experts = {k: shard_leaf(v, (ep_axis,), mesh) for k, v in experts.items()}
    ffn_sub = shard_leaf(ffn_sub, (), mesh)
    w_router = shard_leaf(w_router, (), mesh)

    def apply(x):
        T = x.shape[0]
        if T % ax.size:
            raise ValueError(f"{T} tokens are not divisible by {ep_axis} size {ax.size}")
        n = T // ax.size
        mine = x[ax.index * n:(ax.index + 1) * n].to(mesh.device)
        y, aux = ep_moe_ffn(mine, experts, ffn_sub, w_router, ep_axis=ax, top_k=top_k,
                            capacity_factor=capacity_factor, eps=eps)
        return ax.all_gather(y, dim=0), aux

    return apply
