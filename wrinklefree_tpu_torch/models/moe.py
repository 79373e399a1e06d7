"""BitNet MoE: ternary experts, top-k routing, identity-router oracle (PyTorch port).

Counterpart of ``wrinklefree_tpu/models/moe.py``:

- ``router_logits`` / ``top_k_route`` / ``identity_route`` and the
  Switch-style ``load_balancing_loss``;
- ``moe_ffn``: the ReLU^2 ternary expert FFN with the top-k weighted
  combine, dense dispatch (every expert sees every token, as in the
  reference), written as a loop over the experts;
- ``init_moe_experts`` (numpy ``default_rng``: the reference's values, bit
  for bit), ``make_fake_moe`` and ``verify_moe_matches_dense``, the
  fake-MoE identity oracle, and ``fake_moe_model``, the oracle at model
  level.

With ``ep_axis`` (a ``parallel.sharding.Axis``; under tensor parallelism the
model axis) each rank holds its E/ep experts, combines their outputs with
its slice of the combine matrix in f32, and the ranks sum the partials.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import BitNetConfig
from ..ops.norms import rms_norm
from ..ops.ternary import pack_ternary_np, quantize_weights_ternary, ternary_linear
from .bitnet import resolve_device

EXPERT_KEYS = tuple(f"{n}_{t}" for n in ("gate", "up", "down") for t in ("qw", "scale"))


# ---------------------------------------------------------------------------
# Routers
# ---------------------------------------------------------------------------


def router_logits(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """x [T, H] @ w_router [H, E] -> f32 [T, E]; the router stays full
    precision, as in the reference. The products of the f32 inputs are
    summed in f64 and rounded to f32 once: never TF32 or a reduced-precision
    CPU product, whatever the process's matmul settings, so routing
    near-ties do not move with them."""
    return torch.matmul(x.double(), w_router.double()).float()


def top_k_route(
    logits: torch.Tensor, k: int, *, jitter: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax, then top-k, then renormalise. Returns (weights [T, k] f32
    summing to 1, expert ids [T, k] int32). Ties go to the lower expert id,
    as ``jax.lax.top_k`` orders them (a stable descending sort): a zero
    router picks experts 0..k-1. ``jitter`` draws from ``generator`` (other
    numbers than the reference's ``jax.random`` stream)."""
    logits = logits.float()
    if jitter > 0.0 and generator is not None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        logits = logits + (u * (2 * jitter) - jitter)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w = vals[..., :k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return top_w, idx[..., :k].to(torch.int32)


def identity_route(num_tokens: int, k: int, expert: int = 0, device=None):
    """All tokens to one expert with weight 1 (the MoE test harness)."""
    w = torch.zeros((num_tokens, k), dtype=torch.float32, device=device)
    w[:, 0] = 1.0
    i = torch.full((num_tokens, k), expert, dtype=torch.int32, device=device)
    return w, i


def load_balancing_loss(router_probs: torch.Tensor, expert_idx: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """Switch/Mixtral aux loss: E * sum(frac_tokens_e * mean_prob_e) over
    the top-1 assignment."""
    onehot = torch.nn.functional.one_hot(expert_idx[:, 0].long(), num_experts).float()
    return num_experts * torch.sum(onehot.mean(dim=0) * router_probs.mean(dim=0))


# ---------------------------------------------------------------------------
# Expert FFN
# ---------------------------------------------------------------------------


def _expert_ffn(x, ew, ffn_sub, eps, lf=None):
    """One ReLU^2 ternary expert: gate/up -> relu(gate)^2 * up (bf16 ops) ->
    sub-norm -> down, every linear through ``lf(x, qweight, scale)``
    (default: the exact torch ``ternary_linear``)."""
    lin = lf or (lambda a, qw, s: ternary_linear(a, qw, s))
    gate = lin(x, ew["gate_qw"], ew["gate_scale"])
    up = lin(x, ew["up_qw"], ew["up_scale"])
    act = torch.square(torch.relu(gate)) * up
    act = rms_norm(act, ffn_sub, eps)
    return lin(act, ew["down_qw"], ew["down_scale"])


def moe_ffn(
    x: torch.Tensor,  # [T, H]
    experts: Dict[str, torch.Tensor],  # {gate,up,down}_{qw,scale} with a leading [E] axis
    ffn_sub: torch.Tensor,  # [I]
    w_router: torch.Tensor,  # [H, E] f32
    *,
    top_k: int = 2,
    eps: float = 1e-5,
    route_override=None,  # (weights [T, k], ids [T, k]) for the identity oracle
    lf=None,
    ep_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-dispatch MoE FFN: every expert processes every token, then a
    [T, E] combine matrix (zeros except the routed weights) weights them.

    The combine is built in ``x.dtype`` from the routing weights rounded to
    it, the experts' outputs are summed in f32 in expert order, and the sum
    is cast back to ``x.dtype``, as the reference's einsum does.

    ``lf`` is the reference's hook for the experts' linear, ``(x, qweight
    [K/4, N], scale) -> out``. The port uses it to choose the kernel, not to
    change the function: on the card ``paged_forward`` passes
    ``ops.ternary_cuda.make_linear()``, which runs each expert dot as one K7
    launch on a ``[K/4, N]`` view of the ``[E, K/4, N]`` stack (no copy)
    and computes what the default exact ``ternary_linear`` computes, bit for
    bit. Returns (output [T, H], aux loss).

    With ``ep_axis`` (expert parallelism) ``experts`` holds this rank's E/ep
    experts (a contiguous block, the rank's index times E/ep on): the rank
    sums their outputs weighted by its columns of the combine matrix in f32,
    and the ranks' f32 partials are summed over the axis before the cast,
    as the reference's psum."""
    T = x.shape[0]
    E = w_router.shape[1]
    logits = router_logits(x, w_router)
    probs = torch.softmax(logits, dim=-1)
    if route_override is not None:
        top_w, top_i = route_override
    else:
        top_w, top_i = top_k_route(logits, top_k)

    combine = torch.zeros((T, E), dtype=x.dtype, device=x.device)
    t_idx = torch.arange(T, device=x.device)[:, None].expand(top_i.shape)
    combine.index_put_((t_idx, top_i.long()), top_w.to(x.dtype), accumulate=True)

    e_local = experts["gate_qw"].shape[0]
    e0 = 0
    if ep_axis is not None:
        if e_local * ep_axis.size != E:
            raise ValueError(f"{e_local} local experts x {ep_axis.size} ranks != router {E}")
        e0 = ep_axis.index * e_local
    elif e_local != E:
        raise ValueError(f"experts {e_local} != router {E} (missing ep_axis?)")
    y = torch.zeros((T, x.shape[-1]), dtype=torch.float32, device=x.device)
    for e in range(e_local):
        out = _expert_ffn(x, {k: v[e] for k, v in experts.items()}, ffn_sub, eps, lf)
        y = y + combine[:, e0 + e:e0 + e + 1].float() * out.float()
    if ep_axis is not None:
        y = ep_axis.psum(y)
    return y.to(x.dtype), load_balancing_loss(probs, top_i, E)


def expert_linear(lf):
    """The experts' linear for a model's ``linear_fn``: an unstacked one
    serves as it is; a stacked one names its own in ``.expert_linear``
    (``ops.ternary_cuda.make_linear_stacked``), else None (the default exact
    ``ternary_linear``)."""
    if getattr(lf, "stacked", False):
        return getattr(lf, "expert_linear", None)
    return lf


def moe_layer(x: torch.Tensor, stack: Dict[str, torch.Tensor], layer: int,
              cfg: BitNetConfig, lf=None, ep_axis=None) -> torch.Tensor:
    """The MoE MLP of layer ``layer`` of the stacked params on normed rows
    x [T, H] (the models' layer step; the aux loss is dropped); with
    ``ep_axis`` the stack holds this rank's experts."""
    experts = {k: stack[f"moe_{k}"][layer] for k in EXPERT_KEYS}
    y, _ = moe_ffn(x, experts, stack["ffn_sub"][layer], stack["router"][layer],
                   top_k=cfg.num_experts_per_tok, eps=cfg.rms_norm_eps, lf=lf,
                   ep_axis=ep_axis)
    return y


# ---------------------------------------------------------------------------
# Construction / fake-MoE converter
# ---------------------------------------------------------------------------


def init_moe_experts(cfg: BitNetConfig, num_experts: int, seed: int = 0, device=None):
    """Random ternary experts stacked on a leading [E] axis, and an [H, E]
    f32 router, on ``device`` (default CUDA). Drawn with numpy in the
    reference's order, so the values equal the reference's bit for bit."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    H, I = cfg.hidden_size, cfg.intermediate_size

    def proj(k, n):
        w = rng.normal(0, 0.02, size=(k, n)).astype(np.float32)
        tern, scale = quantize_weights_ternary(w)
        return pack_ternary_np(tern), np.float32(scale)

    packs = {f"{nm}_qw": [] for nm in ("gate", "up", "down")}
    scales = {f"{nm}_scale": [] for nm in ("gate", "up", "down")}
    dims = {"gate": (H, I), "up": (H, I), "down": (I, H)}
    for _ in range(num_experts):
        for nm, (kk, nn_) in dims.items():
            qw, sc = proj(kk, nn_)
            packs[f"{nm}_qw"].append(qw)
            scales[f"{nm}_scale"].append(sc)
    experts = {k: torch.from_numpy(np.stack(v)).to(dev) for k, v in packs.items()}
    experts.update({k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                    for k, v in scales.items()})
    router = torch.from_numpy(
        rng.normal(0, 0.02, size=(H, num_experts)).astype(np.float32)).to(dev)
    return experts, router


def make_fake_moe(dense_layer: Dict, num_experts: int):
    """E identical experts from one dense FFN's weights (expanded views, no
    copy). With an identity router the MoE must equal the dense FFN."""
    experts = {}
    for nm in ("gate", "up", "down"):
        qw = dense_layer[f"{nm}_qw"]
        sc = torch.as_tensor(dense_layer[f"{nm}_scale"], dtype=torch.float32, device=qw.device)
        experts[f"{nm}_qw"] = qw[None].expand((num_experts,) + tuple(qw.shape))
        experts[f"{nm}_scale"] = sc.reshape(1).expand(num_experts)
    return experts


def fake_moe_model(dense_params, cfg: BitNetConfig, num_experts: int):
    """The fake-MoE model of a dense one (the model-level oracle of the
    reference's tests/test_moe_model.py): every layer's MLP becomes
    ``num_experts`` identical experts (expanded views of its weights, no
    copy) behind a zero router. Top-k routing then weighs k copies of the
    dense MLP's output by exactly 1/k each, so the model's logits equal the
    dense model's. Returns (MoE config, params)."""
    layers = dict(dense_params["layers"])
    L, E = layers["o_qw"].shape[0], num_experts
    for n in ("gate", "up", "down"):
        qw, sc = layers.pop(f"{n}_qw"), layers.pop(f"{n}_scale")
        layers[f"moe_{n}_qw"] = qw[:, None].expand((L, E) + tuple(qw.shape[1:]))
        layers[f"moe_{n}_scale"] = sc[:, None].expand(L, E)
    layers["router"] = torch.zeros((L, cfg.hidden_size, E), dtype=torch.float32,
                                   device=layers["o_qw"].device)
    return dataclasses.replace(cfg, num_experts=E), {**dense_params, "layers": layers}


def verify_moe_matches_dense(
    dense_layer: Dict, cfg: BitNetConfig, num_experts: int = 4, tol: float = 0.0, lf=None
) -> bool:
    """Identity-router oracle: the fake MoE routed to expert 0 against the
    dense FFN on 8 random rows; True when they differ by at most ``tol``."""
    dev = dense_layer["gate_qw"].device
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, cfg.hidden_size))).to(device=dev, dtype=cfg.dtype)
    dense_out = _expert_ffn(x, {k: dense_layer[k] for k in EXPERT_KEYS},
                            dense_layer["ffn_sub"], cfg.rms_norm_eps, lf)
    experts = make_fake_moe(dense_layer, num_experts)
    w_router = torch.zeros((cfg.hidden_size, num_experts), dtype=torch.float32, device=dev)
    moe_out, _ = moe_ffn(
        x, experts, dense_layer["ffn_sub"], w_router, top_k=1,
        route_override=identity_route(x.shape[0], 1, expert=0, device=dev),
        eps=cfg.rms_norm_eps, lf=lf,
    )
    diff = float((moe_out.float() - dense_out.float()).abs().max())
    return diff <= tol
