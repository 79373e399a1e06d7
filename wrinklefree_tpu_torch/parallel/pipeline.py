"""Pipeline parallelism: GPipe-style microbatched stages over a mesh axis
(PyTorch port of ``wrinklefree_tpu/parallel/pipeline.py``).

Every rank is one stage of the ``stage`` axis of a ``NamedMesh``
(``parallel.sharding.make_named_mesh({"stage": S})``) and runs this
module's program on its own shard (SPMD), as the reference's ``shard_map``
body runs on each device:

- ``shard_params_pp``: stage s keeps layers ``[s*L/S, (s+1)*L/S)`` of every
  stacked ``params["layers"]`` leaf; the embedding, the final norm and the
  head stay whole on every stage.
- ``make_pp_forward``: the batch is cut into M microbatches; over ``S+M-1``
  ticks each stage runs its layers on microbatch ``t - s`` (when there is
  one) and shifts its activations one stage on around the ring
  (``Axis.ppermute``); then the last stage's hidden state is broadcast to
  every stage, which applies the final norm and the head, so every stage
  returns the same f32 logits (the reference's replicated output).

The layer body is the reference's own (``pipeline.py:105-131``), not
``forward``'s: seven unfused linears, ``models.bitnet._attention`` over the
whole cache, the ``silu`` and ``sub_norms`` branches. The linears are
``ops.ternary_cuda.make_linear()``: K7 on CUDA tensors (its GEMV up to 8
rows, its tensor-core GEMM above), the plain ``ternary_linear`` arithmetic
on the CPU. The reference computes its layers on every tick and discards the
inactive ones with ``where``; here a stage runs them only on its active
ticks, and still takes part in every tick's shift, or the ring would hang.
The reference replicates the parameters over any other mesh axis; so does
this port (no tensor parallelism inside a stage).
"""

from __future__ import annotations

import torch

from ..config import BitNetConfig
from ..models.bitnet import KVCache, _attention, compute_logits
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_cos_sin
from ..ops.ternary_cuda import make_linear
from .sharding import shard_leaf

STAGE = "stage"


def stage_partition_specs(params) -> dict:
    """The reference's specs as tuples of axis names: every layer stack on
    its leading [L] axis over ``stage``, the embedding, the final norm and
    the head whole."""
    specs = {"embed": (), "final_norm": ()}
    if "lm_head" in params:
        specs["lm_head"] = ()
    specs["layers"] = {k: (STAGE,) for k in params["layers"]}
    return specs


def shard_params_pp(params, mesh):
    """This rank's stage of ``params`` (``stage_partition_specs``; leaves
    without a spec whole), each leaf a contiguous copy on the mesh's
    device."""
    specs = stage_partition_specs(params)

    def walk(tree, sp):
        if isinstance(tree, dict):
            return {k: walk(v, (sp or {}).get(k)) for k, v in tree.items()}
        return shard_leaf(tree, sp or (), mesh)

    return walk(params, specs)


def make_pp_forward(cfg: BitNetConfig, mesh, *, num_microbatches: int = 2,
                    axis: str = STAGE, logits_all: bool = False):
    """Build ``f(params, tokens [B, S], cache, start [B]) -> (logits,
    cache)`` for this rank's stage. ``params`` is ``shard_params_pp``'s;
    ``cache`` this stage's ``KVCache`` of ``L/S`` layers ``[L/S, B, T, KV,
    D]``, updated in place and returned; ``tokens`` and ``start`` the whole
    batch, the same on every stage. The logits (``[B, V]``, or ``[B, S, V]``
    with ``logits_all``) come back whole on every stage. Every stage of the
    axis calls ``f`` together. Raises ``ValueError`` if the stages do not
    divide the layers or the microbatches the batch."""
    ax = mesh.axis[axis]
    S = ax.size
    if cfg.num_layers % S:
        raise ValueError(f"num_layers {cfg.num_layers} % stages {S} != 0")
    M = num_microbatches
    lf = make_linear()
    D, eps = cfg.head_dim, cfg.rms_norm_eps
    ring = [(i, (i + 1) % S) for i in range(S)]

    def run_local_layers(lp, h, ck, cv, start_v):
        """The stage's layers on one microbatch h [mb, S_len, H]; ck/cv
        [L/S, mb, T, KV, D] views of the cache, written in place."""
        mb, s_len = h.shape[:2]
        positions = (start_v[:, None]
                     + torch.arange(s_len, device=h.device, dtype=torch.int32)[None, :])
        cos, sin = rope_cos_sin(positions, D, cfg.rope_theta, cfg.dtype)
        b_idx = torch.arange(mb, device=h.device)[:, None].expand(mb, s_len)
        for l in range(lp["o_qw"].shape[0]):
            def lin(x, name):
                return lf(x, lp[f"{name}_qw"][l], lp[f"{name}_scale"][l])

            normed = rms_norm(h, lp["input_ln"][l], eps)
            q = lin(normed, "q").reshape(mb, s_len, -1, D)
            k = lin(normed, "k").reshape(mb, s_len, -1, D)
            v = lin(normed, "v").reshape(mb, s_len, -1, D)
            q, k = apply_rope(q, k, cos, sin)
            ck[l].index_put_((b_idx, positions.long()), k.to(ck.dtype))
            cv[l].index_put_((b_idx, positions.long()), v.to(cv.dtype))
            attn = _attention(q, ck[l], cv[l], positions, cfg).reshape(mb, s_len, -1)
            if cfg.sub_norms:
                attn = rms_norm(attn, lp["attn_sub"][l], eps)
            h = h + lin(attn, "o")
            normed = rms_norm(h, lp["post_ln"][l], eps)
            gate, up = lin(normed, "gate"), lin(normed, "up")
            if cfg.mlp_act == "silu":
                act = torch.nn.functional.silu(gate) * up
            else:
                act = torch.square(torch.relu(gate)) * up
            if cfg.sub_norms:
                act = rms_norm(act, lp["ffn_sub"][l], eps)
            h = h + lin(act, "down")
        return h

    def apply(params, tokens, cache: KVCache, start):
        stage = ax.index
        B, s_len = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} is not divisible by {M} microbatches")
        mb, H = B // M, cfg.hidden_size
        dev = params["embed"].device
        tokens = tokens.to(dev)
        start_mb = start.to(device=dev, dtype=torch.int32).reshape(M, mb)
        lp = params["layers"]
        l_local, T = cache.k.shape[0], cache.k.shape[2]
        ck = cache.k.view(l_local, M, mb, T, -1, D)
        cv = cache.v.view(l_local, M, mb, T, -1, D)
        hidden0 = (params["embed"][tokens.long()].to(cfg.dtype).reshape(M, mb, s_len, H)
                   if stage == 0 else None)
        outputs = torch.zeros((M, mb, s_len, H), dtype=cfg.dtype, device=dev)
        carry = torch.zeros((mb, s_len, H), dtype=cfg.dtype, device=dev)
        for t in range(S + M - 1):
            incoming = ax.ppermute(carry, ring)  # stage 0 ignores what it receives
            m = t - stage
            if not 0 <= m < M:
                carry = incoming
                continue
            h_in = hidden0[m] if stage == 0 else incoming
            carry = run_local_layers(lp, h_in, ck[:, m], cv[:, m], start_mb[m])
            if stage == S - 1:
                outputs[m] = carry
        # the last stage's hidden state on every stage (the reference's psum
        # of zeros elsewhere: the same bits)
        hidden = ax.broadcast(outputs.reshape(B, s_len, H), S - 1)
        hidden = rms_norm(hidden, params["final_norm"], eps)
        if not logits_all:
            hidden = hidden[:, -1]
        return compute_logits(hidden, params, cfg), KVCache(cache.k, cache.v)

    return apply
