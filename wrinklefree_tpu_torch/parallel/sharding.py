"""Tensor and data parallelism on ``torch.distributed`` (PyTorch port).

Counterpart of ``wrinklefree_tpu/parallel/sharding.py``. The reference is
single-controller: one program leads a ``jax.sharding.Mesh`` through
``shard_map``. Here every rank is a process that runs the same program on
its own shard (SPMD), and the mesh is a set of process groups:

- ``make_mesh(n_data, n_model)`` lays the world's ranks out as
  ``[n_data, n_model]``, the model axis innermost (a model group is
  ``n_model`` consecutive ranks, so it stays on one host under ``torchrun``),
  and returns this rank's ``Mesh``: its model and data ``Axis``, its device,
  and a gloo side group of its model ranks for host messages (the engine's
  lockstep, ``engine/lockstep.py``).
- An ``Axis`` is what the models take as ``tp_axis``, ``quant_axis`` and
  ``ep_axis``: the rank's index on the axis and the reference's collectives
  mapped one to one onto the axis's group (``psum`` -> ``all_reduce(SUM)``,
  ``pmax``/``pmin`` -> ``all_reduce(MAX/MIN)``, a tiled ``all_gather`` ->
  ``all_gather_into_tensor`` with the shards laid along the axis in rank
  order, ``ppermute`` -> one batch of isend/irecv, ``all_to_all`` ->
  ``all_to_all_single``; ``broadcast``, the bits of the pipeline's psum of
  zeros). The tensors stay on the rank's device: NCCL moves them between
  cards; gloo, which a caller may choose for CUDA tensors (two ranks on one
  card), copies them through the host by itself for its collectives, and
  the axis copies them for its point-to-point transfers, which cannot read
  CUDA memory.
- ``make_named_mesh({name: size, ...})`` lays the world out as a mesh with
  named axes (the pipeline's ``stage``, expert parallelism's ``expert``),
  each an ``Axis``.
- TP layout (Megatron-style, as the reference's): q/k/v/gate/up
  column-parallel (the packed [K/4, N] sharded on N), o/down row-parallel
  (sharded on K/4, partial outputs summed in f32), the embedding and the
  heads vocab-sharded, the norms whole except ``attn_sub``/``ffn_sub``, which
  span the sharded axis. ``shard_params`` slices every leaf to this rank's
  shard: there is no global array, each rank holds its shard as a plain
  tensor on its device.

The plane-major packing encodes offsets relative to the K axis it was packed
over (``ops/ternary.py``), so a contiguous K/4 slice of an o/down matrix is
not the local matrix: ``repack_params_for_tp`` packs each K/tp chunk on its
own first, after which a contiguous slice is exactly the local packed
matrix K7 expects.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import socket
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import BitNetConfig
from ..ops.ring_attention import exchange
from ..ops.ternary import pack_ternary_np, unpack_ternary_np

DATA, MODEL = "data", "model"

COL_PARALLEL = ("q", "k", "v", "gate", "up")
ROW_PARALLEL = ("o", "down")


def tp_kv_replicated(cfg: BitNetConfig, tp: int) -> bool:
    """The KV layout for a TP degree: True when ``tp`` does not divide the
    KV heads (BitNet-2B's 5 at tp 2 and 4). k/v projections and the KV pools
    are then replicated over the model axis while the query heads (and o,
    gate, up, down, the embedding) stay sharded: each rank scatters its local
    query heads into the full head layout for attention and slices its own
    back out for the row-parallel o projection. Raises ``ValueError`` if
    ``tp`` cannot split the query heads."""
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by tp={tp}")
    return bool(cfg.num_kv_heads % tp)


class Axis:
    """One axis of a ``Mesh`` on this rank: ``index`` and ``size`` on the
    axis, its process ``group``, the global ``ranks`` along it, and the
    reference's collectives over it. Each collective counts one in
    ``calls[op]``. ``Axis.local(name)`` is an axis of this process alone
    (no group, size 1): its collectives are identities."""

    def __init__(self, name: str, group, index: int, size: int, ranks):
        if group is None and size != 1:
            raise ValueError("an axis of more than one rank needs a process group")
        self.name = name
        self.group = group
        self.index = index
        self.size = size
        self.ranks = tuple(ranks)
        self.calls = collections.Counter()

    @classmethod
    def local(cls, name: str = MODEL) -> "Axis":
        return cls(name, None, 0, 1, (0,))

    def __repr__(self):
        return f"Axis({self.name!r}, index={self.index}, size={self.size})"

    def _reduce(self, x: torch.Tensor, op, what: str) -> torch.Tensor:
        self.calls[what] += 1
        if self.group is None:
            return x
        if not x.is_contiguous():
            x = x.contiguous()
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the axis (``lax.psum``), in place on ``x``: pass a tensor
        the caller no longer needs."""
        return self._reduce(x, dist.ReduceOp.SUM, "psum")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum over the axis (``lax.pmax``), in place on ``x``."""
        return self._reduce(x, dist.ReduceOp.MAX, "pmax")

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """Minimum over the axis (``lax.pmin``), in place on ``x``."""
        return self._reduce(x, dist.ReduceOp.MIN, "pmin")

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Tiled ``lax.all_gather``: every rank's ``x`` laid along ``dim`` in
        rank order (a new tensor)."""
        if self.group is None:
            self.calls["all_gather"] += 1
            return x
        xm = x.movedim(dim, 0).contiguous()
        out = torch.empty((self.size * xm.shape[0],) + tuple(xm.shape[1:]), dtype=x.dtype,
                          device=x.device)
        self.calls["all_gather"] += 1
        dist.all_gather_into_tensor(out, xm, group=self.group)
        return out.movedim(0, dim)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """``lax.ppermute``: ``perm`` holds (source, destination) pairs of
        axis indexes; this rank sends ``x`` to its destination and returns
        what its source sent (zeros where no pair sends to it), a new
        tensor. The pipeline's ring shift is ``[(i, (i + 1) % size)]``."""
        self.calls["ppermute"] += 1
        dst = next((d for s_, d in perm if s_ == self.index), None)
        src = next((s_ for s_, d in perm if d == self.index), None)
        if self.size == 1:  # no process to talk to (NCCL would send to itself)
            return x.clone() if src == 0 else torch.zeros_like(x)
        (out,) = exchange([x], self.group, dst, src)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_to_all(x, split_axis=0, concat_axis=0)``: ``x``'s
        leading axis cut into ``size`` blocks, block j sent to axis index j;
        the blocks received laid along axis 0 in source order (a new
        tensor)."""
        self.calls["all_to_all"] += 1
        if self.size == 1:
            return x.clone()
        if x.shape[0] % self.size:
            raise ValueError(f"all_to_all: leading axis {x.shape[0]} not divisible by "
                             f"{self.size}")
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Axis index ``src``'s ``x`` on every rank, in place on ``x`` (the
        bits of a ``psum`` that adds zeros from every other rank)."""
        self.calls["broadcast"] += 1
        if self.size == 1:
            return x
        if not x.is_contiguous():
            x = x.contiguous()
        dist.broadcast(x, src=self.ranks[src], group=self.group)
        return x


@dataclasses.dataclass
class Mesh:
    """This rank's view of a ``[n_data, n_model]`` mesh (the reference's
    ``Mesh`` with axes ('data', 'model')). ``shape`` maps the axis names to
    their sizes, as ``jax.sharding.Mesh.shape`` does. ``control`` is a gloo
    group of this rank's model ranks for host messages; ``leader`` the
    global rank of model index 0 (the engine's leader)."""

    shape: dict
    model: Axis
    data: Axis
    device: torch.device
    backend: str
    control: object
    leader: int

    @property
    def axis(self):
        return {MODEL: self.model, DATA: self.data}


def _rank_device(device, rank: int) -> torch.device:
    """``device`` with its CUDA index filled in; by default
    ``cuda:(LOCAL_RANK % device count)``, the CPU without CUDA."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _world(n: int, device, backend: Optional[str], what: str):
    """The default group's (rank, device, backend) for a mesh of ``n`` ranks,
    as ``make_mesh`` documents, and a gloo group of the whole world."""
    if n < 1:
        raise ValueError(f"mesh {what} has no ranks")
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"torch.distributed is not initialized: a mesh of {n} ranks "
                             "needs them started (torchrun) and init_multihost() called")
        be = backend or ("nccl" if _rank_device(device, 0).type == "cuda" else "gloo")
        path = os.path.join(tempfile.mkdtemp(prefix="wf_mesh_"), "store")
        dist.init_process_group(be, store=dist.FileStore(path, 1), rank=0, world_size=1)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"mesh {what} needs {n} ranks, the default process group has {world}")
    dev = _rank_device(device, rank)
    be = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if be == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs CUDA devices, got {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # every rank creates every group, in one order
    world_gloo = dist.new_group(list(range(world)), backend="gloo")
    places = [None] * world
    dist.all_gather_object(places, (socket.gethostname(), str(dev)), group=world_gloo)
    if be == "nccl":
        seen = {}
        for r, p in enumerate(places):
            if p in seen and p[1].startswith("cuda"):
                raise ValueError(
                    f"ranks {seen[p]} and {r} share {p[1]} on {p[0]}: NCCL refuses two ranks on "
                    "one GPU; give each rank its own card, or pass backend='gloo' (which copies "
                    "CUDA tensors through the host)")
            seen[p] = r
    return rank, dev, be


def make_mesh(n_data: int = 1, n_model: int = 1, *, device=None,
              backend: Optional[str] = None) -> Mesh:
    """This rank's ``Mesh`` over the default process group's
    ``n_data * n_model`` ranks, laid out ``[n_data, n_model]`` (rank r at
    data ``r // n_model``, model ``r % n_model``). Every rank of the world
    calls it, with the same arguments.

    ``device`` defaults to ``cuda:(LOCAL_RANK % device count)`` (the CPU
    without CUDA), ``backend`` to NCCL on CUDA and gloo on the CPU. A caller
    may ask for gloo on CUDA tensors (several ranks on one card: gloo copies
    them through the host); NCCL refuses two ranks on one GPU, so asking for
    it there raises ``ValueError``. It never switches backend by itself.

    Without an initialized default group a mesh of one forms a group of one
    (its rendezvous a ``FileStore`` under a fresh temporary directory); a
    larger mesh raises (start the ranks under ``torchrun`` and call
    ``parallel.multihost.init_multihost()`` first)."""
    n = n_data * n_model
    rank, dev, be = _world(n, device, backend, f"({n_data}, {n_model})")
    d, m = divmod(rank, n_model)
    model_ranks = [[dd * n_model + mm for mm in range(n_model)] for dd in range(n_data)]
    data_ranks = [[dd * n_model + mm for dd in range(n_data)] for mm in range(n_model)]
    controls = [dist.new_group(rs, backend="gloo") for rs in model_ranks]
    models = [dist.new_group(rs, backend=be) for rs in model_ranks]
    datas = [dist.new_group(rs, backend=be) for rs in data_ranks]
    return Mesh(
        shape={DATA: n_data, MODEL: n_model},
        model=Axis(MODEL, models[d], m, n_model, model_ranks[d]),
        data=Axis(DATA, datas[m], d, n_data, data_ranks[m]),
        device=dev, backend=be, control=controls[d], leader=model_ranks[d][0])


@dataclasses.dataclass
class NamedMesh:
    """This rank's view of a mesh with named axes (the reference's
    ``Mesh(devices, names)``, such as its pipeline's 1-D ``('stage',)`` and
    its expert parallelism's ``('expert',)``): ``shape`` maps each name to
    its size, ``axis`` each name to this rank's ``Axis`` on it."""

    shape: dict
    axis: dict
    device: torch.device
    backend: str


def make_named_mesh(axes: dict, *, device=None, backend: Optional[str] = None) -> NamedMesh:
    """This rank's ``NamedMesh`` over the default group's ranks, laid out
    row-major over ``axes`` ({name: size}, the last axis innermost: with
    ``{"stage": 2, "model": 2}`` rank r sits at stage ``r // 2``, model
    ``r % 2``). Every rank calls it with the same arguments; the world, the
    device and the backend follow ``make_mesh``'s rules."""
    names, sizes = list(axes), [int(v) for v in axes.values()]
    rank, dev, be = _world(int(np.prod(sizes)), device, backend, str(dict(axes)))
    coords = np.unravel_index(rank, sizes)
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    out = {}
    for a, name in enumerate(names):
        lines = np.moveaxis(grid, a, -1).reshape(-1, sizes[a])
        groups = [dist.new_group(line.tolist(), backend=be) for line in lines]
        mine = next(i for i, line in enumerate(lines) if rank in line)
        out[name] = Axis(name, groups[mine], int(coords[a]), sizes[a], lines[mine].tolist())
    return NamedMesh(shape=dict(zip(names, sizes)), axis=out, device=dev, backend=be)


def repack_params_for_tp(params, tp: int):
    """Re-pack the row-parallel projections (o, down) so that each K/tp
    shard is plane-major within itself (the module docstring): each layer's
    matrix unpacked on the host (numpy), split into ``tp`` K chunks, each
    packed on its own. No-op for ``tp == 1``. MoE expert stacks are sharded
    on the expert axis and keep their full K: they need no repacking."""
    if tp == 1:
        return params
    layers = dict(params["layers"])
    for name in ROW_PARALLEL:
        key = f"{name}_qw"
        if key not in layers:
            continue  # MoE layers: the experts replace the dense MLP
        t = layers[key]
        qw = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        L, k4, n = qw.shape
        if (k4 * 4) % (4 * tp):
            raise ValueError(f"{name}: K={k4 * 4} not divisible by 4*tp={4 * tp}")
        out = np.empty_like(qw)
        for l in range(L):
            chunks = np.split(unpack_ternary_np(qw[l]), tp, axis=0)
            out[l] = np.concatenate([pack_ternary_np(c) for c in chunks], axis=0)
        layers[key] = (torch.from_numpy(out).to(t.device) if isinstance(t, torch.Tensor)
                       else out)
    return {**params, "layers": layers}


def param_partition_specs(params, kv_replicated: bool = False) -> dict:
    """The reference's partition specs, as tuples of axis names (None: not
    sharded) mirroring the params tree: q/k/v/gate/up on N (k/v whole when
    ``kv_replicated``), o/down on K/4, MoE stacks on the expert axis, the
    router and the norms whole except ``attn_sub`` (and ``ffn_sub`` of a
    dense model) on their last axis, the embedding and the heads on the
    vocabulary. ``shard_params`` slices by them."""
    layers = params["layers"]
    lsp = {}
    for name in COL_PARALLEL:
        if f"{name}_qw" in layers:
            whole = kv_replicated and name in ("k", "v")
            lsp[f"{name}_qw"] = (None, None, None) if whole else (None, None, MODEL)
            lsp[f"{name}_scale"] = (None,)
    for name in ROW_PARALLEL:
        if f"{name}_qw" in layers:
            lsp[f"{name}_qw"] = (None, MODEL, None)
            lsp[f"{name}_scale"] = (None,)
    for name in ("gate", "up", "down"):
        if f"moe_{name}_qw" in layers:
            lsp[f"moe_{name}_qw"] = (None, MODEL, None, None)
            lsp[f"moe_{name}_scale"] = (None, MODEL)
    if "router" in layers:
        lsp["router"] = (None, None, None)
    for name in ("input_ln", "post_ln"):
        lsp[name] = (None, None)
    lsp["attn_sub"] = (None, MODEL)
    # expert-parallel experts compute the full intermediate width on a rank
    lsp["ffn_sub"] = (None, None) if "moe_gate_qw" in layers else (None, MODEL)
    specs = {"embed": (MODEL, None), "final_norm": (None,), "layers": lsp}
    if "lm_head" in params:
        specs["lm_head"] = (MODEL, None)
    if "lm_head_q" in params:
        # per-row quantization commutes with a row shard
        specs["lm_head_q"] = (MODEL, None)
        specs["lm_head_s"] = (MODEL,)
    return specs


def shard_leaf(x, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of one leaf (numpy or torch, any device) under
    ``spec``, as a contiguous tensor on the mesh's device."""
    t = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
    for dim, name in enumerate(spec):
        if name is None:
            continue
        ax = mesh.axis[name]
        if t.shape[dim] % ax.size:
            raise ValueError(f"axis {dim} of a {tuple(t.shape)} leaf is not divisible by "
                             f"{name} size {ax.size}")
        n = t.shape[dim] // ax.size
        t = t.narrow(dim, ax.index * n, n)
    # a copy of its own: the whole leaf can be freed once every leaf is sharded
    return t.to(mesh.device).clone(memory_format=torch.contiguous_format)


def shard_params(params, mesh: Mesh, kv_replicated: bool = False):
    """This rank's shard of every leaf (``param_partition_specs``; leaves
    without a spec whole), on the mesh's device. Call
    ``repack_params_for_tp`` first when the model axis is larger than 1."""
    specs = param_partition_specs(params, kv_replicated)

    def walk(tree, sp):
        if isinstance(tree, dict):
            return {k: walk(v, (sp or {}).get(k)) for k, v in tree.items()}
        return shard_leaf(tree, sp or (), mesh)

    return walk(params, specs)


def make_tp_forward(cfg: BitNetConfig, mesh: Mesh, *, linear_fn=None, logits_all=False):
    """``stepper(params, tokens, cache, start_pos) -> (logits, cache)``:
    ``models.bitnet.forward`` on this rank with ``tp_axis`` the mesh's model
    axis. ``params`` and ``cache`` are this rank's shards (``shard_params``;
    the cache [L, B/n_data, T, local KV heads, D]); ``tokens`` [B, S] and
    ``start_pos`` [B] the whole batch, of which the rank runs its data
    shard's rows. The logits come back whole on every rank (gathered over
    the model axis inside the forward, over the data axis here), as the
    reference's replicated output."""
    from ..models.bitnet import forward

    kv_rep = tp_kv_replicated(cfg, mesh.shape[MODEL])
    data = mesh.data

    def stepper(params, tokens, cache, start_pos):
        b = tokens.shape[0] // data.size
        rows = slice(data.index * b, (data.index + 1) * b)
        logits, cache = forward(params, cfg, tokens[rows], cache, start_pos[rows],
                                linear_fn=linear_fn, logits_all=logits_all,
                                tp_axis=mesh.model, tp_kv_replicated=kv_rep)
        if data.size > 1:
            logits = data.all_gather(logits, dim=0)
        return logits, cache

    return stepper
