"""Long-context serving: ring-attention prefill + context-parallel decode
(PyTorch port of ``wrinklefree_tpu/engine/long_context.py``).

Serves requests longer than the paged engine's ``max_context`` by sharding
the sequence over the ranks of a ``torch.distributed`` process group (the
reference's 1-axis ``seq`` mesh; a group of one on a single card):

- **Prefill**: each rank embeds its ``[i*s_loc, (i+1)*s_loc)`` slice of the
  prompt; every layer runs :func:`..ops.ring_attention.ring_attention` (K/V
  blocks rotate around the ring, online-softmax fold), in q-chunks of
  ``PREFILL_Q_CHUNK`` rows, so a rank's scores are ``[KV, G, CQ, s_loc]``
  and the full [S, S] score matrix never exists. The prompt KV stays
  sequence-sharded on the ranks.
- **Decode**: the new token's q attends to (a) the sharded prompt KV through
  per-rank partial online-softmax stats combined with MAX and SUM
  all-reduces (context-parallel attention, O(S/P) work per rank) and (b) a
  small replicated buffer of the generated tokens' KV. Projections are
  replicated compute.

Every projection is ``ternary_linear`` with K7's exact int32 dot
(``ops/ternary_cuda.py::ternary_matmul``): the tensor-core GEMM above 8
rows, the GEMV at 1 row, on the card; its plain version on the CPU. The
int32 accumulators are exact, so the projections equal the reference's XLA
matmul up to the rescale, which is ``ternary_linear``'s own.

Greedy decoding. Exact against the dense forward up to float reduction
order: token-identical in f32 (``tests/test_torch_long_context.py``).

Beyond the reference: every ``s_loc > PREFILL_Q_CHUNK`` is q-chunked (the
last chunk may be shorter), where the reference chunks only when ``s_loc``
is a multiple of the chunk and otherwise materializes ``[KV, G, s_loc,
s_loc]`` f32 scores (about 18 GB for a 15000-token prompt of the 2B model
on one card).
"""

from __future__ import annotations

import math
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import BitNetConfig
from ..models.bitnet import compute_logits, resolve_device
from ..ops.norms import rms_norm
from ..ops.ring_attention import _block_attend, _bshape, group_size_rank, ring_attention
from ..ops.rope import apply_rope, rope_cos_sin
from ..ops.ternary import ternary_linear
from ..ops.ternary_cuda import ternary_matmul

_NEVER = 2**31 - 1  # a key position no query sees
_ALL = 2**30  # a query position that sees every real key


def _merge(m1, l1, a1, m2, l2, a2, bshape):
    """Online-softmax merge of two partial stats (m, l, acc)."""
    m = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m)
    w2 = torch.exp(m2 - m)
    return m, l1 * w1 + l2 * w2, a1 * bshape(w1) + a2 * bshape(w2)


def group_of_one(device) -> "dist.ProcessGroup":
    """The default process group, initialized as a group of one (rank 0 of
    1: NCCL for a CUDA device, gloo otherwise) if ``torch.distributed`` is
    not initialized yet, its rendezvous in a ``FileStore`` under a fresh
    temporary directory (no TCP port). Raises if the default group has more
    than one rank: ``LongContextEngine.generate`` is collective, and a
    caller on one rank alone would hang at its first all-reduce."""
    if dist.is_initialized():
        if dist.get_world_size() > 1:
            raise NotImplementedError(
                f"the default process group has {dist.get_world_size()} ranks: a long-context "
                "caller on one rank would wait for the others at every collective (serving "
                "across ranks is not ported yet)")
    else:
        import tempfile

        path = os.path.join(tempfile.mkdtemp(prefix="wf_group_"), "store")
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0, world_size=1)
    return dist.group.WORLD


class LongContextEngine:
    """Sequence-parallel ``generate()`` for prompts beyond the paged
    engine's ``max_context``.

    ``params``: the model's unfused params (every rank holds them all);
    ``group``: the ``torch.distributed`` process group whose ranks share the
    sequence (None: the default group); every rank calls ``generate`` with
    the same prompt. ``device`` defaults to CUDA and raises without it unless
    the caller asks for the CPU (the gloo backend's device)."""

    # q-chunk width of the blockwise attention inside each ring step: without
    # it a rank's f32 scores are [KV, G, s_loc, s_loc], 21 GB for a 16K
    # prompt of the 2B model on one card; chunked, [KV, G, CQ, s_loc], 1.3 GB
    PREFILL_Q_CHUNK = 1024

    def __init__(self, params, cfg: BitNetConfig, group=None, decode_buf: int = 128,
                 device=None):
        self.device = resolve_device(device)
        if group is None and not dist.is_initialized():
            raise ValueError("torch.distributed is not initialized: pass a process group "
                             "(engine.long_context.group_of_one for one device)")
        layers = params["layers"]
        if "qkv_qw" in layers:
            raise ValueError("LongContextEngine takes unfused params")
        if "gate_qw" not in layers:
            raise ValueError("LongContextEngine takes a dense model's params")
        self.cfg = cfg
        self.group = group
        self.P, self.rank = group_size_rank(group)
        self.decode_buf = decode_buf
        self.params = {
            "embed": params["embed"].to(self.device),
            "final_norm": params["final_norm"].to(self.device),
            "layers": {k: v.to(self.device) for k, v in layers.items()},
            **({"lm_head": params["lm_head"].to(self.device)} if "lm_head" in params else {}),
        }
        self.last_timings = {}

    # -- the pieces ----------------------------------------------------------

    def _proj(self, x, name, l):
        lay = self.params["layers"]
        return ternary_linear(x, lay[f"{name}_qw"][l], lay[f"{name}_scale"][l],
                              out_dtype=self.cfg.dtype, kernel=ternary_matmul)

    def _mlp(self, h, l):
        cfg, lay = self.cfg, self.params["layers"]
        normed = rms_norm(h, lay["post_ln"][l], cfg.rms_norm_eps)
        gate = self._proj(normed, "gate", l)
        up = self._proj(normed, "up", l)
        if cfg.mlp_act == "silu":
            act = torch.nn.functional.silu(gate) * up
        else:
            act = torch.square(torch.relu(gate)) * up
        if cfg.sub_norms:
            act = rms_norm(act, lay["ffn_sub"][l], cfg.rms_norm_eps)
        return h + self._proj(act, "down", l)

    def _qkv(self, h, l, cos, sin):
        cfg = self.cfg
        normed = rms_norm(h, self.params["layers"]["input_ln"][l], cfg.rms_norm_eps)
        B, S = h.shape[:2]
        q = self._proj(normed, "q", l).reshape(B, S, -1, cfg.head_dim)
        k = self._proj(normed, "k", l).reshape(B, S, -1, cfg.head_dim)
        v = self._proj(normed, "v", l).reshape(B, S, -1, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        return q, k, v

    def _attn_out(self, h, attn, l):
        cfg = self.cfg
        attn = attn.reshape(h.shape[0], h.shape[1], -1)
        if cfg.sub_norms:
            attn = rms_norm(attn, self.params["layers"]["attn_sub"][l], cfg.rms_norm_eps)
        h = h + self._proj(attn, "o", l)
        return self._mlp(h, l)

    # -- prefill -------------------------------------------------------------

    def _prefill_attention(self, q, k, v):
        """Causal ring attention of this rank's q [1, s_loc, NH, D] over every
        rank's k/v, in q-chunks of PREFILL_Q_CHUNK rows when s_loc exceeds
        it (one ring pass per chunk)."""
        CQ, s_loc = self.PREFILL_Q_CHUNK, q.shape[1]
        if s_loc <= CQ:
            return ring_attention(q, k, v, self.group)
        # ring_attention's base is idx*Sq + q_offset with Sq the chunk's rows:
        # offset it to the chunk's global start idx*s_loc + c0
        parts = []
        for c0 in range(0, s_loc, CQ):
            qc = q[:, c0:c0 + CQ]
            off = self.rank * (s_loc - qc.shape[1]) + c0
            parts.append(ring_attention(
                qc, k, v, self.group,
                q_offset=torch.full((1,), off, dtype=torch.int64, device=q.device)))
        return torch.cat(parts, dim=1)

    def _prefill(self, tokens_loc: torch.Tensor, t0: int):
        """tokens_loc [1, s_loc]: this rank's slice of the padded prompt; t0
        the real length. Returns (logits [1, V] of token t0 - 1, the same on
        every rank; this rank's prompt K and V [L, 1, s_loc, KV, D])."""
        cfg, p, dev = self.cfg, self.params, self.device
        dtype = cfg.dtype
        idx, s_loc = self.rank, tokens_loc.shape[1]
        pos = idx * s_loc + torch.arange(s_loc, device=dev)[None, :]
        h = p["embed"][tokens_loc.long()].to(dtype)
        cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta, dtype)
        shape = (cfg.num_layers, 1, s_loc, cfg.num_kv_heads, cfg.head_dim)
        ks = torch.empty(shape, dtype=dtype, device=dev)
        vs = torch.empty(shape, dtype=dtype, device=dev)
        for l in range(cfg.num_layers):
            q, k, v = self._qkv(h, l, cos, sin)
            h = self._attn_out(h, self._prefill_attention(q, k, v), l)
            ks[l] = k
            vs[l] = v
        # logits only for the last real token (t0 - 1): its owner gives its
        # row, the other ranks zeros, a SUM replicates it (in f32: exact)
        last = t0 - 1
        own = idx * s_loc <= last < (idx + 1) * s_loc
        off = min(max(last - idx * s_loc, 0), s_loc - 1)
        h_last = h[:, off].float() if own else torch.zeros_like(h[:, off], dtype=torch.float32)
        dist.all_reduce(h_last, op=dist.ReduceOp.SUM, group=self.group)
        final = rms_norm(h_last.to(dtype), p["final_norm"], cfg.rms_norm_eps)
        return compute_logits(final, p, cfg), ks, vs

    # -- decode --------------------------------------------------------------

    def _attend(self, q, k_loc, v_loc, kb, vb, k_pos_m, b_pos_m):
        """q [1,1,NH,D] over the sharded prefix (keys at ``k_pos_m``, masked
        ones at _NEVER) and the replicated buffer (``b_pos_m``)."""
        B, _, NH, D = q.shape
        scale = 1.0 / math.sqrt(D)

        def bshape(f):  # [B,KV,G,1] -> [B,1,NH,1]
            return _bshape(f, B, 1, NH)

        q_pos = torch.full((1, 1), _ALL, dtype=torch.int64, device=q.device)
        m1, l1, a1 = _block_attend(q, k_loc, v_loc, q_pos, k_pos_m, scale)
        # cross-rank combine of the prefix partials
        mg = m1.clone()
        dist.all_reduce(mg, op=dist.ReduceOp.MAX, group=self.group)
        w = torch.exp(m1 - mg)
        lg = l1 * w
        ag = a1 * bshape(w)
        dist.all_reduce(lg, op=dist.ReduceOp.SUM, group=self.group)
        dist.all_reduce(ag, op=dist.ReduceOp.SUM, group=self.group)
        m2, l2, a2 = _block_attend(q, kb, vb, q_pos, b_pos_m, scale)
        m, l, acc = _merge(mg, lg, ag, m2, l2, a2, bshape)
        l = torch.clamp_min(l, 1e-30)
        return (acc / bshape(l)).to(q.dtype)

    def _decode(self, pk, pv, first: torch.Tensor, t0: int, steps: int,
                feed: Optional[List[int]] = None, logits_out: Optional[list] = None) -> List[int]:
        """``steps`` greedy tokens after ``first`` (a device scalar at
        position t0); one host read at the end. ``feed``: ``steps`` tokens
        fed in place of the argmax (teacher forcing, for checks against
        another path); ``logits_out``: a list that receives each step's
        logits [1, V]."""
        cfg, p, dev = self.cfg, self.params, self.device
        dtype = cfg.dtype
        NB, s_loc = self.decode_buf, pk.shape[2]
        # every step and layer reads the prompt KV in f32 (``_block_attend``):
        # upcast it once, in place of a copy of each layer's K and V at every
        # step (exact: the same values)
        pk, pv = pk.float(), pv.float()
        k_pos = self.rank * s_loc + torch.arange(s_loc, device=dev)
        k_pos_m = torch.where(k_pos < t0, k_pos, torch.full_like(k_pos, _NEVER))
        b_pos = torch.arange(NB, device=dev)
        shape = (cfg.num_layers, 1, NB, cfg.num_kv_heads, cfg.head_dim)
        kb = torch.zeros(shape, dtype=dtype, device=dev)
        vb = torch.zeros(shape, dtype=dtype, device=dev)
        tok, toks = first.reshape(1, 1), []
        for t in range(steps):
            pos = torch.full((1, 1), t0 + t, dtype=torch.int64, device=dev)
            cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta, dtype)
            b_pos_m = torch.where(b_pos <= t, t0 + b_pos, torch.full_like(b_pos, _NEVER))
            h = p["embed"][tok.long()].to(dtype)  # [1, 1, H]
            for l in range(cfg.num_layers):
                q, k, v = self._qkv(h, l, cos, sin)
                # this step's K/V into the buffer at t, before the layer
                # attends (the reference's per-layer view; its stacked write
                # after the layer loop stores the same rows)
                kb[l, :, t] = k[:, 0]
                vb[l, :, t] = v[:, 0]
                attn = self._attend(q, pk[l], pv[l], kb[l], vb[l], k_pos_m, b_pos_m)
                h = self._attn_out(h, attn, l)
            final = rms_norm(h[:, 0], p["final_norm"], cfg.rms_norm_eps)
            logits = compute_logits(final, p, cfg)
            if logits_out is not None:
                logits_out.append(logits)
            tok = (logits.argmax(dim=-1).reshape(1, 1) if feed is None
                   else torch.full((1, 1), feed[t], dtype=torch.int64, device=dev))
            toks.append(tok)
        return torch.cat(toks).reshape(-1).tolist() if toks else []

    # -- public API ----------------------------------------------------------

    def generate(self, prompt_ids: List[int], max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None) -> List[int]:
        """Greedy generation for an arbitrarily long prompt (collective:
        every rank of the group calls it with the same prompt)."""
        if max_new_tokens > self.decode_buf:
            raise ValueError(f"max_new_tokens {max_new_tokens} > decode_buf {self.decode_buf}")
        t0 = len(prompt_ids)
        if t0 == 0:
            raise ValueError("empty prompt")
        s_loc = max(8, -(-t0 // self.P))  # a small floor keeps shapes sane
        toks = np.zeros((self.P * s_loc,), np.int64)
        toks[:t0] = prompt_ids
        mine = torch.from_numpy(toks[self.rank * s_loc:(self.rank + 1) * s_loc]).to(self.device)
        w0 = time.perf_counter()
        logits, pk, pv = self._prefill(mine[None, :], t0)
        first_dev = logits[0].argmax()
        first = int(first_dev)  # the host read ends the prefill
        w1 = time.perf_counter()
        self.last_timings = {"prefill_s": w1 - w0, "prompt_tokens": t0}
        if max_new_tokens == 1 or first == eos_token_id:
            return [first]
        prof_dir = getattr(self, "profile_decode_dir", None)
        if prof_dir:  # a decode-only torch.profiler window (bench tooling)
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            with profile(activities=acts) as prof:
                rest = self._decode(pk, pv, first_dev, t0, max_new_tokens - 1)
            os.makedirs(prof_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(prof_dir, f"decode_rank{self.rank}.json"))
        else:
            rest = self._decode(pk, pv, first_dev, t0, max_new_tokens - 1)
        out = [first] + rest
        self.last_timings["decode_s"] = time.perf_counter() - w1
        self.last_timings["decode_tokens"] = len(out) - 1
        if eos_token_id is not None and eos_token_id in out:
            out = out[: out.index(eos_token_id) + 1]
        return out
