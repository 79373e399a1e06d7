"""Spawned ``torch.distributed`` worlds for the port's CPU tests.

A test module starts each world once (``run_worlds``): P processes, started
with the ``spawn`` method, form a gloo group whose rendezvous is a
``FileStore`` under a temporary directory (no TCP port, so concurrent test
workers never collide; the ranks talk over the loopback interface), run one
target of this module over all of the module's cases and write their results
to the directory, which the parent reads back. This module imports neither
jax nor any test module: each rank imports only the port (and sets one torch
thread, as ``tests/_torch_cpu.py`` does).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import tempfile
import traceback
from pathlib import Path


def _rank_main(rank, world, store_path, out_dir, target, payload):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    # one torch thread per rank, as tests/_torch_cpu.py sets in the test
    # workers (not imported by name here: on the card's machine another
    # installed package is called ``tests``)
    torch.set_num_threads(1)

    result = None
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        try:
            result = ("ok", globals()[target](payload))
        finally:
            if dist.is_initialized():  # a target may have destroyed it
                dist.destroy_process_group()
    except Exception:  # reported to the parent, which fails the test
        result = ("error", traceback.format_exc())
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def run_worlds(sizes, target: str, payload, timeout: float = 600.0) -> dict:
    """Run ``target(payload)`` on every rank of one world of each size in
    ``sizes``, all worlds at once; returns {size: [rank 0's result, ...]}.
    Raises if a rank failed, hung past ``timeout`` or died."""
    ctx = multiprocessing.get_context("spawn")
    worlds = {}
    with tempfile.TemporaryDirectory(prefix="wf_dist_") as tmp:
        for P in sizes:
            out_dir = Path(tmp) / f"world{P}"
            out_dir.mkdir()
            store = str(out_dir / "store")
            procs = [ctx.Process(target=_rank_main,
                                 args=(r, P, store, str(out_dir), target, payload))
                     for r in range(P)]
            for p in procs:
                p.start()
            worlds[P] = (out_dir, procs)
        results = {}
        for P, (out_dir, procs) in worlds.items():
            for p in procs:
                p.join(timeout)
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join(10)
            if alive:
                raise RuntimeError(f"world of {P}: {len(alive)} rank(s) still running "
                                   f"after {timeout} s")
            ranks = []
            for r, p in enumerate(procs):
                f = out_dir / f"rank{r}.pkl"
                if not f.exists():
                    raise RuntimeError(f"world of {P}: rank {r} exited {p.exitcode} "
                                       "without a result")
                status, value = pickle.loads(f.read_bytes())
                if status != "ok":
                    raise RuntimeError(f"world of {P}, rank {r}:\n{value}")
                ranks.append(value)
            results[P] = ranks
    return results


# ---------------------------------------------------------------------------
# targets (each runs on every rank of a world)
# ---------------------------------------------------------------------------


def ring_cases(cases):
    """``cases``: {name: dict(q, k, v full [B,S,NH,D] numpy, dtype name,
    causal, q_offset [B] or None)}. Returns {name: the full output, f32
    numpy}: ``make_ring_attention``'s, or with ``q_offset`` this rank's
    ``ring_attention`` shard gathered from every rank."""
    import torch
    import torch.distributed as dist

    from wrinklefree_tpu_torch.ops.ring_attention import make_ring_attention, ring_attention

    P, r = dist.get_world_size(), dist.get_rank()
    out = {}
    for name, c in cases.items():
        dt = getattr(torch, c["dtype"])
        q, k, v = (torch.from_numpy(c[x]).to(dt) for x in ("q", "k", "v"))
        if c.get("q_offset") is None:
            o = make_ring_attention(causal=c["causal"])(q, k, v)
        else:
            n = q.shape[1] // P
            sl = slice(r * n, (r + 1) * n)
            mine = ring_attention(q[:, sl].contiguous(), k[:, sl].contiguous(),
                                  v[:, sl].contiguous(), causal=c["causal"],
                                  q_offset=torch.from_numpy(c["q_offset"]))
            parts = [torch.empty_like(mine) for _ in range(P)]
            dist.all_gather(parts, mine)
            o = torch.cat(parts, dim=1)
        out[name] = (o.float().numpy(), str(o.dtype))
    return out


def long_context_cases(payload):
    """``payload``: dict(params numpy tree, cfg kwargs, cases {name:
    (prompt ids, max_new_tokens, PREFILL_Q_CHUNK or None, world sizes)}).
    Returns {name: (tokens, last_timings)} for the cases of this world's
    size, each run on a fresh ``LongContextEngine`` over the default group."""
    import torch.distributed as dist

    from wrinklefree_tpu_torch.engine.long_context import LongContextEngine

    params, cfg = _f32_model(payload)
    out = {}
    for name, (prompt, n_new, chunk, sizes) in payload["cases"].items():
        if dist.get_world_size() not in sizes:
            continue
        eng = LongContextEngine(params, cfg, device="cpu")
        if chunk is not None:
            eng.PREFILL_Q_CHUNK = chunk
        out[name] = (eng.generate(prompt, n_new), eng.last_timings)
    return out


def long_context_module(payload):
    """All of ``tests/test_torch_long_context.py``'s cases in one world:
    ``long_context_cases`` and ``engine_cases`` on the world's group; in a
    world of more ranks, ``multi_rank_refusals``; in a world of one or two,
    ``gate_case``; in a world of one, then, the group destroyed,
    ``server_cases`` (which forms a group of one) and
    ``bench/long_context.py`` on the tiny model."""
    import torch.distributed as dist

    out = {"lce": long_context_cases(payload), "engine": engine_cases(payload)}
    if dist.get_world_size() > 1:
        out["multi_rank"] = multi_rank_refusals()
    if dist.get_world_size() in (1, 2):
        out["gate"] = gate_case(payload)
    if dist.get_world_size() == 1:
        dist.destroy_process_group()
        out["server"] = server_cases(payload)
        from wrinklefree_tpu_torch.bench import long_context as bench

        out["bench"] = bench.main(["--model", "tiny", "--device", "cpu", "--tokens", "300",
                                   "--new-tokens", "4"])
    return out


def _f32_model(payload):
    import torch

    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.weights import params_from_numpy

    cfg = BitNetConfig(**payload["cfg"], dtype=torch.float32)
    return params_from_numpy(payload["params"], cfg, device="cpu"), cfg


def engine_cases(payload):
    """The port's ``Engine`` with the default group as its long-context
    group (the reference test's engine configuration, max_context 64): a
    99-token greedy prompt through the ring path, a short one through the
    paged path, and what raises: sampling on the ring path, a long prompt
    without a group, fused params with a group."""
    import torch.distributed as dist

    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.models.bitnet import fuse_projections

    params, cfg = _f32_model(payload)
    ecfg = EngineConfig(max_batch_slots=2, page_size=8, num_pages=64, max_context=64,
                        prefill_buckets=(8, 16, 32))
    group = dist.group.WORLD
    eng = Engine(params, cfg, ecfg, long_context_mesh=group, device="cpu")
    greedy = SamplingParams(max_new_tokens=4, temperature=0.0)
    out = {}
    r = eng.generate(payload["long_prompt"], greedy)
    out["long"] = (r.output_ids, r.finished, r.finish_reason, eng.stats["requests"])
    r2 = eng.generate([1, 5, 9], greedy)
    out["short"] = (r2.output_ids, r2.finished, eng.stats["prefill_tokens"])
    errors = {}
    for name, fn in {
        "sampling": lambda: eng.generate(payload["long_prompt"],
                                         SamplingParams(max_new_tokens=4, temperature=0.8)),
        "no_group": lambda: Engine(params, cfg, ecfg, device="cpu").generate(
            payload["long_prompt"], SamplingParams(max_new_tokens=4)),
        "fused": lambda: Engine(fuse_projections(params, cfg), cfg, ecfg,
                                long_context_mesh=group, device="cpu"),
    }.items():
        try:
            fn()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


def multi_rank_refusals():
    """What a default group of more than one rank makes ``group_of_one``
    and ``create_server(long_context=True)`` raise."""
    from wrinklefree_tpu_torch.engine.long_context import group_of_one
    from wrinklefree_tpu_torch.server.http import create_server

    out = {}
    for name, fn in {"group_of_one": lambda: group_of_one("cpu"),
                     "create_server": lambda: create_server(tiny=True, long_context=True,
                                                            device="cpu")}.items():
        try:
            fn()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def gate_case(payload):
    """``chip_smoke.py``'s ``longctx_f32_gate`` on the tiny f32 model (the
    world's group, of one or two ranks; q-chunks of 8, a 50-token prompt, 6
    tokens): its report and failures."""
    import torch

    from chip_smoke import longctx_f32_gate
    from wrinklefree_tpu_torch.engine.long_context import LongContextEngine
    from wrinklefree_tpu_torch.ops.ternary import ternary_linear
    from wrinklefree_tpu_torch.ops.ternary_cuda import ternary_matmul

    params, cfg = _f32_model(payload)
    lce = LongContextEngine(params, cfg, device="cpu")
    lce.PREFILL_Q_CHUNK = 8

    def k7_linear(x, qw, scale, out_dtype=torch.bfloat16):
        return ternary_linear(x, qw, scale, out_dtype=out_dtype, kernel=ternary_matmul)

    prompt = torch.tensor(payload["gate_prompt"])
    return longctx_f32_gate(lce, params, cfg, prompt, 6, k7_linear)


def server_cases(payload):
    """``create_server(tiny=True, long_context=True)`` in a process whose
    ``torch.distributed`` is not initialized: the group of one it forms,
    then a greedy prompt beyond max_context through ``Engine.generate``, the
    async route and HTTP, and a sampled one (refused with a 400)."""
    import asyncio
    import json
    import urllib.error
    import urllib.request

    import torch.distributed as dist

    from wrinklefree_tpu_torch.engine import SamplingParams
    from wrinklefree_tpu_torch.server._web import ServerThread
    from wrinklefree_tpu_torch.server.http import build_app, create_server

    assert not dist.is_initialized()
    server = create_server(tiny=True, long_context=True, device="cpu")
    out = {"world": (dist.is_initialized(), dist.get_world_size())}
    eng = server.async_engine.engine
    try:
        ids = payload["ids"]
        greedy = SamplingParams(max_new_tokens=4, temperature=0.0)
        out["max_context"] = eng.ecfg.max_context
        out["direct"] = eng.generate(ids, greedy).output_ids
        req = asyncio.run(server.async_engine.generate(ids, greedy))
        out["async"] = (req.output_ids, req.finished)
        st = ServerThread(build_app(server))
        try:
            def post(body):
                r = urllib.request.Request(f"{st.url}/completion", data=json.dumps(body).encode(),
                                           headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(r, timeout=120) as resp:
                        return resp.status, json.loads(resp.read())
                except urllib.error.HTTPError as e:
                    return e.code, json.loads(e.read())

            text = payload["text"]
            out["http"] = post({"prompt": text, "n_predict": 4, "temperature": 0.0})
            out["http_sampled"] = post({"prompt": text, "n_predict": 4, "temperature": 0.8})
            out["http_ids"] = eng.generate(server.tokenizer.encode(text), greedy).output_ids
        finally:
            st.stop()
        # the ring path on its executor thread while a short stream runs on
        # the scheduler thread (one at a time: the batch it has alone)
        shorts = [ids[:17], ids[40:63]]
        out["short_direct"] = [eng.generate(p, greedy).output_ids for p in shorts]

        async def together(short):
            return await asyncio.gather(*(server.async_engine.generate(p, greedy)
                                          for p in (ids, short)))

        out["together"] = [[r.output_ids for r in asyncio.run(together(p))] for p in shorts]
    finally:
        server.async_engine.shutdown()
    # two replicas: the long prompt goes to replica 0, which holds the group,
    # when the router would pick replica 1
    server = create_server(tiny=True, long_context=True, dp=2, device="cpu")
    try:
        ae = server.async_engine
        ae._rr = 1
        out["dp2_pick"] = ae.engines.index(ae.pick())
        ae._rr = 1
        req = asyncio.run(ae.generate(ids, greedy))
        out["dp2"] = (req.output_ids, [e.stats["requests"] for e in ae.engines])
    finally:
        server.async_engine.shutdown()
    return out


# ---------------------------------------------------------------------------
# tensor parallelism (tests/test_torch_sharding.py, test_torch_tp_engine.py,
# test_torch_router.py, test_torch_multihost.py, test_torch_server.py)
# ---------------------------------------------------------------------------


def _model(models, name, device="cpu"):
    import torch

    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.weights import params_from_numpy

    np_params, cfg_kw = models[name]
    cfg = BitNetConfig(**cfg_kw, dtype=torch.float32)
    return params_from_numpy(np_params, cfg, device=device), cfg


def _tensor_tree_np(tree):
    """Nested dict of tensors -> numpy on the CPU (bf16 as its f32 image)."""
    import torch

    if isinstance(tree, dict):
        return {k: _tensor_tree_np(v) for k, v in tree.items()}
    return (tree.float() if tree.dtype == torch.bfloat16 else tree).cpu().numpy()


def sharding_cases(payload):
    """``payload``: dict(models {name: (numpy params, cfg kwargs)}, forward
    {name: (model, n_data, n_model, tokens [B, S], decode token [B, 1])}).
    On a world of P ranks: this rank's ``shard_params`` of every model
    (repacked for tp = P, KV replicated where the decider says so), and the
    logits of ``make_tp_forward`` (a prefill with logits_all, then one decode
    step) for the cases whose mesh has P ranks, each on a fresh cache."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from wrinklefree_tpu_torch.models.bitnet import KVCache, tp_local_kv_heads
    from wrinklefree_tpu_torch.parallel.sharding import (make_mesh,
                                                          make_tp_forward,
                                                          repack_params_for_tp, shard_params,
                                                          tp_kv_replicated)

    P = dist.get_world_size()
    meshes = {}

    def mesh(nd, nm):
        if (nd, nm) not in meshes:
            meshes[(nd, nm)] = make_mesh(nd, nm, device="cpu")
        return meshes[(nd, nm)]

    out = {"shards": {}, "forward": {}}
    for name in payload["models"]:
        params, cfg = _model(payload["models"], name)
        if cfg.num_heads % P:
            continue
        rep = tp_kv_replicated(cfg, P)
        m = mesh(1, P)
        out["shards"][name] = (m.model.index, rep, _tensor_tree_np(
            shard_params(repack_params_for_tp(params, P), m, kv_replicated=rep)))
    for name, (model, nd, nm, toks, nxt) in payload["forward"].items():
        if nd * nm != P:
            continue
        params, cfg = _model(payload["models"], model)
        m = mesh(nd, nm)
        rep = tp_kv_replicated(cfg, nm)
        sp = shard_params(repack_params_for_tp(params, nm), m, kv_replicated=rep)
        lcfg = dataclasses.replace(cfg, num_kv_heads=tp_local_kv_heads(cfg, m.model, rep))
        B, S = toks.shape
        cache = KVCache.zeros(lcfg, B // nd, 32, device="cpu")
        tokens = torch.from_numpy(toks)
        start = torch.zeros(B, dtype=torch.int32)
        m.model.calls.clear()
        a, cache = make_tp_forward(cfg, m, logits_all=True)(sp, tokens, cache, start)
        b, _ = make_tp_forward(cfg, m)(sp, torch.from_numpy(nxt), cache,
                                       torch.full((B,), S, dtype=torch.int32))
        out["forward"][name] = (a.numpy(), b.numpy(), tuple(cache.k.shape),
                                dict(m.model.calls))
    return out


def _run_leader(eng, fn):
    """Run ``fn()`` on a tensor-parallel leader, stopping its followers
    whatever happens."""
    try:
        return fn()
    finally:
        eng.stop_followers()


def tp_engine_cases(payload):
    """``payload``: dict(models, cases {name: dict(model, tp, ecfg kwargs,
    runs [(prompt, sampling kwargs)], raises)}). For the cases whose tp is
    this world's size: the port's ``Engine(mesh=make_mesh(1, tp))`` on every
    rank, the leader generating each run in order. Returns, from every rank,
    {case: dict(outs: the leader's output ids per run (None on followers),
    stats, local KV heads, _tp_kv_rep, lockstep messages)}, or {case:
    ("raises", error type, message)} where construction raised."""
    import torch.distributed as dist

    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.parallel.sharding import make_mesh

    P = dist.get_world_size()
    mesh = make_mesh(1, P, device="cpu")
    out = {}
    for name, c in payload["cases"].items():
        if c["tp"] != P:
            continue
        params, cfg = _model(payload["models"], c["model"])
        try:
            eng = Engine(params, cfg, EngineConfig(**c["ecfg"]), mesh=mesh)
        except (ValueError, NotImplementedError) as e:
            out[name] = ("raises", type(e).__name__, str(e))
            continue
        outs = None
        if mesh.model.index == 0:
            outs = _run_leader(eng, lambda: [
                eng.generate(p, SamplingParams(**sp)).output_ids for p, sp in c["runs"]])
        else:
            eng.follow()
        out[name] = dict(outs=outs, stats=dict(eng.stats), tp_kv_rep=eng._tp_kv_rep,
                         kv_heads=eng.pools.kv.shape[-1] // cfg.head_dim,
                         messages=eng._lockstep.messages)
    f = payload.get("faults")
    if f is not None and f["tp"] == P:
        params, cfg = _model(payload["models"], f["model"])
        out["faults"] = tp_faults(Engine(params, cfg, EngineConfig(**f["ecfg"]), mesh=mesh),
                                  f["prompts"], f["fail_decode"])
    lc = payload.get("long")
    if lc is not None and P in lc["worlds"]:
        out["long"] = tp_long_case(payload["models"], lc, mesh)
    return out


def tp_long_case(models, lc, mesh):
    """Long context on a tensor-parallel engine (``lc``: model, ecfg, long
    prompts, short prompts, new tokens for each, worlds). In a world of one: the
    single-device ring route (``Engine(long_context_mesh=<the world>)``) on
    the long prompts. In a larger world, ``Engine(mesh, long_context_mesh=
    mesh.model.group)`` on every rank, the leader: the short prompts alone,
    the long prompts, then short prompt 0 stepped twice before long prompt 0
    and short prompt 1 submitted after it, all stepped to their ends; then a
    sampled long prompt (``ValueError``, nothing recorded). Then the world as
    a ``make_mesh(P, 1)`` mesh, whose model ranks are one: the world group is
    foreign to it (``ValueError``). Returns every rank's stats; the leader's
    tokens and errors."""
    import torch.distributed as dist

    from wrinklefree_tpu_torch.config import EngineConfig
    from wrinklefree_tpu_torch.engine import Engine, SamplingParams
    from wrinklefree_tpu_torch.parallel.sharding import make_mesh

    P = dist.get_world_size()
    params, cfg = _model(models, lc["model"])
    ecfg = EngineConfig(**lc["ecfg"])
    greedy = SamplingParams(max_new_tokens=lc["new"], temperature=0.0)
    short = SamplingParams(max_new_tokens=lc["short_new"], temperature=0.0)
    if P == 1:
        eng = Engine(params, cfg, ecfg, long_context_mesh=dist.group.WORLD, device="cpu")
        return dict(single=[eng.generate(p, greedy).output_ids for p in lc["longs"]])
    eng = Engine(params, cfg, ecfg, mesh=mesh, long_context_mesh=mesh.model.group)
    out = dict(snapshot=eng._long_ctx_params is not None)
    if mesh.model.index == 0:
        def run():
            res = dict(alone=[eng.generate(p, short).output_ids for p in lc["shorts"]],
                       longs=[eng.generate(p, greedy).output_ids for p in lc["longs"]])
            a = eng.submit(lc["shorts"][0], short)
            eng.step()
            eng.step()
            res["a_before"] = len(a.output_ids)
            r = eng.generate(lc["longs"][0], greedy)
            b = eng.submit(lc["shorts"][1], short)
            while not (a.finished and b.finished):
                eng.step()
            res["together"] = [a.output_ids, r.output_ids, b.output_ids]
            res["reason"] = r.finish_reason
            try:
                eng.generate(lc["longs"][0], SamplingParams(max_new_tokens=2, temperature=0.8))
                res["sampled"] = None
            except ValueError as e:
                res["sampled"] = str(e)
            res["recorded"] = eng._lockstep.pending()
            return res

        out.update(_run_leader(eng, run))
    else:
        eng.follow()
    out["stats"] = dict(eng.stats)
    try:
        Engine(params, cfg, ecfg, mesh=make_mesh(P, 1, device="cpu"),
               long_context_mesh=dist.group.WORLD)
        out["foreign"] = None
    except ValueError as e:
        out["foreign"] = str(e)
    return out


def tp_faults(eng, prompts, fail_decode):
    """A full queue and a failed step on a tensor-parallel engine. Every
    rank's ``fail_decode``-th decode raises before it runs (the same step on
    every rank). The leader submits one prompt per slot, steps once (every
    slot busy), submits ``max_queue`` more of 4, then one that must be refused
    with ``queue.Full``; then it steps until every request has finished,
    catching the planted failure. Returns the leader's refusal, its wait,
    the errors it caught and the output ids; every rank's stats."""
    import queue
    import time

    from wrinklefree_tpu_torch.engine import SamplingParams

    decode, calls = eng._decode, [0]

    def failing_decode():
        calls[0] += 1
        if calls[0] == fail_decode:
            raise RuntimeError("planted step failure")
        return decode()

    eng._decode = failing_decode
    if eng.mesh.model.index != 0:
        eng.follow()
        return dict(stats=dict(eng.stats), decodes=calls[0])

    def run():
        sp, long = SamplingParams(max_new_tokens=4), SamplingParams(max_new_tokens=48)
        slots, cap = eng.ecfg.max_batch_slots, eng.ecfg.max_queue
        reqs = [eng.submit(prompts[i % len(prompts)], long) for i in range(slots)]
        eng.step()
        busy = sum(s is not None for s in eng.slots)
        reqs += [eng.submit(prompts[i % len(prompts)], sp) for i in range(cap)]
        t0 = time.monotonic()
        try:
            eng.submit(prompts[0], sp)
            refused = None
        except queue.Full:
            refused = "queue.Full"
        waited = time.monotonic() - t0
        errors = []
        while not all(r.finished for r in reqs):
            try:
                eng.step()
            except RuntimeError as e:
                errors.append(str(e))
        return dict(busy=busy, refused=refused, waited=waited, errors=errors,
                    outs=[r.output_ids for r in reqs], reasons=[r.finish_reason for r in reqs])

    res = _run_leader(eng, run)
    return dict(res, stats=dict(eng.stats), decodes=calls[0])


def _post(url, path, body, timeout=120):
    """(status, JSON body) of a POST to a server of the port."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"{url}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    import urllib.request

    with urllib.request.urlopen(f"{url}{path}", timeout=60) as resp:
        return resp.read().decode()


def tp_server_cases(payload):
    """A world of 2: ``tp_server_case``, then ``tp_embedding_case``. A world
    of 4: ``dp_tp_server_case``."""
    import torch.distributed as dist

    if dist.get_world_size() == 4:
        return dp_tp_server_case(payload)
    out = tp_server_case(payload)
    out["embedding_ref"] = tp_embedding_case(payload)
    return out


def tp_server_case(payload):
    """``create_server(tiny=True, tp=P, long_context=True, device="cpu")`` on
    every rank of a world of P (the tiny model's weights from seed 0 in f32
    are not the server's; it draws its own): rank 0 answers the payload's
    completions over HTTP through the port's client (greedy, one at a time;
    a streamed one, a sampled one), an embedding, and a long completion
    (``payload["long_text"]``, max_context tokens or more, through the ring
    on the model group), and compares the greedy ones with its engine's
    ``generate``; then it shuts down, which ends the followers' ``serve()``."""
    import torch.distributed as dist

    from wrinklefree_tpu_torch.client.client import InferenceClient
    from wrinklefree_tpu_torch.engine import SamplingParams
    from wrinklefree_tpu_torch.server._web import ServerThread
    from wrinklefree_tpu_torch.server.http import FollowerServer, build_app, create_server

    P = dist.get_world_size()
    server = create_server(tiny=True, tp=P, long_context=True, device="cpu")
    if isinstance(server, FollowerServer):
        server.serve()
        return {"follower": True, "stats": dict(server.engine.stats)}
    out = {"follower": False}
    st = ServerThread(build_app(server))
    eng = server.async_engine.engine
    greedy = SamplingParams(max_new_tokens=8, temperature=0.0)
    try:
        client = InferenceClient(st.url)
        out["texts"] = [client.generate(t, max_tokens=8, temperature=0.0)
                        for t in payload["texts"]]
        out["stream"] = "".join(client.generate_stream(payload["texts"][0], max_tokens=8,
                                                       temperature=0.0))
        out["sampled"] = client.generate(payload["texts"][1], max_tokens=8, temperature=0.9,
                                         seed=5)
        out["embedding"] = _post(st.url, "/v1/embeddings", {"input": "hi"})
        out["long"] = _post(st.url, "/completion", {"prompt": payload["long_text"],
                                                    "n_predict": 4, "temperature": 0.0})
        out["max_context"] = eng.ecfg.max_context
        long_ids = server.tokenizer.encode(payload["long_text"])
        out["long_prompt_tokens"] = len(long_ids)
        out["long_direct"] = server.tokenizer.decode(eng.generate(
            long_ids, SamplingParams(max_new_tokens=4, temperature=0.0)).output_ids)
        ids = [server.tokenizer.encode(t) for t in payload["texts"]]
        out["direct"] = [server.tokenizer.decode(eng.generate(i, greedy).output_ids)
                         for i in ids]
    finally:
        st.stop()
        server.async_engine.shutdown()
    out["stats"] = dict(eng.stats)
    return out


def tp_embedding_case(payload):
    """A TP server of the world's size around ``Engine(mesh=make_mesh(1, P))``
    on the payload's tiny weights (the reference's, bf16, its tiny engine
    configuration): the leader's ``_embed_one`` of the payload's embedding
    texts (on its unsharded snapshot, with no collective), while the
    followers follow."""
    import torch.distributed as dist

    from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
    from wrinklefree_tpu_torch.engine import Engine
    from wrinklefree_tpu_torch.parallel.sharding import make_mesh
    from wrinklefree_tpu_torch.server.http import TINY_ENGINE, ByteTokenizer, InferenceServer
    from wrinklefree_tpu_torch.weights import params_from_numpy

    cfg = BitNetConfig.tiny()
    mesh = make_mesh(1, dist.get_world_size(), device="cpu")
    eng = Engine(params_from_numpy(payload["weights"], cfg, device="cpu"), cfg,
                 EngineConfig(**TINY_ENGINE), eos_token_id=0, mesh=mesh)
    if mesh.model.index:
        eng.follow()
        return None
    server = InferenceServer(eng, ByteTokenizer(), "tp")
    try:
        return [server._embed_one(server._encode(t)) for t in payload["embed_texts"]]
    finally:
        server.async_engine.shutdown()


def dp_tp_server_case(payload):
    """``create_server(tiny=True, dp=2, tp=2, device="cpu")`` on a world of 4:
    rank 0 serves HTTP over replica 0 (ranks 0-1) and a proxy of replica 1
    (ranks 2-3, led by rank 2's ``ReplicaServer``). Rank 0: the payload's
    greedy completions one at a time; the reference's ``TestDataParallel``
    requests (six concurrent completions, then ``/stats``, ``/slots``,
    ``/metrics``); a stream routed to replica 1 whose consumer goes away
    (its cancel must reach replica 1); then shutdown. Every rank reports
    its role and that its ``serve()`` (or rank 0's shutdown) returned."""
    import asyncio
    import concurrent.futures
    import json

    from wrinklefree_tpu_torch.client.client import InferenceClient
    from wrinklefree_tpu_torch.engine import SamplingParams
    from wrinklefree_tpu_torch.server._web import ServerThread
    from wrinklefree_tpu_torch.server.http import InferenceServer, build_app, create_server

    server = create_server(tiny=True, dp=2, tp=2, device="cpu")
    if not isinstance(server, InferenceServer):
        server.serve()
        return {"role": type(server).__name__, "returned": True,
                "stats": dict(server.engine.stats)}
    out = {"role": "InferenceServer"}
    ae = server.async_engine
    st = ServerThread(build_app(server))
    try:
        client = InferenceClient(st.url)
        out["texts"] = [client.generate(t, max_tokens=8, temperature=0.0)
                        for t in payload["texts"]]

        def gen(i):
            return _post(st.url, "/v1/completions", {"model": "m", "prompt": f"hello {i}",
                                                     "max_tokens": 24, "temperature": 0.0})[0]

        with concurrent.futures.ThreadPoolExecutor(6) as ex:
            out["codes"] = list(ex.map(gen, range(6)))
        out["stats"] = json.loads(_get(st.url, "/stats"))
        out["slots"] = json.loads(_get(st.url, "/slots"))
        out["metrics"] = _get(st.url, "/metrics")

        async def cancelled():
            ae._rr = 1  # the tie goes to replica 1
            stream = ae.generate_stream(server.tokenizer.encode("cancel me"),
                                        SamplingParams(max_new_tokens=200, temperature=0.0))
            tok, fin, req = await stream.__anext__()
            owner = ae._owners[id(req)]
            await stream.aclose()  # the consumer goes away: the request is cancelled
            for _ in range(600):
                if req.finished:
                    break
                await asyncio.sleep(0.05)
            return owner, req

        owner, req = asyncio.run(cancelled())
        out["cancel"] = dict(owner=owner, finished=req.finished, reason=req.finish_reason,
                             tokens=len(req.output_ids),
                             busy=sum(s is not None for s in ae.engines[1].slots))
    finally:
        st.stop()
        ae.shutdown()
    out["returned"] = True
    return out


def mesh_cases(payload):
    """``global_mesh`` on this world (LOCAL_WORLD_SIZE from the payload):
    its shape, this rank's coordinates and groups' ranks; a dp*tp that is not
    the world size raises; ``make_mesh`` with NCCL on the CPU raises; then,
    with a payload port, the default group destroyed, ``init_multihost`` from
    torchrun's environment (env:// on 127.0.0.1:port) and one all-reduce."""
    import os

    import torch
    import torch.distributed as dist

    from wrinklefree_tpu_torch.parallel.multihost import global_mesh, init_multihost
    from wrinklefree_tpu_torch.parallel.sharding import make_mesh

    os.environ["LOCAL_WORLD_SIZE"] = str(payload["local_world"])
    out = {}
    m = global_mesh(device="cpu")
    out["default"] = (m.shape, m.data.index, m.model.index, m.model.ranks, m.data.ranks,
                      m.leader)
    t = torch.tensor([float(dist.get_rank())])
    out["model_psum"] = float(m.model.psum(t.clone())[0])
    out["data_psum"] = float(m.data.psum(t.clone())[0])
    out["gather"] = m.model.all_gather(t[None, :].expand(2, 1).contiguous()).tolist()
    errors = {}
    for key, fn in {"bad_split": lambda: global_mesh(dp=3, tp=4, device="cpu"),
                    "nccl_on_cpu": lambda: make_mesh(1, dist.get_world_size(), device="cpu",
                                                     backend="nccl")}.items():
        try:
            fn()
            errors[key] = None
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors
    if payload.get("port") is None:
        return out
    rank, world = dist.get_rank(), dist.get_world_size()
    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(payload["port"]))
    out["init"] = init_multihost()
    x = torch.ones(1)
    dist.all_reduce(x)
    out["init_sum"] = float(x[0])
    out["again"] = init_multihost()
    return out


# ---------------------------------------------------------------------------
# pipeline and expert parallelism (tests/test_torch_pipeline.py,
# test_torch_expert_parallel.py)
# ---------------------------------------------------------------------------


def pp_case(params, cfg, mesh, case):
    """One pipeline case on this rank (``case``: stages, microbatches,
    tokens [B, S] and T; with ``decode``, one greedy step after the
    prefill): a fresh stage cache, the prefill from position 0, then the
    step at position S fed the prefill's argmax. Returns the logits of each
    call and this stage's cache (f32 numpy) and the stage axis's calls."""
    import dataclasses

    import torch

    from wrinklefree_tpu_torch.models.bitnet import KVCache
    from wrinklefree_tpu_torch.parallel.pipeline import make_pp_forward

    ax = mesh.axis["stage"]
    toks = torch.from_numpy(case["tokens"])
    B, S = toks.shape
    lcfg = dataclasses.replace(cfg, num_layers=cfg.num_layers // ax.size)
    cache = KVCache.zeros(lcfg, B, case["T"], device=mesh.device)
    ax.calls.clear()
    pp = make_pp_forward(cfg, mesh, num_microbatches=case["microbatches"])
    logits, cache = pp(params, toks, cache, torch.zeros(B, dtype=torch.int32))
    out = [logits]
    if case.get("decode"):
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        logits2, cache = pp(params, nxt, cache, torch.full((B,), S, dtype=torch.int32))
        out.append(logits2)
    return dict(logits=[x.float().numpy() for x in out], k=cache.k.float().numpy(),
                v=cache.v.float().numpy(), calls=dict(ax.calls))


def _axis_input(index, P):
    """Axis index ``index``'s input to ``axis_collectives``: [4P, 3, 5]
    bf16 from seed ``index``."""
    import torch

    g = torch.Generator().manual_seed(index)
    return torch.randn((4 * P, 3, 5), generator=g).to(torch.bfloat16)


def axis_collectives(device):
    """``Axis.ppermute`` (the ring shift, and a pair that leaves every rank
    but 1 without a source), ``Axis.all_to_all`` and ``Axis.broadcast`` on
    ``_axis_input`` placed on ``device``, over an axis of the whole world on
    gloo. Returns {op: (the result's device type, its values f32 on the
    host)} and the axis's calls."""
    import torch
    import torch.distributed as dist

    from wrinklefree_tpu_torch.parallel.sharding import make_named_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    P = dist.get_world_size()
    ax = make_named_mesh({"x": P}, device=dev, backend="gloo").axis["x"]
    x = _axis_input(ax.index, P).to(dev)
    out = {"ring": ax.ppermute(x, [(i, (i + 1) % P) for i in range(P)]),
           "pair": ax.ppermute(x, [(0, 1)]),
           "all_to_all": ax.all_to_all(x),
           "broadcast": ax.broadcast(x.clone(), P - 1)}
    return ({k: (v.device.type, v.float().cpu().numpy()) for k, v in out.items()},
            dict(ax.calls))


def axis_collectives_expected(index, P):
    """What ``axis_collectives`` must return on axis index ``index`` of P,
    built from the inputs on the host (numpy)."""
    import numpy as np

    xs = [_axis_input(i, P).float().numpy() for i in range(P)]
    blocks = [np.split(x, P) for x in xs]
    return {"ring": xs[(index - 1) % P],
            "pair": xs[0] if index == 1 else np.zeros_like(xs[0]),
            "all_to_all": np.concatenate([blocks[j][index] for j in range(P)]),
            "broadcast": xs[P - 1]}


def axis_collectives_case(payload):
    """``axis_collectives`` on ``payload["device"]`` (the card's test)."""
    return axis_collectives(payload["device"])


def pipeline_cases(payload):
    """``payload``: dict(params numpy, cfg kwargs, cases {name: pp_case's
    case}). On a world of P ranks as a stage axis: this rank's stage index
    and ``shard_params_pp`` leaves, ``pp_case`` for the cases of P stages,
    and the two ``ValueError``s (P + 1 layers; a batch of 3 rows in 2
    microbatches)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.models.bitnet import KVCache
    from wrinklefree_tpu_torch.parallel.pipeline import make_pp_forward, shard_params_pp
    from wrinklefree_tpu_torch.parallel.sharding import make_named_mesh
    from wrinklefree_tpu_torch.weights import params_from_numpy

    P = dist.get_world_size()
    mesh = make_named_mesh({"stage": P}, device="cpu")
    cfg = BitNetConfig(**payload["cfg"])
    sp = shard_params_pp(params_from_numpy(payload["params"], cfg, device="cpu"), mesh)
    out = dict(stage=mesh.axis["stage"].index, shards=_tensor_tree_np(sp), cases={},
               errors={}, collectives=axis_collectives("cpu"))
    for name, case in payload["cases"].items():
        if case["stages"] == P:
            out["cases"][name] = pp_case(sp, cfg, mesh, case)
    bad = dataclasses.replace(cfg, num_layers=P + 1)

    def odd_batch():
        toks = torch.zeros((3, 4), dtype=torch.int32)
        cache = KVCache.zeros(cfg, 3, 8, device="cpu")
        make_pp_forward(cfg, mesh, num_microbatches=2)(sp, toks, cache,
                                                       torch.zeros(3, dtype=torch.int32))

    for key, fn in {"layers": lambda: make_pp_forward(bad, mesh),
                    "batch": odd_batch}.items():
        try:
            fn()
            out["errors"][key] = None
        except ValueError as e:
            out["errors"][key] = str(e)
    np.testing.assert_equal(out["stage"], dist.get_rank())
    return out


def ep_case(mesh, case):
    """One expert-parallel case on this rank (``case``: x [T, H], experts,
    router, ffn_sub numpy, top_k, capacity_factor, eps; with ``route``,
    ``ep_moe_ffn`` on this rank's rows under the identity route to expert
    0; else ``make_ep_moe``). Returns (y, aux, the axis's calls): y the
    whole [T, H] (``make_ep_moe``'s gather, or the rows gathered here) in
    f32 numpy."""
    import torch

    from wrinklefree_tpu_torch.models.moe import identity_route
    from wrinklefree_tpu_torch.parallel.expert import ep_moe_ffn, make_ep_moe

    ax = mesh.axis["expert"]
    t = {k: torch.from_numpy(v) for k, v in case["experts"].items()}
    x = torch.from_numpy(case["x"]).to(torch.bfloat16)
    sub = torch.from_numpy(case["ffn_sub"]).to(torch.bfloat16)
    router = torch.from_numpy(case["router"])
    kw = dict(top_k=case["top_k"], capacity_factor=case["capacity_factor"], eps=case["eps"])
    ax.calls.clear()
    if case.get("route"):
        n = x.shape[0] // ax.size
        e_local = t["gate_qw"].shape[0] // ax.size
        mine = {k: v[ax.index * e_local:(ax.index + 1) * e_local] for k, v in t.items()}
        y, aux = ep_moe_ffn(x[ax.index * n:(ax.index + 1) * n], mine, sub, router, ep_axis=ax,
                            route_override=identity_route(n, case["top_k"], expert=0), **kw)
        y = ax.all_gather(y, dim=0)
    else:
        y, aux = make_ep_moe(mesh, t, sub, router, **kw)(x)
    return y.float().numpy(), float(aux), dict(ax.calls)


def expert_cases(payload):
    """``payload``: {name: ep_case's case}. On a world of P ranks as an
    expert axis: ``ep_case`` for every case, and the two ``ValueError``s of
    ``make_ep_moe`` (experts, then tokens, that P does not divide; for P > 1)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from wrinklefree_tpu_torch.parallel.expert import make_ep_moe
    from wrinklefree_tpu_torch.parallel.sharding import make_named_mesh

    P = dist.get_world_size()
    mesh = make_named_mesh({"expert": P}, device="cpu")
    out = {"cases": {name: ep_case(mesh, c) for name, c in payload.items()}, "errors": {}}
    c = next(iter(payload.values()))
    t = {k: torch.from_numpy(v) for k, v in c["experts"].items()}
    sub, router = torch.from_numpy(c["ffn_sub"]), torch.from_numpy(c["router"])
    x = torch.from_numpy(c["x"]).to(torch.bfloat16)
    odd = {k: v[:P + 1] for k, v in t.items()}
    for key, fn in {"experts": lambda: make_ep_moe(mesh, odd, sub, router[:, :P + 1]),
                    "tokens": lambda: make_ep_moe(mesh, t, sub, router)(x[:P + 1])}.items():
        try:
            fn()
            out["errors"][key] = None
        except ValueError as e:
            out["errors"][key] = str(e)
    np.testing.assert_equal(mesh.axis["expert"].index, dist.get_rank())
    return out
