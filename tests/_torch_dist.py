"""Spawned ``torch.distributed`` worlds for the port's CPU tests.

A test module starts each world once (``run_worlds``): P processes, started
with the ``spawn`` method, form a gloo group whose rendezvous is a
``FileStore`` under a temporary directory (no TCP port, so concurrent test
workers never collide; the ranks talk over the loopback interface), run one
target of this module over all of the module's cases and write their results
to the directory, which the parent reads back. This module imports neither
jax nor any test module: each rank imports only the port and
``tests/_torch_cpu.py``.
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
    import tests._torch_cpu  # noqa: F401  (one torch thread per rank)
    import torch.distributed as dist

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
    world of more ranks, ``multi_rank_refusals``; in a world of one,
    ``gate_case``, then, the group destroyed, ``server_cases`` (which forms
    a group of one) and ``bench/long_context.py`` on the tiny model."""
    import torch.distributed as dist

    out = {"lce": long_context_cases(payload), "engine": engine_cases(payload)}
    if dist.get_world_size() > 1:
        out["multi_rank"] = multi_rank_refusals()
    if dist.get_world_size() == 1:
        out["gate"] = gate_case(payload)
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
    world's group of one, q-chunks of 8, a 50-token prompt, 6 tokens): its
    report and failures."""
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
