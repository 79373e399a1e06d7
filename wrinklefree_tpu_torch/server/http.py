"""OpenAI-compatible + llama.cpp-compatible HTTP server (PyTorch port, SSE).

The port of ``wrinklefree_tpu/server/http.py`` on the standard library: the
handlers are the reference's, over the small asyncio HTTP layer of
``_web.py`` (no aiohttp). Endpoint contract: OpenAI `/v1/chat/completions`,
`/v1/completions`, `/v1/models`, `/v1/embeddings`, `/health`; llama.cpp
`/completion`, `/embedding`, `/tokenize`, `/detokenize`, `/props`,
`/slots`, Prometheus `/metrics`; `/stats` and `/admin/*`.

Logprobs (OpenAI chat and legacy, streamed or not, and llama.cpp's
``completion_probabilities``), constrained decoding (``response_format``
json_object / json_schema, llama.cpp ``json_schema`` and GBNF ``grammar``),
mirostat and ``/admin/snapshot|restore`` are served as by the reference. A
streaming client that disconnects cancels its request.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import logging
import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import BitNetConfig, EngineConfig
from ..convert.gguf import load_params_gguf
from ..engine.engine import Engine
from ..engine.gbnf import GbnfValidator
from ..engine.sampling_params import SamplingParams
from ..engine.schema_to_gbnf import schema_to_gbnf
from ..models.bitnet import KVCache, forward, fuse_projections, init_params, resolve_device
from ..models.loader import load_params, load_tokenizer
from ..ops.ternary_cuda import make_linear_stacked
from ..parallel.replicas import replica_channels
from . import _web as web
from .api_types import (
    chat_chunk,
    chat_completion_id,
    chat_response,
    completion_id,
    completion_response,
    format_chat_prompt,
)
from .async_engine import AsyncEngine

logger = logging.getLogger(__name__)


class ByteTokenizer:
    """Trivial byte-level tokenizer for tiny and synthetic serving (vocab 256)."""

    eos_token_id = 0
    chat_template = None

    def encode(self, text: str, **kw) -> List[int]:
        return [1 + (b % 250) for b in text.encode("utf-8")][:2048]

    def decode(self, ids, **kw) -> str:
        # exact inverse of encode for ASCII (id i -> chr(i - 1)); every
        # non-eos id renders one char so detok/usage stay aligned
        return "".join(chr((i - 1) % 250) if i > 0 else "" for i in ids)


class _Detokenizer:
    """Incremental detokenization: decode-all + emit the stable diff."""

    def __init__(self, tokenizer):
        self.tok = tokenizer
        self.ids: List[int] = []
        self.emitted = ""

    def push(self, tok: int) -> str:
        self.ids.append(tok)
        full = self.tok.decode(self.ids, skip_special_tokens=True)
        if full.endswith("�"):  # mid-multibyte
            return ""
        delta = full[len(self.emitted):]
        self.emitted = full
        return delta


class _StopScan:
    """Stop-string scanning over streamed text (OpenAI `stop`, llama.cpp
    `stop`). Holds back the last len(longest)-1 chars while streaming so a
    stop string spanning two deltas is never partially emitted."""

    def __init__(self, stops):
        self.stops = [s for s in (stops or []) if s]
        self.hold = max((len(s) for s in self.stops), default=1) - 1
        self.text = ""
        self.sent = 0
        self.hit: "str | None" = None

    def push(self, delta: str):
        """Feed a detokenized delta; returns (releasable_text, stopped)."""
        if not self.stops:
            return delta, False
        self.text += delta
        found = [(self.text.find(s), s) for s in self.stops]
        found = [(i, s) for i, s in found if i >= 0]
        if found:
            i, s = min(found)
            out = self.text[self.sent:i]
            self.sent = i
            self.hit = s
            return out, True
        release_to = max(self.sent, len(self.text) - self.hold)
        out = self.text[self.sent:release_to]
        self.sent = release_to
        return out, False

    def flush(self) -> str:
        """Release any held-back tail (stream ended without a stop hit)."""
        out = self.text[self.sent:]
        self.sent = len(self.text)
        return out


def _parse_stops(body: dict):
    """OpenAI `stop`: string or list of strings (also llama.cpp `stop`)."""
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop]
    if isinstance(stop, list):
        return [s for s in stop if isinstance(s, str) and s]
    return []


def _event(payload: dict) -> bytes:
    """One SSE `data:` event."""
    return f"data: {json.dumps(payload)}\n\n".encode()


def _error(message: str, status: int) -> web.Response:
    return web.json_response({"error": {"message": message}}, status=status)


class InferenceServer:
    def __init__(self, engine, tokenizer, model_name: str):
        """``engine``: one Engine, or a list of replica Engines (served
        behind AsyncEngine's least-loaded router), of which those in other
        processes are ``parallel.replicas.RemoteReplica`` proxies."""
        self.async_engine = AsyncEngine(engine)
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.start_time = time.time()
        self._embed_fns = {}  # pow2 bucket -> embedding program

    # -- request plumbing -------------------------------------------------

    def _sampling_from(self, body: dict, is_llamacpp=False) -> SamplingParams:
        """The reference's request fields -> SamplingParams. Raises
        ValueError for a malformed request (400) before any stream starts."""
        if is_llamacpp:
            max_new = int(body.get("n_predict", 128))
            if max_new < 0:
                max_new = 512
        else:
            max_new = int(body.get("max_tokens", body.get("max_new_tokens", 128)))
        rep = float(body.get("repeat_penalty", body.get("repetition_penalty", 1.0)))
        last_n = int(body.get("repeat_last_n", body.get("penalty_last_n", 64)))
        # logprobs: llama.cpp `n_probs`; OpenAI chat `logprobs: bool` +
        # `top_logprobs`; legacy completions `logprobs: int`
        if is_llamacpp:
            lp_k = int(body.get("n_probs", 0) or 0)
        else:
            lp = body.get("logprobs")
            if isinstance(lp, bool):
                lp_k = max(1, int(body.get("top_logprobs", 0) or 0)) if lp else 0
            else:
                lp_k = int(lp or 0)
        # OpenAI `logit_bias`: {"token_id": -100..100} — -100 bans the
        # token; llama.cpp `logit_bias`: [[id, bias]] with `false` = ban.
        lb = body.get("logit_bias")
        bias = []
        if isinstance(lb, dict):
            for k, v in lb.items():
                b = float(v)
                bias.append((int(k), -1e9 if b <= -100.0 else b))
        elif isinstance(lb, list):
            for pair in lb:
                if not (isinstance(pair, (list, tuple)) and len(pair) == 2):
                    continue
                tid, v = pair
                bias.append((int(tid), -1e9 if v is False else float(v)))
        # OpenAI `response_format`: json_object forces any valid JSON
        # object; json_schema (and llama.cpp `json_schema`) compiles the
        # schema to GBNF (engine/schema_to_gbnf.py) and enforces it
        rf = body.get("response_format")
        json_mode = isinstance(rf, dict) and rf.get("type") == "json_object"
        schema = None
        if isinstance(rf, dict) and rf.get("type") == "json_schema":
            js = rf.get("json_schema")
            schema = (js or {}).get("schema") if isinstance(js, dict) else None
            if schema is None:
                schema = {}
        if body.get("json_schema") is not None:
            schema = body.get("json_schema")
        schema_grammar = None
        if schema is not None:
            if not isinstance(schema, dict):
                raise ValueError("json_schema must be an object")
            if schema:
                schema_grammar = schema_to_gbnf(schema)
            else:
                json_mode = True  # empty schema: any JSON object
        # llama.cpp GBNF `grammar` (engine/gbnf.py); parse errors 400 here
        grammar = body.get("grammar") or schema_grammar or None
        if grammar is not None:
            if not isinstance(grammar, str):
                raise ValueError("'grammar' must be a GBNF string")
            GbnfValidator(grammar)  # raises GbnfError (a ValueError)
        # the engine's own checks, made here so a stream can answer 400
        # before its headers go out (submit checks again)
        ecfg = self.async_engine.engine.ecfg
        if len(bias) > ecfg.logit_bias_slots:
            raise ValueError(
                f"logit_bias has {len(bias)} entries; max {ecfg.logit_bias_slots}")
        if (json_mode or grammar) and lp_k > 0:
            raise ValueError("constrained decoding (json/grammar) with logprobs not supported")
        return SamplingParams(
            temperature=float(body.get("temperature", 0.7)),
            top_p=float(body.get("top_p", 0.9)),
            top_k=int(body.get("top_k", 0)),
            max_new_tokens=max(1, max_new),
            ignore_eos=bool(body.get("ignore_eos", False)),
            min_p=float(body.get("min_p", 0.0)),
            typical_p=float(body.get("typical_p", 1.0)),
            tfs_z=float(body.get("tfs_z", 1.0)),
            mirostat=int(body.get("mirostat", 0) or 0),
            mirostat_tau=float(body.get("mirostat_tau", 5.0)),
            mirostat_eta=float(body.get("mirostat_eta", 0.1)),
            # OpenAI/llama.cpp `seed`: llama.cpp uses -1 for "random"
            seed=(
                int(body["seed"])
                if body.get("seed") is not None and int(body.get("seed", -1)) >= 0
                else None
            ),
            repetition_penalty=rep,
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            penalty_last_n=last_n,
            logprobs_k=max(0, lp_k),
            logit_bias=bias or None,
            json_mode=json_mode,
            grammar=grammar,
        )

    def _ensure_token_pieces(self):
        """Set Engine.token_pieces (id -> decoded text) once, shared by every
        replica: the constrained-decoding validators check candidate pieces
        against it. Special tokens decode to "" (never legal text). Heavy for
        a 128K vocabulary, so handlers run it in an executor."""
        eng = self.async_engine.engine
        if eng.token_pieces is None:
            eng.token_pieces = [self.tokenizer.decode([i], skip_special_tokens=True)
                                for i in range(eng.cfg.vocab_size)]
        for e in self.async_engine.engines[1:]:
            if e.token_pieces is None:
                e.token_pieces = eng.token_pieces

    async def _prepare_sampling(self, sampling):
        if sampling.constrained:
            await asyncio.get_running_loop().run_in_executor(None, self._ensure_token_pieces)

    # -- logprobs rendering ----------------------------------------------------
    # Per-token data comes from Request.logprobs_seq: one (chosen_logprob,
    # [(token_id, logprob), ...]) tuple per emitted token.

    def _tok_str(self, tok: int) -> str:
        return self.tokenizer.decode([tok], skip_special_tokens=False)

    def _chat_lp_entry(self, tok: int, entry, top_n: int) -> dict:
        chosen, tops = entry
        s = self._tok_str(tok)
        return {
            "token": s,
            "logprob": chosen,
            "bytes": list(s.encode("utf-8")),
            "top_logprobs": [
                {"token": self._tok_str(t), "logprob": lp,
                 "bytes": list(self._tok_str(t).encode("utf-8"))}
                for t, lp in tops[:top_n]
            ],
        }

    def _chat_logprobs(self, req, top_n: int) -> dict:
        """OpenAI chat ``choices[].logprobs`` object."""
        return {"content": [self._chat_lp_entry(tok, e, top_n)
                            for tok, e in zip(req.output_ids, req.logprobs_seq)]}

    def _completion_logprobs(self, req, top_n: int) -> dict:
        """Legacy OpenAI completions ``logprobs`` object."""
        tokens, token_logprobs, top_logprobs, offsets = [], [], [], []
        off = 0
        for tok, (chosen, tops) in zip(req.output_ids, req.logprobs_seq):
            s = self._tok_str(tok)
            tokens.append(s)
            token_logprobs.append(chosen)
            top_logprobs.append({self._tok_str(t): lp for t, lp in tops[:top_n]})
            offsets.append(off)
            off += len(s)
        return {"tokens": tokens, "token_logprobs": token_logprobs,
                "top_logprobs": top_logprobs, "text_offset": offsets}

    def _lp_chunk_openai(self, tok: int, entry, top_n: int) -> dict:
        """Single-token legacy logprobs object for streamed completions."""
        chosen, tops = entry
        return {"tokens": [self._tok_str(tok)], "token_logprobs": [chosen],
                "top_logprobs": [{self._tok_str(t): lp for t, lp in tops[:top_n]}],
                "text_offset": [0]}

    def _llamacpp_prob_entry(self, tok: int, tops, top_n: int) -> dict:
        return {"content": self._tok_str(tok),
                "probs": [{"tok_str": self._tok_str(t), "prob": math.exp(lp)}
                          for t, lp in tops[:top_n]]}

    def _llamacpp_probs(self, req, top_n: int) -> list:
        """llama.cpp ``completion_probabilities`` (n_probs)."""
        return [self._llamacpp_prob_entry(tok, tops, top_n)
                for tok, (_, tops) in zip(req.output_ids, req.logprobs_seq)]

    def _encode(self, prompt) -> List[int]:
        if isinstance(prompt, list):  # already token ids
            return [int(t) for t in prompt]
        return list(self.tokenizer.encode(prompt))

    # -- handlers ----------------------------------------------------------

    async def health(self, request):
        return web.json_response(
            {"status": "ok", "uptime_s": round(time.time() - self.start_time, 1)})

    async def models(self, request):
        return web.json_response({
            "object": "list",
            "data": [{"id": self.model_name, "object": "model", "owned_by": "wrinklefree-tpu"}],
        })

    def _aggregate_stats(self) -> dict:
        agg: dict = {}
        for e in self.async_engine.engines:
            for k, v in e.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    async def stats(self, request):
        engines = self.async_engine.engines
        out = {
            **self._aggregate_stats(),
            "free_pages": sum(e.allocator.num_free for e in engines),
            "cached_pages": sum(e.radix.num_cached_pages if e.radix else 0 for e in engines),
            "active_slots": sum(sum(s is not None for s in e.slots) for e in engines),
            "queued": sum(e.waiting.qsize() for e in engines),
            "latency": self.async_engine.engine.latency_summary(),
        }
        if len(engines) > 1:
            out["replicas"] = len(engines)
            out["per_replica_requests"] = [e.stats.get("requests", 0) for e in engines]
        return web.json_response(out)

    async def props(self, request):
        """llama.cpp `/props`: server properties + generation defaults."""
        eng = self.async_engine.engine
        return web.json_response({
            "model_path": self.model_name,
            "total_slots": len(eng.slots),
            "chat_template": getattr(self.tokenizer, "chat_template", None) or "",
            "default_generation_settings": {
                "n_ctx": eng.ecfg.max_context,
                "params": {"temperature": 0.7, "top_p": 0.9, "top_k": 0, "min_p": 0.0,
                           "n_predict": 128},
            },
        })

    async def slots(self, request):
        """llama.cpp `/slots`: per-slot occupancy and progress; with replicas
        every replica's slots carry a `replica` field, ids numbered
        globally."""
        engines = self.async_engine.engines
        dp = len(engines) > 1
        out = []
        base = 0
        for rep, eng in enumerate(engines):
            states = eng.slot_states()
            for i, st in enumerate(states):
                entry = {"id": base + i}
                if dp:
                    entry["replica"] = rep
                entry.update(st or {"state": "idle"})
                out.append(entry)
            base += len(states)
        return web.json_response(out)

    async def metrics(self, request):
        """Prometheus text exposition (llama-server `/metrics` analog)."""
        eng = self.async_engine.engine
        engines = self.async_engine.engines
        s = self._aggregate_stats()
        busy = sum(sum(x is not None for x in e.slots) for e in engines)
        lines = [
            "# TYPE wf_requests_total counter",
            f"wf_requests_total {s.get('requests', 0)}",
            "# TYPE wf_decode_tokens_total counter",
            f"wf_decode_tokens_total {s.get('decode_tokens', 0)}",
            "# TYPE wf_prefill_tokens_total counter",
            f"wf_prefill_tokens_total {s.get('prefill_tokens', 0)}",
            "# TYPE wf_decode_steps_total counter",
            f"wf_decode_steps_total {s.get('decode_steps', 0)}",
            "# TYPE wf_radix_hit_tokens_total counter",
            f"wf_radix_hit_tokens_total {s.get('radix_hit_tokens', 0)}",
            "# TYPE wf_slots_busy gauge",
            f"wf_slots_busy {busy}",
            "# TYPE wf_slots_total gauge",
            f"wf_slots_total {sum(len(e.slots) for e in engines)}",
            "# TYPE wf_replicas gauge",
            f"wf_replicas {len(engines)}",
            "# TYPE wf_queue_waiting gauge",
            f"wf_queue_waiting {sum(e.waiting.qsize() for e in engines)}",
            "# TYPE wf_kv_pages_free gauge",
            f"wf_kv_pages_free {sum(e.allocator.num_free for e in engines)}",
            "# TYPE wf_kv_pages_cached gauge",
            f"wf_kv_pages_cached "
            f"{sum(e.radix.num_cached_pages if e.radix else 0 for e in engines)}",
            "# TYPE wf_uptime_seconds gauge",
            f"wf_uptime_seconds {round(time.time() - self.start_time, 1)}",
        ]
        lat = eng.latency_summary()
        if lat:
            lines.append("# TYPE wf_ttft_seconds summary")
            for p, v in lat["ttft_s"].items():
                lines.append(f'wf_ttft_seconds{{quantile="0.{p[1:]}"}} {v}')
            lines.append("# TYPE wf_e2e_latency_seconds summary")
            for p, v in lat["e2e_s"].items():
                lines.append(f'wf_e2e_latency_seconds{{quantile="0.{p[1:]}"}} {v}')
        return web.Response(text="\n".join(lines) + "\n", content_type="text/plain")

    # -- embeddings ---------------------------------------------------------
    # OpenAI /v1/embeddings + llama.cpp /embedding: masked mean-pool over
    # the final hidden states (after the final norm), L2-normalized; one
    # program per power-of-two length bucket, on the engine's params and
    # linear (the kernels on the card). A tensor-parallel leader embeds on
    # its own device from its unsharded unfused snapshot through the stacked
    # K7 linear, with no collective, so the other ranks take no part (the
    # reference embeds from the same snapshot on one device).

    def _embed_program(self, bucket: int):
        if bucket not in self._embed_fns:
            eng = self.async_engine.engine
            cfg, dev = eng.cfg, eng.device
            linear = make_linear_stacked() if eng.mesh is not None else eng._linear_fn

            def run(params, toks, length: int):  # toks [1, bucket]
                cache = KVCache.zeros(cfg, 1, bucket, device=dev)
                hidden, _ = forward(
                    params, cfg, toks, cache, torch.zeros((1,), dtype=torch.int32, device=dev),
                    logits_all=True, head_fn=lambda h, p: h, linear_fn=linear,
                )  # [1, bucket, H]
                mask = (torch.arange(bucket, device=dev) < length)[None, :, None]
                s = torch.sum(hidden.float() * mask, dim=1) / max(length, 1)
                emb = s / torch.clamp(torch.linalg.norm(s, dim=-1, keepdim=True), min=1e-9)
                return emb[0]

            self._embed_fns[bucket] = run
        return self._embed_fns[bucket]

    def _embed_one(self, ids):
        eng = self.async_engine.engine
        params = eng._long_ctx_params if eng.mesh is not None else eng.params
        ids = ids[: eng.ecfg.max_context]
        bucket = 16
        while bucket < len(ids):
            bucket *= 2
        toks = np.zeros((1, bucket), np.int32)
        toks[0, : len(ids)] = ids
        out = self._embed_program(bucket)(
            params, torch.as_tensor(toks, device=eng.device), len(ids))
        return out.cpu().tolist()

    async def embeddings(self, request):
        """OpenAI `/v1/embeddings`."""
        body = await request.json()
        inp = body.get("input", "")
        # OpenAI input forms: "str" | ["str", ...] | [int, ...] (one
        # tokenized prompt) | [[int, ...], ...]
        if isinstance(inp, str):
            items = [inp]
        elif isinstance(inp, list) and inp and all(isinstance(x, int) for x in inp):
            items = [inp]
        elif isinstance(inp, list):
            items = inp
        else:
            items = []
        if (
            not items
            or len(items) > 64
            or not all(
                isinstance(x, str)
                or (isinstance(x, list) and all(isinstance(t, int) for t in x))
                for x in items
            )
        ):
            return _error("input must be 1..64 strings or token-id lists", 400)
        loop = asyncio.get_running_loop()
        data, total = [], 0
        try:
            for i, text in enumerate(items):
                ids = self._encode(text) if isinstance(text, str) else list(text)
                emb = await loop.run_in_executor(None, self._embed_one, ids)
                data.append({"object": "embedding", "embedding": emb, "index": i})
                total += len(ids)
        except ValueError as e:
            return _error(str(e), 400)
        return web.json_response({
            "object": "list",
            "model": self.model_name,
            "data": data,
            "usage": {"prompt_tokens": total, "total_tokens": total},
        })

    async def llamacpp_embedding(self, request):
        """llama.cpp `/embedding`."""
        body = await request.json()
        ids = self._encode(body.get("content", ""))
        loop = asyncio.get_running_loop()
        try:
            emb = await loop.run_in_executor(None, self._embed_one, ids)
        except ValueError as e:
            return _error(str(e), 400)
        return web.json_response({"embedding": emb})

    async def admin_reset_cache(self, request):
        """Drop every radix-cached page on every replica
        (Engine.reset_prefix_cache); 409 while any replica is busy."""
        dropped = []
        try:
            for e in self.async_engine.engines:
                dropped.append(e.reset_prefix_cache())
        except RuntimeError as err:
            return _error(str(err), 409)
        return web.json_response({"dropped_pages": dropped})

    async def admin_snapshot(self, request):
        """Request-level preemption snapshot (Engine.snapshot): token ids and
        sampling state, no tensors; POST it to /admin/restore of this or
        another server to resume. Replicas' requests are merged. Each
        replica's scheduler thread takes its snapshot between two steps."""
        ae = self.async_engine
        snaps = [await ae.between_steps(e, e.snapshot) for e in ae.engines]
        for extra in snaps[1:]:
            snaps[0]["requests"].extend(extra["requests"])
        return web.json_response(snaps[0])

    async def admin_restore(self, request):
        """Resubmit a snapshot's requests (Engine.restore, on the replica's
        scheduler thread), round-robin over the replicas; a bad snapshot
        restores nothing and answers 400."""
        body = await request.json()
        if any(d.get("json_mode") or d.get("grammar") for d in body.get("requests", [])):
            await asyncio.get_running_loop().run_in_executor(None, self._ensure_token_pieces)
        ae = self.async_engine
        try:
            if len(ae.engines) == 1:
                reqs = await ae.between_steps(ae.engine, lambda: ae.engine.restore(body))
            else:
                entries = body.get("requests", [])
                reqs = []
                for rep, e in enumerate(ae.engines):
                    part = {"version": body.get("version"),
                            "requests": entries[rep::len(ae.engines)]}
                    if part["requests"]:
                        reqs.extend(await ae.between_steps(e, lambda e=e, part=part:
                                                           e.restore(part)))
        except (ValueError, KeyError) as e:
            return _error(str(e), 400)
        return web.json_response({"restored": len(reqs)})

    async def tokenize(self, request):
        body = await request.json()
        ids = self._encode(body.get("content", body.get("text", "")))
        return web.json_response({"tokens": ids})

    async def detokenize(self, request):
        body = await request.json()
        text = self.tokenizer.decode(body.get("tokens", []), skip_special_tokens=True)
        return web.json_response({"content": text})

    async def chat_completions(self, request):
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error("invalid JSON", 400)
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            return _error("'messages' must be a non-empty list", 400)
        prompt = format_chat_prompt(messages, self.tokenizer)
        ids = self._encode(prompt)
        try:
            sampling = self._sampling_from(body)
            n = self._parse_n(body)
        except ValueError as e:
            return _error(str(e), 400)
        await self._prepare_sampling(sampling)
        stops = _parse_stops(body)
        cid = chat_completion_id()
        lp_top = int(body.get("top_logprobs", 0) or 0) if body.get("logprobs") is True else None
        try:
            if body.get("stream"):
                if n > 1:
                    return _error("stream with n > 1 not supported", 400)
                return await self._stream_chat(request, cid, ids, sampling, stops,
                                               lp_top=lp_top, usage=self._want_usage(body))
            runs = await self._run_n(ids, sampling, stops, n)
            choices, completion_toks = [], 0
            for i, (req, text, hit) in enumerate(runs):
                reason = "stop" if hit is not None else (req.finish_reason or "stop")
                choice = {
                    "index": i,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": reason,
                }
                if lp_top is not None:
                    choice["logprobs"] = self._chat_logprobs(req, lp_top)
                choices.append(choice)
                completion_toks += len(req.output_ids)
            payload = chat_response(cid, self.model_name, "", "stop", len(ids), completion_toks)
            payload["choices"] = choices
            return web.json_response(payload)
        except ValueError as e:
            return _error(str(e), 400)

    async def completions(self, request):
        body = await request.json()
        prompt = body.get("prompt", "")
        ids = self._encode(prompt)
        try:
            sampling = self._sampling_from(body)
            n = self._parse_n(body)
        except ValueError as e:
            return _error(str(e), 400)
        await self._prepare_sampling(sampling)
        stops = _parse_stops(body)
        cid = completion_id()
        lp_top = int(body.get("logprobs") or 0) or None
        echo = bool(body.get("echo", False))
        prompt_text = prompt if isinstance(prompt, str) else (
            self.tokenizer.decode(ids, skip_special_tokens=True))
        try:
            if body.get("stream"):
                if n > 1:
                    return _error("stream with n > 1 not supported", 400)
                return await self._stream_completion(
                    request, cid, ids, sampling, openai=True, stops=stops, lp_top=lp_top,
                    echo_text=prompt_text if echo else None, usage=self._want_usage(body))
            runs = await self._run_n(ids, sampling, stops, n)
            choices, completion_toks = [], 0
            for i, (req, text, hit) in enumerate(runs):
                reason = "stop" if hit is not None else (req.finish_reason or "stop")
                choices.append({
                    "index": i,
                    "text": (prompt_text + text) if echo else text,
                    "finish_reason": reason,
                    "logprobs": self._completion_logprobs(req, lp_top) if lp_top else None,
                })
                completion_toks += len(req.output_ids)
            payload = completion_response(cid, self.model_name, "", "stop", len(ids),
                                          completion_toks)
            payload["choices"] = choices
            return web.json_response(payload)
        except ValueError as e:
            return _error(str(e), 400)

    async def llamacpp_completion(self, request):
        """llama.cpp-style /completion."""
        body = await request.json()
        ids = self._encode(body.get("prompt", ""))
        try:
            sampling = self._sampling_from(body, is_llamacpp=True)
        except ValueError as e:
            return _error(str(e), 400)
        await self._prepare_sampling(sampling)
        stops = _parse_stops(body)
        n_probs = int(body.get("n_probs", 0) or 0)
        try:
            if body.get("stream"):
                return await self._stream_completion(
                    request, completion_id(), ids, sampling, openai=False, stops=stops,
                    lp_top=n_probs or None)
            req, text, hit = await self._run(ids, sampling, stops)
            extra = ({"completion_probabilities": self._llamacpp_probs(req, n_probs)}
                     if n_probs else {})
            return web.json_response({
                **extra,
                "content": text,
                "stop": True,
                "stopped_eos": req.finish_reason == "stop" and hit is None,
                "stopped_word": hit is not None,
                "stopping_word": hit or "",
                "stopped_limit": req.finish_reason == "length" and hit is None,
                "tokens_predicted": len(req.output_ids),
                "tokens_evaluated": len(ids),
                "timings": self._timings(req, len(ids)),
            })
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)

    # -- generation helpers -------------------------------------------------

    @staticmethod
    def _timings(req, n_prompt: int) -> dict:
        """llama.cpp `timings` response block, from the engine's
        per-request timestamps."""
        n_pred = len(req.output_ids)
        out = {"prompt_n": n_prompt, "predicted_n": n_pred}
        if req.first_token_t is not None:
            prompt_ms = (req.first_token_t - req.arrival_t) * 1000
            out["prompt_ms"] = round(prompt_ms, 2)
            out["prompt_per_second"] = round(n_prompt / max(prompt_ms / 1000, 1e-9), 2)
        # finish_t may lag: on_token(fin=True) fires just before the engine
        # records it — fall back to now
        end_t = req.finish_t if req.finish_t is not None else time.monotonic()
        if req.first_token_t is not None:
            pred_ms = (end_t - req.first_token_t) * 1000
            out["predicted_ms"] = round(pred_ms, 2)
            out["predicted_per_second"] = round(
                max(n_pred - 1, 0) / max(pred_ms / 1000, 1e-9), 2)
        return out

    @staticmethod
    def _parse_n(body: dict) -> int:
        """OpenAI `n`: int, 1..16 here (each choice takes an engine slot)."""
        try:
            n = int(body.get("n", 1))
        except (TypeError, ValueError):
            raise ValueError("'n' must be an integer")
        if not 1 <= n <= 16:
            raise ValueError("'n' must be between 1 and 16")
        return n

    @staticmethod
    def _want_usage(body: dict) -> bool:
        """OpenAI `stream_options: {"include_usage": true}`."""
        so = body.get("stream_options") or {}
        return bool(isinstance(so, dict) and so.get("include_usage"))

    async def _run_n(self, ids, sampling, stops, n: int):
        """n independent completions (OpenAI `n`). With an explicit seed,
        choice i samples on stream seed+i."""
        if n == 1:
            return [await self._run(ids, sampling, stops)]
        samps = [
            sampling if sampling.seed is None
            else dataclasses.replace(sampling, seed=sampling.seed + i)
            for i in range(n)
        ]
        results = await asyncio.gather(
            *(self._run(ids, s, stops) for s in samps), return_exceptions=True)
        errs = [r for r in results if isinstance(r, BaseException)]
        if errs:
            # cancel surviving siblings so they don't decode headless
            for r in results:
                if not isinstance(r, BaseException) and not r[0].finished:
                    self.async_engine.cancel(r[0], "abort")
            raise errs[0]
        return list(results)

    def _stream(self, ids, sampling):
        """The request's token stream, closed on leaving the block: a
        consumer that stops early (a client gone mid-stream) cancels it."""
        return contextlib.aclosing(self.async_engine.generate_stream(ids, sampling))

    async def _run(self, ids, sampling, stops=None):
        detok = _Detokenizer(self.tokenizer)
        scan = _StopScan(stops)
        req = None
        parts = []
        async with self._stream(ids, sampling) as stream:
            async for tok, fin, r in stream:
                req = r
                if tok >= 0 and scan.hit is None:
                    out, stopped = scan.push(detok.push(tok))
                    parts.append(out)
                    if stopped:
                        # the stream runs on to the cancel's final event:
                        # the slot is free when the response goes out
                        self.async_engine.cancel(req, "stop")
        if req is not None and req.finish_reason == "oom":
            raise ValueError("request cannot fit in KV cache")
        if scan.hit is None:
            parts.append(scan.flush())
        return req, "".join(parts), scan.hit

    async def _stream_chat(self, request, cid, ids, sampling, stops=None, lp_top=None,
                           usage=False):
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        })
        await resp.prepare(request)
        await resp.write(chat_chunk(cid, self.model_name, {"role": "assistant"}).encode())
        detok = _Detokenizer(self.tokenizer)
        scan = _StopScan(stops)
        finish = "stop"
        n = 0
        async with self._stream(ids, sampling) as stream:
            async for tok, fin, req in stream:
                if scan.hit is not None:
                    continue  # stopped: wait for the cancel's final event
                if tok >= 0:
                    delta, stopped = scan.push(detok.push(tok))
                    lp = None
                    if lp_top is not None and n < len(req.logprobs_seq):
                        lp = {"content": [
                            self._chat_lp_entry(tok, req.logprobs_seq[n], lp_top)]}
                    n += 1
                    if delta or lp is not None:
                        await resp.write(chat_chunk(cid, self.model_name, {"content": delta},
                                                    logprobs=lp).encode())
                    if stopped:
                        self.async_engine.cancel(req, "stop")
                        finish = "stop"
                        continue
                if fin:
                    finish = req.finish_reason or "stop"
        if scan.hit is None:
            tail = scan.flush()
            if tail:
                await resp.write(chat_chunk(cid, self.model_name, {"content": tail}).encode())
        await resp.write(chat_chunk(cid, self.model_name, {}, finish).encode())
        if usage:
            payload = {
                "id": cid, "object": "chat.completion.chunk",
                "created": int(time.time()), "model": self.model_name,
                "choices": [],
                "usage": {"prompt_tokens": len(ids), "completion_tokens": n,
                          "total_tokens": len(ids) + n},
            }
            await resp.write(_event(payload))
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    async def _stream_completion(self, request, cid, ids, sampling, openai: bool,
                                 stops=None, lp_top=None, echo_text=None, usage=False):
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"})
        await resp.prepare(request)
        if echo_text:  # OpenAI `echo`: the prompt leads the stream
            first = {
                "id": cid, "object": "text_completion", "model": self.model_name,
                "choices": [{"index": 0, "text": echo_text, "logprobs": None,
                             "finish_reason": None}],
            }
            await resp.write(_event(first))
        detok = _Detokenizer(self.tokenizer)
        scan = _StopScan(stops)
        n = 0
        cur_lp = (None, None)  # (token, logprobs_seq entry) of this chunk

        def payload_for(text, fin, reason):
            tok, entry = cur_lp
            if openai:
                lp = (self._lp_chunk_openai(tok, entry, lp_top)
                      if lp_top and entry is not None else None)
                return {
                    "id": cid, "object": "text_completion", "model": self.model_name,
                    "choices": [{"index": 0, "text": text, "logprobs": lp,
                                 "finish_reason": reason if fin else None}],
                }
            p = {"content": text, "stop": bool(fin), "tokens_predicted": n}
            if lp_top and entry is not None:
                p["completion_probabilities"] = [
                    self._llamacpp_prob_entry(tok, entry[1], lp_top)]
            if fin and scan.hit is not None:
                p["stopped_word"] = True
                p["stopping_word"] = scan.hit
            return p

        async with self._stream(ids, sampling) as stream:
            async for tok, fin, req in stream:
                if scan.hit is not None:
                    continue  # stopped: wait for the cancel's final event
                if tok >= 0:
                    cur_lp = ((tok, req.logprobs_seq[n])
                              if lp_top and n < len(req.logprobs_seq) else (None, None))
                    delta, stopped = scan.push(detok.push(tok))
                    n += 1
                    if stopped:
                        self.async_engine.cancel(req, "stop")
                        await resp.write(_event(payload_for(delta, True, "stop")))
                        continue
                    if fin:  # release any held-back tail with the final chunk
                        delta += scan.flush()
                    await resp.write(_event(payload_for(delta, fin, req.finish_reason)))
                elif fin:
                    cur_lp = (None, None)
                    await resp.write(_event(payload_for(scan.flush(), True,
                                                       req.finish_reason or "stop")))
        if openai:
            if usage:  # stream_options.include_usage: final usage chunk
                payload = {
                    "id": cid, "object": "text_completion",
                    "created": int(time.time()), "model": self.model_name,
                    "choices": [],
                    "usage": {"prompt_tokens": len(ids), "completion_tokens": n,
                              "total_tokens": len(ids) + n},
                }
                await resp.write(_event(payload))
            await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp


def build_app(server: InferenceServer) -> web.Application:
    app = web.Application()
    routes = [
        web.get("/health", server.health),
        web.get("/v1/models", server.models),
        web.get("/stats", server.stats),
        web.get("/props", server.props),
        web.get("/slots", server.slots),
        web.get("/metrics", server.metrics),
        web.post("/admin/snapshot", server.admin_snapshot),
        web.post("/admin/restore", server.admin_restore),
        web.post("/admin/reset-cache", server.admin_reset_cache),
        web.post("/v1/chat/completions", server.chat_completions),
        web.post("/v1/completions", server.completions),
        web.post("/completion", server.llamacpp_completion),
        web.post("/v1/embeddings", server.embeddings),
        web.post("/embedding", server.llamacpp_embedding),
        web.post("/tokenize", server.tokenize),
        web.post("/detokenize", server.detokenize),
    ]
    app.add_routes(routes)
    return app


# the tiny model's engine configuration (the reference's create_server(tiny=True))
TINY_ENGINE = dict(max_batch_slots=4, page_size=8, num_pages=256, max_context=256,
                   prefill_buckets=(16, 64, 128))


def create_server(
    model_path: Optional[str] = None,
    *,
    tiny: bool = False,
    engine_config: Optional[EngineConfig] = None,
    use_pallas: Optional[bool] = None,
    tp: int = 1,
    dp: int = 1,
    tokenizer_path: Optional[str] = None,
    long_context: bool = False,
    attn_window: int = 0,
    attn_global_tokens: int = 0,
    device=None,
    tp_backend: Optional[str] = None,
):
    """The reference's ``create_server`` on the port's engine. ``tiny``: the
    tiny config; ``model_path="synth:<BitNetConfig classmethod>"`` (e.g.
    ``synth:bitnet_2b``): that configuration at full size. Both take random
    ternary weights drawn on ``device`` (default CUDA) from seed 0 and the
    byte tokenizer, or the tokenizer at ``tokenizer_path``. Any other
    ``model_path`` is an HF or packed-cache directory (``models.loader``,
    its tokenizer from ``tokenizer_path`` or the directory) or a ``.gguf``
    file (``convert.gguf``, which carries no tokenizer: pass
    ``tokenizer_path``); loading a tokenizer needs ``transformers``.
    ``dp > 1`` with ``tp == 1`` serves that many replicas on the one
    device, sharing the weights, each with its own KV pool.
    ``attn_window > 0`` serves sliding-window attention
    (``attn_global_tokens`` global prefix) on the dual layout: an ``auto``
    layout becomes ``layer``, as the reference sets it. ``long_context``:
    replica 0 serves greedy prompts of ``max_context`` tokens or more through
    the ring-attention path (``engine/long_context.py``); with ``tp == 1`` on
    a group of one (formed if ``torch.distributed`` is not initialized; a
    default group of more ranks raises ``NotImplementedError``: the ring path
    is collective, and no caller brings the other ranks to each request).

    ``tp > 1`` serves tensor-parallel on the default process group's
    ``dp * tp`` ranks (``parallel.multihost.init_multihost()`` forms it from
    ``torchrun``'s environment if it is not initialized): every rank calls
    ``create_server`` with the same arguments and builds its shard of one
    ``Engine(mesh=make_mesh(dp, tp))``; replica d is model group d, the ranks
    ``[d*tp, (d+1)*tp)``, as the reference gives replica r the devices
    ``[r*tp, (r+1)*tp)``. With ``long_context`` replica 0's ring group is its
    model group (on one host where tp is the device count, the reference's
    all-local-devices ``seq`` axis). Global rank 0 gets the
    ``InferenceServer`` (HTTP, its scheduler thread driving its engine, and
    with ``dp > 1`` a ``parallel.replicas.RemoteReplica`` of each other
    replica behind the least-loaded pick); the leader of each other replica a
    ``parallel.replicas.ReplicaServer``, whose ``serve()`` runs that
    replica's scheduler loop until rank 0 shuts down; every other rank a
    ``FollowerServer``, whose ``serve()`` runs the engine's ``follow()``
    until its leader stops it. Rank 0's ``AsyncEngine.shutdown()`` ends every
    ``serve()``. ``device`` defaults to the rank's card, ``tp_backend`` to
    NCCL on CUDA (gloo: several ranks on one card). Only ``use_pallas=False``
    raises ``NotImplementedError``."""
    if use_pallas is False:
        raise NotImplementedError("not ported to the PyTorch server: use_pallas=False (the "
                                  "kernels' plain twins are their CPU path and oracle, not a "
                                  "serving path on the card)")
    if dp < 1 or tp < 1:
        raise ValueError(f"dp and tp must be >= 1, got dp={dp}, tp={tp}")
    mesh = None
    if tp > 1:
        from ..parallel.multihost import init_multihost
        from ..parallel.sharding import make_mesh

        init_multihost(tp_backend)
        mesh = make_mesh(dp, tp, device=device, backend=tp_backend)
        device = mesh.device
    dev = resolve_device(device)
    synthetic = tiny or str(model_path or "").startswith("synth:")
    gguf = not synthetic and str(model_path or "").endswith(".gguf")
    if not synthetic and not model_path:
        raise ValueError("a model path is required unless tiny=True")
    if gguf and not tokenizer_path:
        raise ValueError("a .gguf model needs tokenizer_path (the file carries no tokenizer)")
    # the tokenizer first: a missing transformers fails before any weights load
    if tokenizer_path or not synthetic:
        tokenizer = load_tokenizer(tokenizer_path or model_path)
    else:
        tokenizer = ByteTokenizer()
    if synthetic:
        # random weights (the tiny model, or a configuration at real geometry:
        # throughput does not depend on the weights' values)
        cfg = (BitNetConfig.tiny() if tiny
               else getattr(BitNetConfig, str(model_path).split(":", 1)[1])())
        params = init_params(cfg, seed=0, device=dev)
    elif gguf:
        params, cfg = load_params_gguf(model_path, device=dev)
    else:
        params, cfg = load_params(model_path, device=dev)
    if tiny:
        ecfg = engine_config or EngineConfig(**TINY_ENGINE)
        name = "wrinklefree-tiny-test"
    else:
        ecfg = engine_config or EngineConfig()
        name = str(model_path)
    if attn_window > 0:
        # the page-skipping window gather needs the dual layout
        ecfg = dataclasses.replace(
            ecfg, attn_window=attn_window, attn_global_tokens=attn_global_tokens,
            kv_layout="layer" if ecfg.kv_layout == "auto" else ecfg.kv_layout)
    eos = getattr(tokenizer, "eos_token_id", None)
    if mesh is not None:
        # every rank shards the whole params (unfused) in Engine(mesh=...);
        # only replica 0 takes the ring group, as the reference's
        lc_group = mesh.model.group if long_context and mesh.data.index == 0 else None
        engine = Engine(params, cfg, ecfg, eos_token_id=eos, mesh=mesh,
                        long_context_mesh=lc_group)
        replica, remotes = replica_channels(mesh, engine) if dp > 1 else (None, [])
        if mesh.model.index != 0:
            return FollowerServer(engine)
        if replica is not None:
            return replica
        return InferenceServer([engine, *remotes] if remotes else engine, tokenizer, name)
    lc_group = None
    if long_context:
        # the ring path for beyond-max_context requests, on a group of one
        from ..engine.long_context import group_of_one

        lc_group = group_of_one(dev)
    shared = params
    if cfg.num_experts == 0 and (lc_group is None or dp > 1):
        shared = fuse_projections(params, cfg)  # once, shared by the replicas
    # replica 0 takes the group and the unfused params (it fuses its own copy)
    engines = [Engine(params, cfg, ecfg, eos_token_id=eos, device=dev,
                      long_context_mesh=lc_group) if r == 0 and lc_group is not None
               else Engine(shared, cfg, ecfg, eos_token_id=eos, device=dev)
               for r in range(dp)]
    return InferenceServer(engines[0] if dp == 1 else engines, tokenizer, name)


class FollowerServer:
    """A tensor-parallel server's rank other than its replica's model rank 0:
    it serves no HTTP; ``serve()`` runs its engine's ``follow()`` (the
    leader's calls and steps) until the leader stops it."""

    def __init__(self, engine: Engine):
        self.engine = engine

    def serve(self) -> None:
        self.engine.follow()


def main(argv=None):
    p = argparse.ArgumentParser("wrinklefree_tpu_torch server")
    p.add_argument("--model", default=None,
                   help="an HF or packed-cache model directory, a .gguf file, or "
                        "synth:<BitNetConfig classmethod>, e.g. synth:bitnet_2b (random "
                        "weights at that geometry)")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer directory (default: the model directory; needs "
                        "transformers)")
    p.add_argument("--tiny", action="store_true", help="tiny random model (testing)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=30000)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--num-pages", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-context", type=int, default=4096)
    p.add_argument("--kv-dtype", default="bf16",
                   choices=["bf16", "fp16", "f32", "int8", "fp8_e4m3", "fp8_e5m2"])
    p.add_argument("--kv-layout", default="auto", choices=["auto", "layer", "token"],
                   help="auto: layer (dual) for unquantized KV, token for int8/fp8")
    p.add_argument("--exact-head", type=int, default=0, metavar="K",
                   help="exact greedy head: int8 scan, bf16 top-K rescore, certificate")
    p.add_argument("--no-radix", action="store_true")
    p.add_argument("--no-pallas", action="store_true", help="not a serving path: raises")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks: run under torchrun --nproc-per-node N "
                        "(rank 0 serves HTTP, the others follow it)")
    p.add_argument("--dp", type=int, default=1,
                   help="engine replicas behind a least-loaded router: on the one device "
                        "with --tp 1; with --tp N under torchrun --nproc-per-node N*M, "
                        "replica r on ranks [r*N, (r+1)*N)")
    p.add_argument("--long-context", action="store_true",
                   help="serve greedy prompts of --max-context tokens or more through ring "
                        "attention: on a group of one, or with --tp N on replica 0's "
                        "model group")
    p.add_argument("--window", type=int, default=0,
                   help="sliding-window attention width (0: full attention)")
    p.add_argument("--global-tokens", type=int, default=0,
                   help="with --window: the first N tokens stay visible")
    p.add_argument("--warmup", action="store_true",
                   help="build the kernels and run every serving program once at boot")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    heads_kv = dict(kv_dtype=args.kv_dtype, kv_layout=args.kv_layout,
                    exact_head_k=args.exact_head, enable_radix_cache=not args.no_radix)
    if args.model:
        ecfg = EngineConfig(
            max_batch_slots=args.max_batch,
            page_size=args.page_size,
            num_pages=args.num_pages,
            max_context=args.max_context,
            **heads_kv,
        )
    else:
        ecfg = EngineConfig(**TINY_ENGINE, **heads_kv) if args.tiny else None
    server = create_server(
        args.model, tiny=args.tiny, engine_config=ecfg,
        use_pallas=False if args.no_pallas else None, tp=args.tp, dp=args.dp,
        tokenizer_path=args.tokenizer, long_context=args.long_context,
        attn_window=args.window, attn_global_tokens=args.global_tokens, device=args.device,
    )
    if not isinstance(server, InferenceServer):
        server.serve()  # a follower or another replica's leader; a warmup runs here too
        return
    if args.warmup:
        for e in server.async_engine.engines:
            e.warmup()
    try:
        web.run_app(build_app(server), host=args.host, port=args.port)
    finally:
        if server.async_engine.engine.mesh is not None:
            server.async_engine.shutdown()  # ends the other ranks' serve()


if __name__ == "__main__":
    main()
