"""The port's HTTP server against the reference's, on the CPU.

Both servers run the tiny model on identical weights: the reference's
``create_server(tiny=True, use_pallas=False)`` (aiohttp, as
``tests/test_server.py`` starts it) and the port's ``InferenceServer``
around a port ``Engine`` (``device="cpu"``, the plain versions of its
kernels) on the reference's ``init_params(tiny, seed=0)`` carried over with
``weights.params_from_numpy``, with the reference's tiny ``EngineConfig``.
The same requests go to both, for the surface of ``tests/test_server.py``:
status codes, JSON keys, ``finish_reason``, ``usage`` and error bodies must
be equal. Greedy token ids (read from the engines' requests) must equal a
port ``Engine.generate`` on the same ids exactly; against the reference
they are equal, or part only where the reference's own top-2 logits are
closer than 6e-2 (the rule of ``tests/test_torch_engine.py``). The port's
client, manager and CLI are driven against the port's server.
"""

import asyncio
import concurrent.futures as cf
import json
import math
import socket
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.models.bitnet import KVCache as RefKVCache
from wrinklefree_tpu.models.bitnet import forward as ref_forward
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu.server.http import build_app as ref_build_app
from wrinklefree_tpu.server.http import create_server as ref_create_server
from wrinklefree_tpu_torch.client import AsyncInferenceClient, InferenceClient
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.engine import Engine
from wrinklefree_tpu_torch.server._web import ServerThread
from wrinklefree_tpu_torch.server.http import ByteTokenizer, InferenceServer, build_app

# the reference create_server(tiny=True)'s engine configuration
TINY_ECFG = dict(max_batch_slots=4, page_size=8, num_pages=256, max_context=256,
                 prefill_buckets=(16, 64, 128))
NAME = "wrinklefree-tiny-test"
# A greedy divergence from the reference is accepted only at a near-tie of
# the reference's own logits (tests/test_torch_engine.py's bar).
NEAR_TIE = 6e-2
# embeddings: max abs difference per component of the unit vectors (bf16
# hidden states, mean-pooled in f32; the port's kernels' plain versions
# against the reference's XLA path)
EMBED_TOL = 2e-2
HI = [{"role": "user", "content": "hi"}]
HELLO = [{"role": "user", "content": "hello"}]


def _record(engine):
    """Keep every Request the engine is given (to read its token ids)."""
    reqs = []
    submit = engine.submit

    def rec(*a, **kw):
        r = submit(*a, **kw)
        reqs.append(r)
        return r

    engine.submit = rec
    return reqs


def _wait_health(url):
    for _ in range(200):
        try:
            if requests.get(f"{url}/health", timeout=1).status_code == 200:
                return
        except requests.RequestException:
            pass
        time.sleep(0.05)
    pytest.fail(f"server at {url} did not come up")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, ref_init(RefConfig.tiny(), seed=0))


def _port_engine(weights):
    from wrinklefree_tpu_torch.weights import params_from_numpy

    cfg = BitNetConfig.tiny()
    return Engine(params_from_numpy(weights, cfg, device="cpu"), cfg,
                  EngineConfig(**TINY_ECFG), eos_token_id=0, device="cpu")


@pytest.fixture(scope="module")
def ref():
    from aiohttp import web

    port = _free_port()
    server = ref_create_server(tiny=True, use_pallas=False)
    runner = web.AppRunner(ref_build_app(server))
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    url = f"http://127.0.0.1:{port}"
    _wait_health(url)
    yield types.SimpleNamespace(url=url, server=server,
                                reqs=_record(server.async_engine.engine))
    loop.call_soon_threadsafe(loop.stop)
    server.async_engine.shutdown()


@pytest.fixture(scope="module")
def port(weights):
    eng = _port_engine(weights)
    server = InferenceServer(eng, ByteTokenizer(), NAME)
    st = ServerThread(build_app(server))
    _wait_health(st.url)
    yield types.SimpleNamespace(url=st.url, server=server, engine=eng, reqs=_record(eng))
    st.stop()
    server.async_engine.shutdown()


@pytest.fixture(scope="module")
def oracle(weights):
    """A second port Engine on the same weights: Engine.generate."""
    return _port_engine(weights)


def shape(x):
    """The JSON key structure of a response (values other than objects and
    lists of objects left out)."""
    if isinstance(x, dict):
        return {k: shape(v) for k, v in x.items()}
    if isinstance(x, list) and any(isinstance(v, dict) for v in x):
        return [shape(v) for v in x]
    return None


def both(ref, port, path, body=None, method="post", **kw):
    """The same request to both servers: equal status codes."""
    out = []
    for s in (ref, port):
        fn = requests.post if method == "post" else requests.get
        args = {"json": body} if body is not None and "data" not in kw else {}
        out.append(fn(f"{s.url}{path}", timeout=120, **args, **kw))
    assert out[0].status_code == out[1].status_code, (out[0].text, out[1].text)
    return out


def both_json(ref, port, path, body=None, **kw):
    """Equal status codes and equal JSON key structure."""
    r, p = both(ref, port, path, body, **kw)
    rj, pj = r.json(), p.json()
    assert shape(pj) == shape(rj), (rj, pj)
    return rj, pj


def sse(resp):
    """The JSON events of an SSE response, and whether it ended in [DONE]."""
    lines = [line for line in resp.iter_lines() if line]
    assert all(line.startswith(b"data: ") for line in lines)
    done = lines and lines[-1] == b"data: [DONE]"
    return [json.loads(line[6:]) for line in lines if line != b"data: [DONE]"], done


def ref_top2_gap(weights, ids, n):
    """The reference's top-2 logit gap for the token after ids[:n] (its
    dense forward on the same weights)."""
    cfg = RefConfig.tiny()
    params = jax.tree.map(jnp.asarray, weights)
    cache = RefKVCache.zeros(cfg, 1, -(-n // 8) * 8)
    logits, _ = ref_forward(params, cfg, jnp.asarray([ids[:n]], jnp.int32), cache,
                            jnp.zeros((1,), jnp.int32), logits_all=False)
    top2 = np.sort(np.asarray(logits)[0])[-2:]
    return float(top2[1] - top2[0])


def last_req(server):
    return server.reqs[-1]


def greedy(ref, port, oracle, weights, path, body):
    """One greedy request to both servers, prefix caches reset first. The
    port's token ids equal the oracle's Engine.generate on the same prompt
    (a prefix of it when a stop string cut the request); against the
    reference's ids, equal or parted at a near-tie. Returns both JSON
    bodies."""
    for s in (ref, port):
        assert requests.post(f"{s.url}/admin/reset-cache", timeout=30).status_code == 200
    oracle.reset_prefix_cache()
    rj, pj = both_json(ref, port, path, body)
    got, want = last_req(port), last_req(ref)
    assert got.prompt_ids == want.prompt_ids
    full = oracle.generate(got.prompt_ids, got.sampling)
    assert full.output_ids[: len(got.output_ids)] == got.output_ids
    if got.finish_reason not in ("stop", "abort") or not got.output_ids:
        assert got.output_ids == full.output_ids
    a, b = got.output_ids, want.output_ids
    if a[: len(b)] != b[: len(a)]:
        step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = ref_top2_gap(weights, want.prompt_ids + b, len(want.prompt_ids) + step)
        assert gap < NEAR_TIE, f"diverged from the reference at token {step}, top-2 gap {gap}"
    else:
        assert len(a) == len(b) and got.finish_reason == want.finish_reason
    return rj, pj


@pytest.fixture()
def client(port):
    return InferenceClient(port.url)


# -- the surface of tests/test_server.py ------------------------------------


class TestSmoke:
    def test_health(self, ref, port, client):
        both_json(ref, port, "/health", method="get")
        assert client.health()

    def test_models(self, ref, port, client):
        rj, pj = both_json(ref, port, "/v1/models", method="get")
        assert pj == rj and client.models() == [NAME]

    def test_tokenize_detokenize(self, ref, port, client):
        rj, pj = both_json(ref, port, "/tokenize", {"content": "hello world"})
        assert pj == rj and client.tokenize("hello world") == rj["tokens"]
        rj, pj = both_json(ref, port, "/detokenize", {"tokens": rj["tokens"]})
        assert pj == rj == {"content": "hello world"}

    def test_generate(self, ref, port, oracle, weights):
        rj, pj = greedy(ref, port, oracle, weights, "/completion",
                        {"prompt": "hello", "n_predict": 8, "temperature": 0.0})
        assert (pj["stop"], pj["tokens_evaluated"]) == (rj["stop"], rj["tokens_evaluated"])

    def test_chat(self, ref, port, oracle, weights):
        rj, pj = greedy(ref, port, oracle, weights, "/v1/chat/completions",
                        {"model": "m", "messages": HI, "max_tokens": 8, "temperature": 0.0,
                         "ignore_eos": True})
        assert pj["usage"] == rj["usage"]
        assert pj["choices"][0]["finish_reason"] == rj["choices"][0]["finish_reason"]

    def test_completions(self, ref, port, oracle, weights):
        rj, pj = greedy(ref, port, oracle, weights, "/v1/completions",
                        {"model": "m", "prompt": "hello", "max_tokens": 12,
                         "temperature": 0.0, "ignore_eos": True})
        assert pj["usage"] == rj["usage"] == {"prompt_tokens": 5, "completion_tokens": 12,
                                               "total_tokens": 17}
        assert pj["choices"][0]["finish_reason"] == rj["choices"][0]["finish_reason"] == "length"

    def test_stats(self, ref, port, client):
        r, p = both(ref, port, "/stats", method="get")
        rj, pj = r.json(), p.json()
        server_keys = ("free_pages", "cached_pages", "active_slots", "queued", "latency")
        assert all(k in pj for k in server_keys)
        assert shape(pj["latency"]) == shape(rj["latency"])
        # the port's engine counters are a subset of the reference's
        assert set(pj) - set(server_keys) <= set(rj) - set(server_keys)
        s = client.stats()
        assert s["requests"] >= 1 and "free_pages" in s


class TestStreaming:
    def test_chat_stream_sse(self, ref, port, client):
        chunks = list(client.chat_stream(HELLO, max_tokens=8, temperature=0.0))
        assert "".join(chunks) == client.chat(HELLO, max_tokens=8, temperature=0.0)
        body = {"model": "m", "messages": HELLO, "max_tokens": 8, "temperature": 0.0,
                "stream": True}
        (rev, rdone), (pev, pdone) = (sse(r) for r in both(ref, port, "/v1/chat/completions",
                                                           body, stream=True))
        assert rdone and pdone
        assert shape(pev[0]) == shape(rev[0]) and shape(pev[-1]) == shape(rev[-1])
        assert pev[-1]["choices"][0]["finish_reason"] == rev[-1]["choices"][0]["finish_reason"]

    def test_completion_stream(self, ref, port, client):
        chunks = list(client.generate_stream("abc", max_tokens=6, temperature=0.0))
        assert "".join(chunks) == client.generate("abc", max_tokens=6, temperature=0.0)
        body = {"prompt": "abc", "n_predict": 6, "temperature": 0.0, "stream": True}
        (rev, _), (pev, _) = (sse(r) for r in both(ref, port, "/completion", body, stream=True))
        assert [shape(e) for e in pev] == [shape(e) for e in rev]
        assert pev[-1]["stop"] and rev[-1]["stop"]

    def test_streamed_text_equals_nonstreamed(self, port, client):
        body = {"model": "m", "prompt": "stream me", "max_tokens": 10, "temperature": 0.0}
        full = requests.post(f"{port.url}/v1/completions", json=body, timeout=60).json()
        r = requests.post(f"{port.url}/v1/completions", json={**body, "stream": True},
                          stream=True, timeout=60)
        events, done = sse(r)
        assert done
        text = "".join(e["choices"][0]["text"] for e in events)
        assert text == full["choices"][0]["text"]
        assert events[-1]["choices"][0]["finish_reason"] == full["choices"][0]["finish_reason"]

    def test_raw_sse_format(self, ref, port):
        body = {"model": "m", "messages": [{"role": "user", "content": "x"}],
                "max_tokens": 4, "stream": True}
        for r in both(ref, port, "/v1/chat/completions", body, stream=True):
            assert r.headers["Content-Type"].startswith("text/event-stream")
            events, done = sse(r)
            assert done
            assert events[0]["object"] == "chat.completion.chunk"
            assert events[0]["choices"][0]["delta"].get("role") == "assistant"


class TestValidation:
    def test_bad_json(self, ref, port):
        r, p = both(ref, port, "/v1/chat/completions", data="{not json",
                    headers={"Content-Type": "application/json"})
        assert p.status_code == 400 and p.json() == r.json()

    def test_missing_messages(self, ref, port):
        r, p = both(ref, port, "/v1/chat/completions", {"model": "m"})
        assert p.status_code == 400 and p.json() == r.json()

    def test_unknown_route(self, ref, port):
        r, p = both(ref, port, "/v1/nothing-here", {"x": 1})
        assert p.status_code == 404

    def test_determinism_at_temp0(self, client):
        outs = {client.generate("same prompt", max_tokens=8, temperature=0.0)
                for _ in range(3)}
        assert len(outs) == 1

    def test_concurrent_requests(self, port, oracle):
        """8 concurrent requests on 4 slots: each request's tokens equal
        Engine.generate on its prompt."""
        def one(i):
            return InferenceClient(port.url).generate(f"prompt {i}", max_tokens=6,
                                                      temperature=0.0)

        n0 = len(port.reqs)
        with cf.ThreadPoolExecutor(8) as ex:
            results = list(ex.map(one, range(8)))
        assert len(results) == 8
        for req in port.reqs[n0:]:
            assert oracle.generate(req.prompt_ids, req.sampling).output_ids == req.output_ids
        assert InferenceClient(port.url).generate(
            "prompt 3", max_tokens=6, temperature=0.0) == results[3]

    @pytest.mark.parametrize("bad_n", ["abc", 0, 17])
    def test_bad_n_400(self, ref, port, bad_n):
        r, p = both(ref, port, "/v1/completions",
                    {"model": "m", "prompt": "x", "max_tokens": 2, "n": bad_n})
        assert p.status_code == 400 and p.json() == r.json()

    def test_stream_with_oversized_logit_bias_400s_cleanly(self, ref, port):
        r, p = both(ref, port, "/v1/chat/completions",
                    {"model": "m", "messages": [{"role": "user", "content": "x"}],
                     "max_tokens": 4, "stream": True,
                     "logit_bias": {str(i): 1 for i in range(17)}})
        assert p.status_code == 400 and p.json() == r.json()

    def test_json_mode_plus_logprobs_400(self, ref, port):
        r, p = both(ref, port, "/v1/chat/completions",
                    {"model": "m", "messages": [{"role": "user", "content": "x"}],
                     "max_tokens": 4, "logprobs": True,
                     "response_format": {"type": "json_object"}})
        assert p.status_code == 400 and p.json() == r.json()

    def test_bad_schema_400(self, ref, port):
        r, p = both(ref, port, "/completion",
                    {"prompt": "x", "n_predict": 4, "json_schema": "not a dict"})
        assert p.status_code == 400

    @pytest.mark.parametrize("framing", ["content-length", "chunked"])
    def test_oversized_body_413(self, port, monkeypatch, framing):
        """A body past MAX_BODY gets 413 and the connection closes, whether
        its length is declared or it comes in chunks; a chunked body under
        the limit is served. The limit is lowered to 1 KiB for the test, and
        only the bytes the server reads before refusing are sent."""
        from wrinklefree_tpu_torch.server import _web

        monkeypatch.setattr(_web, "MAX_BODY", 1024)
        host, p = port.url.removeprefix("http://").split(":")

        def send(head, body=b""):
            with socket.create_connection((host, int(p)), timeout=30) as sk:
                sk.sendall(f"POST /tokenize HTTP/1.1\r\nHost: x\r\n{head}\r\n".encode()
                           + body)
                data = b""
                while chunk := sk.recv(65536):  # the server closes after its answer
                    data += chunk
            return data

        if framing == "content-length":
            resp = send("Content-Length: 2048\r\n")
        else:
            resp = send("Transfer-Encoding: chunked\r\n",
                        b"320\r\n" + b" " * 800 + b"\r\n320\r\n")
        assert resp.startswith(b"HTTP/1.1 413 ")
        body = json.dumps({"content": "hi"}).encode()
        ok = requests.post(f"{port.url}/tokenize", data=iter([body[:5], body[5:]]))
        want = requests.post(f"{port.url}/tokenize", json={"content": "hi"}).json()
        assert ok.status_code == 200 and ok.json() == want


class TestStopStrings:
    """Generation truncates at the earliest stop string, never emits it, and
    streaming never leaks a partial prefix of it (on the port's own text,
    as tests/test_server.py on the reference's)."""

    def _full_text(self, url, max_tokens=16):
        return requests.post(
            f"{url}/v1/chat/completions",
            json={"model": "m", "messages": HELLO, "max_tokens": max_tokens,
                  "temperature": 0.0}, timeout=120,
        ).json()["choices"][0]["message"]["content"]

    def _stop_body(self, stop, **kw):
        return {"model": "m", "messages": HELLO, "max_tokens": 16, "temperature": 0.0,
                "stop": stop, **kw}

    def test_chat_nonstream_stop_truncates(self, ref, port, oracle, weights):
        full = self._full_text(port.url)
        assert len(full) >= 6
        stop = full[3:5]
        rj, pj = greedy(ref, port, oracle, weights, "/v1/chat/completions",
                        self._stop_body(stop))
        text = pj["choices"][0]["message"]["content"]
        assert text == full[: full.index(stop)] and stop not in text
        assert pj["choices"][0]["finish_reason"] == "stop"

    def test_chat_stream_stop_never_leaks(self, port):
        full = self._full_text(port.url)
        stop = full[3:5]
        r = requests.post(f"{port.url}/v1/chat/completions",
                          json=self._stop_body(stop, stream=True), stream=True, timeout=120)
        events, done = sse(r)
        text = "".join(e["choices"][0]["delta"].get("content", "") for e in events)
        assert done and text == full[: full.index(stop)]
        assert events[-1]["choices"][0]["finish_reason"] == "stop"

    def test_stop_list_earliest_wins(self, port):
        full = self._full_text(port.url)
        s1, s2 = full[6:8], full[2:4]
        r = requests.post(f"{port.url}/v1/chat/completions", json=self._stop_body([s1, s2]),
                          timeout=120).json()
        assert r["choices"][0]["message"]["content"] == full[:min(full.index(s1),
                                                                   full.index(s2))]

    def test_llamacpp_stopped_word(self, ref, port):
        def run(url, stop=None):
            body = {"prompt": "hello", "n_predict": 16, "temperature": 0.0}
            return requests.post(f"{url}/completion", timeout=120,
                                 json={**body, **({"stop": [stop]} if stop else {})}).json()

        full = run(port.url)["content"]
        stop = full[3:5]
        r = run(port.url, stop)
        assert r["content"] == full[: full.index(stop)]
        assert r["stopped_word"] is True and r["stopping_word"] == stop
        assert r["stopped_eos"] is False
        rr = run(ref.url, run(ref.url)["content"][3:5])
        assert shape(r) == shape(rr)
        assert {k: r[k] for k in ("stop", "stopped_word", "stopped_eos", "stopped_limit")} == \
            {k: rr[k] for k in ("stop", "stopped_word", "stopped_eos", "stopped_limit")}

    def test_no_stop_unaffected(self, port):
        full = self._full_text(port.url)
        r = requests.post(f"{port.url}/v1/chat/completions",
                          json=self._stop_body("ZZZZQQ"), timeout=120).json()
        assert r["choices"][0]["message"]["content"] == full


class TestCancel:
    def test_engine_cancel_frees_slot(self, port):
        for i in range(6):
            requests.post(f"{port.url}/v1/chat/completions",
                          json={"model": "m",
                                "messages": [{"role": "user", "content": f"q{i}"}],
                                "max_tokens": 16, "temperature": 0.0, "stop": "a"},
                          timeout=120)
        stats = requests.get(f"{port.url}/stats", timeout=10).json()
        assert stats["active_slots"] == 0 and stats["queued"] == 0

    def test_disconnect_cancels_the_request(self, port):
        """A streaming client that goes away mid-stream: the request is
        cancelled ("abort") long before its token budget, its slot freed."""
        n0 = len(port.reqs)
        r = requests.post(f"{port.url}/v1/completions",
                          json={"model": "m", "prompt": "go on", "max_tokens": 240,
                                "temperature": 0.0, "ignore_eos": True, "stream": True},
                          stream=True, timeout=60)
        next(r.iter_lines())
        r.close()
        req = port.reqs[n0]
        for _ in range(400):
            if req.finished:
                break
            time.sleep(0.01)
        assert req.finished and req.finish_reason == "abort", req.finish_reason
        assert len(req.output_ids) < 240
        for _ in range(100):
            if requests.get(f"{port.url}/stats", timeout=10).json()["active_slots"] == 0:
                break
            time.sleep(0.01)
        else:
            pytest.fail("the cancelled request kept its slot")


class TestSamplerParams:
    def test_seed_determinism_at_temp1(self, ref, port):
        def run(url, seed):
            return requests.post(
                f"{url}/v1/chat/completions",
                json={"model": "m", "messages": HELLO, "max_tokens": 12,
                      "temperature": 1.0, "seed": seed}, timeout=120,
            ).json()

        a, b, c = run(port.url, 42), run(port.url, 42), run(port.url, 43)
        text = [x["choices"][0]["message"]["content"] for x in (a, b, c)]
        assert text[0] == text[1] and text[0] != text[2]
        assert shape(a) == shape(run(ref.url, 42))

    def test_top_k_one_equals_greedy(self, port):
        def run(extra):
            return requests.post(f"{port.url}/completion",
                                 json={"prompt": "hello", "n_predict": 10, **extra},
                                 timeout=120).json()["content"]

        greedy_text = run({"temperature": 0.0})
        assert run({"temperature": 1.0, "top_k": 1}) == greedy_text
        assert run({"temperature": 1.0, "min_p": 1.0}) == greedy_text

    def test_min_p_parsed_and_served(self, ref, port):
        rj, pj = both_json(ref, port, "/completion",
                           {"prompt": "hi", "n_predict": 4, "temperature": 0.9,
                            "min_p": 0.05, "seed": 7, "ignore_eos": True})
        assert pj["tokens_predicted"] == rj["tokens_predicted"] == 4

    def test_typical_and_tfs_accepted_and_seeded(self, port):
        def run():
            return requests.post(
                f"{port.url}/completion",
                json={"prompt": "hello", "n_predict": 6, "temperature": 1.0, "seed": 5,
                      "typical_p": 0.5, "tfs_z": 0.9}, timeout=120).json()["content"]

        assert run() == run()


class TestOpsEndpoints:
    def test_props(self, ref, port):
        rj, pj = both_json(ref, port, "/props", method="get")
        assert pj == rj and pj["total_slots"] == 4

    def test_slots_reflect_occupancy(self, ref, port):
        rj, pj = both_json(ref, port, "/slots", method="get")
        assert len(pj) == len(rj) == 4
        assert all(s["state"] in ("idle", "prefill", "decoding") for s in pj)

    def test_latency_percentiles(self, ref, port):
        both(ref, port, "/v1/completions",
             {"model": "m", "prompt": "warm", "max_tokens": 2, "temperature": 0.0})
        lat = requests.get(f"{port.url}/stats", timeout=30).json()["latency"]
        assert lat["window"] >= 1
        assert 0 < lat["ttft_s"]["p50"] <= lat["ttft_s"]["p99"]
        assert lat["ttft_s"]["p50"] <= lat["e2e_s"]["p50"]

    def test_metrics_prometheus(self, ref, port):
        both(ref, port, "/v1/completions",
             {"model": "m", "prompt": "hi", "max_tokens": 2, "temperature": 0.0})
        r, p = both(ref, port, "/metrics", method="get")
        assert p.headers["Content-Type"].startswith("text/plain")

        def parse(text):
            return {k: float(v) for k, v in (line.rsplit(" ", 1) for line in
                                             text.splitlines() if line and line[0] != "#")}

        rm, pm = parse(r.text), parse(p.text)
        assert set(pm) == set(rm)
        assert pm["wf_requests_total"] >= 1 and pm["wf_decode_tokens_total"] >= 1
        assert pm["wf_slots_total"] == 4 and pm["wf_uptime_seconds"] > 0
        assert 'wf_ttft_seconds{quantile="0.50"}' in pm
        assert 'wf_e2e_latency_seconds{quantile="0.99"}' in pm

    def test_client_embeddings(self, client):
        e1 = client.embed("hello")
        (e2,) = client.embeddings("hello")
        assert e1 == e2 and len(e1) == 128


class TestEmbeddings:
    def test_openai_single(self, ref, port):
        rj, pj = both_json(ref, port, "/v1/embeddings", {"model": "m", "input": "hello world"})
        emb = pj["data"][0]["embedding"]
        assert abs(math.sqrt(sum(x * x for x in emb)) - 1.0) < 1e-3
        assert pj["usage"] == rj["usage"] and pj["usage"]["prompt_tokens"] == 11
        err = np.max(np.abs(np.asarray(emb) - np.asarray(rj["data"][0]["embedding"])))
        assert err < EMBED_TOL, err

    @pytest.mark.parametrize("text", ["a", "abcdefghijklmnopq",
                                      "a longer input of ninety-two bytes " * 2 + "or so" * 5])
    def test_matches_reference(self, ref, port, text):
        """Buckets 16, 32 and 128 against the reference."""
        rj, pj = both_json(ref, port, "/embedding", {"content": text})
        err = np.max(np.abs(np.asarray(pj["embedding"]) - np.asarray(rj["embedding"])))
        assert err < EMBED_TOL, err

    def test_openai_batch_and_determinism(self, port):
        def get(texts):
            return requests.post(f"{port.url}/v1/embeddings",
                                 json={"model": "m", "input": texts}, timeout=120).json()["data"]

        a, b = get(["alpha", "beta"]), get(["alpha"])
        assert [d["index"] for d in a] == [0, 1]
        assert a[0]["embedding"] == b[0]["embedding"]
        assert a[0]["embedding"] != a[1]["embedding"]

    def test_padding_invariance(self, port):
        text = "abcdefghijklmnopq"  # 17 bytes -> bucket 32
        oa = requests.post(f"{port.url}/v1/embeddings", json={"model": "m", "input": text},
                           timeout=120).json()["data"][0]["embedding"]
        lc = requests.post(f"{port.url}/embedding", json={"content": text},
                           timeout=120).json()["embedding"]
        assert oa == lc

    def test_token_id_input(self, ref, port):
        one = both_json(ref, port, "/v1/embeddings", {"model": "m", "input": [105, 102, 109]})[1]
        batch = both_json(ref, port, "/v1/embeddings",
                          {"model": "m", "input": [[105, 102, 109], [106]]})[1]
        assert len(batch["data"]) == 2
        assert batch["data"][0]["embedding"] == one["data"][0]["embedding"]
        r, p = both(ref, port, "/v1/embeddings", {"model": "m", "input": {"not": "valid"}})
        assert p.status_code == 400 and p.json() == r.json()


class TestOpenAIExtras:
    def test_n_choices(self, ref, port):
        body = {"model": "m", "messages": HI, "max_tokens": 6, "temperature": 1.0, "n": 3,
                "ignore_eos": True}
        rj, pj = both_json(ref, port, "/v1/chat/completions", body)
        assert [c["index"] for c in pj["choices"]] == [0, 1, 2]
        assert len({c["message"]["content"] for c in pj["choices"]}) > 1
        assert pj["usage"] == rj["usage"] and pj["usage"]["completion_tokens"] == 18

    def test_n_with_seed_is_deterministic(self, port):
        def run():
            r = requests.post(f"{port.url}/v1/completions",
                              json={"model": "m", "prompt": "hello", "max_tokens": 5,
                                    "temperature": 1.0, "n": 2, "seed": 9},
                              timeout=120).json()
            return [c["text"] for c in r["choices"]]

        a, b = run(), run()
        assert a == b and a[0] != a[1]

    def test_echo(self, ref, port):
        body = {"model": "m", "prompt": "hello", "max_tokens": 3, "temperature": 0.0}
        rj, pj = both_json(ref, port, "/v1/completions", {**body, "echo": True})
        no_echo = requests.post(f"{port.url}/v1/completions", json=body, timeout=120).json()
        text = pj["choices"][0]["text"]
        assert text == "hello" + no_echo["choices"][0]["text"]

    @pytest.mark.parametrize("path,body", [
        ("/v1/chat/completions", {"model": "m", "messages": HI}),
        ("/v1/completions", {"model": "m", "prompt": "hi"}),
    ])
    def test_stream_include_usage(self, ref, port, path, body):
        body = {**body, "max_tokens": 5, "temperature": 0.0, "stream": True,
                "ignore_eos": True, "stream_options": {"include_usage": True}}
        usages = []
        for r in both(ref, port, path, body, stream=True):
            events, done = sse(r)
            assert done and events[-1]["choices"] == []
            usages.append(events[-1]["usage"])
        assert usages[1] == usages[0] and usages[1]["completion_tokens"] == 5

    @pytest.mark.parametrize("path,body,want", [
        # ByteTokenizer decodes id -> chr(id - 1): 88 -> 'W'; +100 dominates
        ("/v1/completions", {"model": "m", "prompt": "hello", "max_tokens": 4,
                             "logit_bias": {"88": 100}}, "WWWW"),
        # -100 is a hard ban, so 91 at +90 ('Z') takes over
        ("/v1/completions", {"model": "m", "prompt": "hello", "max_tokens": 3,
                             "logit_bias": {"88": -100, "91": 90}}, "ZZZ"),
        # llama.cpp form: [[id, bias]]; 89 -> 'X'
        ("/completion", {"prompt": "hi", "n_predict": 3, "logit_bias": [[89, 100.0]]}, "XXX"),
    ])
    def test_logit_bias(self, ref, port, path, body, want):
        rj, pj = both_json(ref, port, path, {**body, "temperature": 0.0})
        for j in (rj, pj):
            assert (j["choices"][0]["text"] if "choices" in j else j["content"]) == want

    def test_logit_bias_parse_mapping(self):
        s = InferenceServer.__new__(InferenceServer)
        s.async_engine = types.SimpleNamespace(
            engine=types.SimpleNamespace(ecfg=types.SimpleNamespace(logit_bias_slots=16)))
        sp = s._sampling_from({"logit_bias": {"7": -100, "9": 55}})
        assert sp.logit_bias == [(7, -1e9), (9, 55.0)]
        sp = s._sampling_from({"logit_bias": [[7, False], [9, -2.5]]}, is_llamacpp=True)
        assert sp.logit_bias == [(7, -1e9), (9, -2.5)]

    def test_stream_n_gt_1_rejected(self, ref, port):
        r, p = both(ref, port, "/v1/chat/completions",
                    {"model": "m", "messages": HI, "max_tokens": 4, "stream": True, "n": 2})
        assert p.status_code == 400 and p.json() == r.json()


class TestAdminResetCache:
    def test_reset_cache_idle(self, ref, port):
        both(ref, port, "/admin/reset-cache")
        both(ref, port, "/completion", {"prompt": "warm the cache with some tokens here",
                                        "n_predict": 4, "temperature": 0.0})
        rj, pj = both_json(ref, port, "/admin/reset-cache")
        assert pj == rj and pj["dropped_pages"][0] > 0
        rj, pj = both_json(ref, port, "/admin/reset-cache")
        assert pj == rj == {"dropped_pages": [0]}


class TestTimings:
    def test_llamacpp_timings_block(self, ref, port):
        rj, pj = both_json(ref, port, "/completion",
                           {"prompt": "hello", "n_predict": 4, "temperature": 0.0,
                            "ignore_eos": True})
        t = pj["timings"]
        assert t["predicted_n"] == rj["timings"]["predicted_n"] == 4
        assert t["prompt_n"] == rj["timings"]["prompt_n"] == 5
        assert t["prompt_ms"] > 0 and t["predicted_ms"] >= 0
        assert "predicted_per_second" in t


# -- the request features the port once answered 501 for -------------------


def ref_logits(weights, ids, n):
    """The reference's logits for the token after ids[:n] (its dense forward
    on the same weights)."""
    cfg = RefConfig.tiny()
    params = jax.tree.map(jnp.asarray, weights)
    cache = RefKVCache.zeros(cfg, 1, -(-n // 8) * 8)
    logits, _ = ref_forward(params, cfg, jnp.asarray([ids[:n]], jnp.int32), cache,
                            jnp.zeros((1,), jnp.int32), logits_all=False)
    return np.asarray(logits)[0]


def _legal(sampling, pieces, text, vocab):
    """The tokens a constrained request may emit after ``text`` (all tokens
    for an unconstrained one)."""
    if not sampling.constrained:
        return np.arange(vocab)
    from wrinklefree_tpu_torch.engine.constrained import make_validator

    v = make_validator(None, sampling)
    v.advance(text)
    return np.asarray([t for t, piece in enumerate(pieces)
                       if piece and v.clone().advance(piece) != "dead"])


FEATURES = [
    ("/v1/chat/completions", {"messages": HI, "logprobs": True, "top_logprobs": 2,
                              "temperature": 0.0}),
    ("/v1/completions", {"prompt": "hello", "logprobs": 2, "temperature": 0.0}),
    ("/completion", {"prompt": "hello", "n_probs": 3, "temperature": 0.0}),
    ("/v1/completions", {"prompt": "j", "response_format": {"type": "json_object"},
                         "temperature": 0.0}),
    ("/v1/chat/completions", {"messages": HI, "temperature": 0.0, "response_format": {
        "type": "json_schema", "json_schema": {"name": "n", "schema": {"type": "object"}}}}),
    ("/completion", {"prompt": "x", "grammar": 'root ::= "yes" | "no"', "temperature": 0.0}),
    ("/completion", {"prompt": "x", "json_schema": {}, "temperature": 0.0}),
    ("/completion", {"prompt": "hello", "temperature": 1.0, "seed": 11, "mirostat": 2}),
    ("/v1/chat/completions", {"messages": HI, "stream": True, "logprobs": True,
                              "temperature": 0.0}),
    ("/admin/snapshot", None),
    ("/admin/restore", {"version": 1, "requests": []}),
]


@pytest.mark.parametrize("path,body", FEATURES)
def test_missing_features_answer_501(ref, port, oracle, weights, path, body):
    """Requests the port once answered 501 (logprobs in the three dialects,
    json_object / json_schema / GBNF, mirostat, a streamed chat with logprobs,
    /admin/snapshot and /admin/restore): both servers answer 200 with bodies
    of the same JSON key structure (a stream: the same events' structure).
    A greedy request's token ids equal the oracle Engine.generate's and the
    reference's, parting from the reference only at a near-tie of its own
    logits among the tokens the request may emit; equal ids, equal text."""
    if path.startswith("/admin"):
        r, p = both(ref, port, path, body)
        assert p.status_code == 200
        assert p.json() == r.json()  # idle servers: no requests to snapshot, none restored
        return
    body = {**body, "max_tokens": 4, "n_predict": 4}
    for s in (ref, port):
        assert requests.post(f"{s.url}/admin/reset-cache", timeout=30).status_code == 200
    r, p = both(ref, port, path, body, stream=bool(body.get("stream")))
    assert p.status_code == 200
    if body.get("stream"):
        (r_ev, r_done), (p_ev, p_done) = sse(r), sse(p)
        assert r_done and p_done
        assert [shape(e) for e in p_ev] == [shape(e) for e in r_ev]
        content = [e["choices"][0]["logprobs"]["content"][0] for e in p_ev
                   if e["choices"] and e["choices"][0].get("logprobs")]
        assert [c["logprob"] for c in content] == [c for c, _ in last_req(port).logprobs_seq]
        assert len(content) == len(last_req(port).output_ids)
    else:
        rj, pj = r.json(), p.json()
        assert shape(pj) == shape(rj), (rj, pj)
    got, want = last_req(port), last_req(ref)
    assert got.prompt_ids == want.prompt_ids
    assert len(got.logprobs_seq) == (len(got.output_ids) if got.sampling.logprobs_k else 0)
    for (c, tops), tok in zip(got.logprobs_seq, got.output_ids):
        assert tops[0][0] == tok and c == tops[0][1] and c <= 0
    if got.sampling.temperature > 0:
        return  # sampled: the full model's logits part by up to 6e-2 (see the module doc)
    pieces = port.engine.token_pieces or ref.server.async_engine.engine.token_pieces
    oracle.token_pieces = pieces
    oracle.reset_prefix_cache()
    assert oracle.generate(got.prompt_ids, got.sampling).output_ids == got.output_ids
    a, b = got.output_ids, want.output_ids
    step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if step is not None:
        text = ByteTokenizer().decode(b[:step])
        legal = _legal(want.sampling, pieces, text, oracle.cfg.vocab_size)
        lg = ref_logits(weights, want.prompt_ids + b, len(want.prompt_ids) + step)[legal]
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, f"diverged at token {step}"
    else:
        assert len(a) == len(b) and len(got.logprobs_seq) == len(want.logprobs_seq)
    if step is None and not body.get("stream"):
        text = {"/completion": lambda j: j["content"],
                "/v1/completions": lambda j: j["choices"][0]["text"],
                "/v1/chat/completions": lambda j: j["choices"][0]["message"]["content"]}[path]
        assert text(pj) == text(rj)


RESTORE_ENTRY = {
    "prompt_ids": [105, 106], "output_ids": [], "counter_base": 0, "seed": 1,
    "max_new_tokens": 3, "temperature": 0.0, "top_p": 1.0, "top_k": 0, "min_p": 0.0,
    "stop_token_ids": [], "ignore_eos": True, "repetition_penalty": 1.0,
    "presence_penalty": 0.0, "frequency_penalty": 0.0, "penalty_last_n": 64,
    "logprobs_k": 0, "logit_bias": [], "json_mode": False,
}


class TestAdminSnapshot:
    """/admin/snapshot captures in-flight requests (token ids and sampler
    state); /admin/restore resubmits them (tests/test_server.py's cases)."""

    def test_snapshot_captures_inflight_and_restores(self, ref, port):
        def long_req():
            return requests.post(f"{port.url}/v1/completions",
                                 json={"model": "m", "prompt": "slow", "max_tokens": 200,
                                       "temperature": 0.0, "ignore_eos": True}, timeout=300)

        with cf.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(long_req)
            snap = None
            for _ in range(200):
                snap = requests.post(f"{port.url}/admin/snapshot", timeout=30).json()
                if snap["requests"]:
                    break
                time.sleep(0.02)
            assert snap and len(snap["requests"]) == 1
            d = snap["requests"][0]
            assert d["prompt_ids"] == ByteTokenizer().encode("slow")
            assert d["max_new_tokens"] + len(d["output_ids"]) == 200
            assert d["counter_base"] == len(d["output_ids"])
            assert fut.result().status_code == 200
        body = {"version": 1, "requests": [RESTORE_ENTRY]}
        n0, tok0 = port.engine.stats["requests"], port.engine.stats["decode_tokens"]
        rj, pj = both_json(ref, port, "/admin/restore", body)
        assert pj == rj == {"restored": 1}
        for _ in range(200):  # the restored request runs on the scheduler thread
            if not port.engine.has_work():
                break
            time.sleep(0.05)
        assert not port.engine.has_work() and port.engine.stats["requests"] == n0 + 1
        # 3 tokens: the prefill's first and 2 decoded
        assert port.engine.stats["decode_tokens"] == tok0 + 2

    @pytest.mark.parametrize("body", [{"version": 99},
                                      {"version": 1, "requests": [{"prompt_ids": [1]}]}])
    def test_restore_bad_snapshot_400(self, ref, port, body):
        rj, pj = both_json(ref, port, "/admin/restore", body)
        assert set(pj) == {"error"}
        assert not port.engine.has_work()


def test_streamed_completion_logprobs(ref, port):
    """Streamed legacy completions with ``logprobs`` and llama.cpp
    /completion with ``n_probs``: the same events' structure as the
    reference's, one logprobs object per token."""
    for path, body in (("/v1/completions", {"prompt": "hello", "logprobs": 2}),
                       ("/completion", {"prompt": "hello", "n_probs": 2})):
        body = {**body, "max_tokens": 5, "n_predict": 5, "temperature": 0.0,
                "ignore_eos": True, "stream": True}
        r, p = both(ref, port, path, body, stream=True)
        (r_ev, _), (p_ev, _) = sse(r), sse(p)
        assert p.status_code == 200
        assert [shape(e) for e in p_ev] == [shape(e) for e in r_ev]
        key = "completion_probabilities" if path == "/completion" else "choices"
        assert sum(1 for e in p_ev if key in e and (
            key != "choices" or e["choices"][0]["logprobs"])) == 5


def test_logprobs_stay_aligned_while_json_mode_active(port):
    """A logprobs request decoding beside a json_mode request (segregated
    decode) gets one logprobs entry per token."""
    def json_req():
        return requests.post(f"{port.url}/v1/completions",
                             json={"model": "m", "prompt": "j", "max_tokens": 40,
                                   "temperature": 0.0, "ignore_eos": True,
                                   "response_format": {"type": "json_object"}},
                             timeout=300).json()

    def lp_req():
        return requests.post(f"{port.url}/v1/completions",
                             json={"model": "m", "prompt": "lp", "max_tokens": 8,
                                   "temperature": 0.0, "ignore_eos": True, "logprobs": 2},
                             timeout=300).json()

    with cf.ThreadPoolExecutor(2) as ex:
        fj = ex.submit(json_req)
        time.sleep(0.2)
        lp = ex.submit(lp_req).result()
        text = fj.result()["choices"][0]["text"]
    from wrinklefree_tpu_torch.engine.json_constraint import JsonPrefixValidator

    assert JsonPrefixValidator().advance(text) in ("ok", "complete")
    c = lp["choices"][0]["logprobs"]
    assert len(c["tokens"]) == len(c["token_logprobs"]) == len(c["top_logprobs"]) == 8


# -- data-parallel replicas ------------------------------------------------


@pytest.fixture(scope="module")
def dp_url(weights):
    e0 = _port_engine(weights)
    e1 = Engine(e0.params, e0.cfg, e0.ecfg, eos_token_id=0, device="cpu")  # shared weights
    server = InferenceServer([e0, e1], ByteTokenizer(), NAME)
    st = ServerThread(build_app(server))
    yield st.url
    st.stop()
    server.async_engine.shutdown()


class TestDataParallel:
    def test_dp_requests_distribute_across_replicas(self, dp_url):
        def gen(i):
            return requests.post(f"{dp_url}/v1/completions",
                                 json={"model": "m", "prompt": f"hello {i}",
                                       "max_tokens": 24, "temperature": 0.0},
                                 timeout=120).status_code

        with cf.ThreadPoolExecutor(6) as ex:
            assert all(c == 200 for c in ex.map(gen, range(6)))
        stats = requests.get(f"{dp_url}/stats", timeout=10).json()
        assert stats["replicas"] == 2
        assert all(c >= 1 for c in stats["per_replica_requests"]), stats

    def test_dp_slots_show_replica(self, dp_url):
        slots = requests.get(f"{dp_url}/slots", timeout=10).json()
        assert len({s["id"] for s in slots}) == len(slots) == 8
        assert {s["replica"] for s in slots} == {0, 1}

    def test_dp_metrics_aggregate(self, dp_url):
        assert "wf_replicas 2" in requests.get(f"{dp_url}/metrics", timeout=10).text

    def test_dp_stop_strings_cancel_on_their_replica(self, dp_url):
        def run(i):
            return requests.post(f"{dp_url}/v1/chat/completions",
                                 json={"model": "m",
                                       "messages": [{"role": "user", "content": f"q{i}"}],
                                       "max_tokens": 16, "temperature": 0.0, "stop": "a"},
                                 timeout=120).status_code

        with cf.ThreadPoolExecutor(6) as ex:
            assert all(c == 200 for c in ex.map(run, range(6)))
        stats = requests.get(f"{dp_url}/stats", timeout=10).json()
        assert stats["active_slots"] == 0 and stats["free_pages"] + stats["cached_pages"] == \
            2 * (TINY_ECFG["num_pages"] - 1)


# -- the port's client, manager and CLI ------------------------------------


def test_async_client(port, client):
    async def run():
        c = AsyncInferenceClient(port.url)
        try:
            ok = await c.health()
            gen = await c.generate("hello", max_tokens=6, temperature=0.0)
            chat = await c.chat(HI, max_tokens=6, temperature=0.0)
            chunks = [x async for x in c.chat_stream(HI, max_tokens=6, temperature=0.0)]
        finally:
            await c.aclose()
        return ok, gen, chat, chunks

    ok, gen, chat, chunks = asyncio.run(run())
    assert ok
    assert gen == client.generate("hello", max_tokens=6, temperature=0.0)
    assert chat == "".join(chunks) == client.chat(HI, max_tokens=6, temperature=0.0)


def test_client_http_error(port, client):
    import urllib.error

    # json_mode with logprobs: the reference's 400
    with pytest.raises(urllib.error.HTTPError) as e:
        client._json("/v1/completions", {"prompt": "x", "logprobs": 2,
                                          "response_format": {"type": "json_object"}})
    assert e.value.code == 400
    assert not InferenceClient(f"http://127.0.0.1:{_free_port()}").health()


def test_server_manager_subprocess():
    """ServerManager starts `python -m wrinklefree_tpu_torch.server --tiny
    --device cpu`, polls /health and stops it."""
    from wrinklefree_tpu_torch.server.manager import ServerManager

    with ServerManager(args=["--tiny", "--device", "cpu"], port=_free_port()) as m:
        assert m.is_alive() and m.health_ok()
        assert InferenceClient(m.url).models() == [NAME]
        proc = m.proc
    assert proc.poll() is not None


def test_cli_generate_and_benchmark(port, capsys):
    from wrinklefree_tpu_torch import cli

    cli.main(["generate", "hello", "--url", port.url, "--max-tokens", "6",
              "--temperature", "0"])
    assert capsys.readouterr().out == InferenceClient(port.url).generate(
        "hello", max_tokens=6, temperature=0.0)
    cli.main(["benchmark", "--url", port.url, "--num-requests", "4", "--max-tokens", "4",
              "--concurrency", "2"])
    res = json.loads(capsys.readouterr().out)
    assert res["num_requests"] == 4 and res["tokens_per_s"] > 0


def test_cli_benchmark_cost_matches_reference(capsys):
    from wrinklefree_tpu import cli as ref_cli
    from wrinklefree_tpu_torch import cli

    outs = []
    for mod in (ref_cli, cli):
        mod.main(["benchmark-cost", "--toks", "1234.5", "--hourly-cost", "2.5"])
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[1] == outs[0]


# -- a loaded model ----------------------------------------------------------


def _start_ref(server):
    """Serve the reference's InferenceServer (aiohttp) on a free port;
    returns (url, stop)."""
    from aiohttp import web

    port = _free_port()
    runner = web.AppRunner(ref_build_app(server))
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    url = f"http://127.0.0.1:{port}"
    _wait_health(url)

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        server.async_engine.shutdown()

    return url, stop


@pytest.fixture(scope="module")
def model_dir(weights, tmp_path_factory):
    """The reference's tiny weights written as an HF BitNet directory
    (``uint8 [out/4, in]`` projections, f32 ``weight_scale``, bf16 norms and
    embedding, config.json) beside a WordLevel tokenizer built with
    ``tokenizers`` (ids inside the tiny vocabulary)."""
    pytest.importorskip("transformers")
    tokenizers = pytest.importorskip("tokenizers")
    from safetensors.numpy import save_file

    from wrinklefree_tpu_torch.ops.ternary import unpack_ternary_np

    d = tmp_path_factory.mktemp("loaded") / "model"
    d.mkdir()
    cfg = RefConfig.tiny()
    (d / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta, "max_position_embeddings": cfg.max_position,
        "tie_word_embeddings": True, "hidden_act": "relu2", "model_type": "bitnet"}))
    lay = weights["layers"]
    t = {"model.embed_tokens.weight": weights["embed"],
         "model.norm.weight": weights["final_norm"]}
    projs = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    norms = {"input_ln": "input_layernorm", "post_ln": "post_attention_layernorm",
             "attn_sub": "self_attn.attn_sub_norm", "ffn_sub": "mlp.ffn_sub_norm"}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        for short, name in projs.items():
            w = unpack_ternary_np(lay[f"{short}_qw"][i]).T  # [out, in]
            planes = (w + 1).astype(np.uint8).reshape(4, w.shape[0] // 4, w.shape[1])
            t[f"{p}.{name}.weight"] = (planes[0] | (planes[1] << 2) | (planes[2] << 4)
                                       | (planes[3] << 6))
            t[f"{p}.{name}.weight_scale"] = np.asarray(
                [np.asarray(lay[f"{short}_scale"]).reshape(cfg.num_layers, -1)[i, 0]],
                np.float32)
        for short, name in norms.items():
            t[f"{p}.{name}.weight"] = lay[short][i]
    save_file(t, str(d / "model.safetensors"))
    words = ("<unk> <s> </s> hello world the quick brown fox jumps over lazy dog "
             "a b c d e f g h i j k . , ! ?").split()
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>",
        "bos_token": "<s>", "eos_token": "</s>", "clean_up_tokenization_spaces": False}))
    return d


@pytest.mark.parametrize("kind", ["directory", "gguf"])
def test_create_server_serves_a_loaded_model(model_dir, tmp_path, kind):
    """create_server on a model directory (its tokenizer beside it) and on a
    .gguf (tokenizer_path given) serves, on the CPU, the completion the
    reference's create_server gives on the same files: equal token ids,
    text and usage."""
    from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
    from wrinklefree_tpu.convert.gguf import convert_hf_to_gguf
    from wrinklefree_tpu_torch.server.http import create_server

    path = str(model_dir)
    kw = {}
    if kind == "gguf":
        path = str(convert_hf_to_gguf(model_dir, tmp_path / "m.gguf", quant_type="i2_s"))
        kw = {"tokenizer_path": str(model_dir)}
    port_srv = create_server(path, engine_config=EngineConfig(**TINY_ECFG), device="cpu", **kw)
    ref_srv = ref_create_server(path, engine_config=RefEngineConfig(use_pallas=False,
                                                                    **TINY_ECFG), **kw)
    assert port_srv.tokenizer.eos_token_id == ref_srv.tokenizer.eos_token_id == 2
    reqs = [_record(port_srv.async_engine.engine), _record(ref_srv.async_engine.engine)]
    st = ServerThread(build_app(port_srv))
    ref_url, ref_stop = _start_ref(ref_srv)
    body = {"prompt": "hello world the quick brown fox", "max_tokens": 8, "temperature": 0}
    try:
        got, want = (requests.post(f"{u}/v1/completions", json=body, timeout=120,
                                   headers={"Connection": "close"})
                     for u in (st.url, ref_url))
    finally:
        st.stop()
        port_srv.async_engine.shutdown()
        ref_stop()
    assert got.status_code == want.status_code == 200
    a, b = reqs[0][-1], reqs[1][-1]
    assert a.prompt_ids == b.prompt_ids and len(a.prompt_ids) == 6
    assert a.output_ids == b.output_ids and len(a.output_ids) == 8
    assert got.json()["choices"][0]["text"] == want.json()["choices"][0]["text"]
    assert got.json()["usage"] == want.json()["usage"]


@pytest.mark.parametrize("argv", [["convert", "{m}", "{o}"], ["convert-gguf", "{m}", "{o}.gguf"],
                                  ["validate-model", "{m}"], ["validate"], ["list-models"]])
def test_cli_tools_not_ported(argv, model_dir, tmp_path, monkeypatch, capsys, request):
    """Every tool of the CLI is ported. ``convert``, ``convert-gguf``,
    ``validate-model`` and ``list-models`` run on a model directory and give
    the reference CLI's files, report and listing; ``validate`` (the KV-cache
    validator) runs against the port's server on the tiny weights, with room
    for its 512-byte prefix probe, and prints the reference's report line
    (PASS or FAIL: the prefix speedup is a timing)."""
    from wrinklefree_tpu import cli as ref_cli
    from wrinklefree_tpu.convert import loader as ref_cloader
    from wrinklefree_tpu_torch import cli
    from wrinklefree_tpu_torch.convert import loader as cloader

    if argv == ["validate"]:
        from wrinklefree_tpu_torch.weights import params_from_numpy

        cfg = BitNetConfig.tiny()
        eng = Engine(params_from_numpy(request.getfixturevalue("weights"), cfg, device="cpu"),
                     cfg, EngineConfig(**{**TINY_ECFG, "num_pages": 512, "max_context": 1024}),
                     eos_token_id=0, device="cpu")
        server = InferenceServer(eng, ByteTokenizer(), NAME)
        st = ServerThread(build_app(server))
        try:
            with pytest.raises(SystemExit) as done:
                cli.main([*argv, "--url", st.url])
        finally:
            st.stop()
            server.async_engine.shutdown()
        out = capsys.readouterr().out
        assert "context-limit graceful: True" in out and "concurrent success: 100%" in out
        assert out.strip().endswith("PASS" if done.value.code == 0 else "FAIL")
        return
    cache = tmp_path / "cache"
    for mod in (cloader, ref_cloader):
        monkeypatch.setattr(mod, "LOCAL_CACHE", cache)
    outs = []
    for tag, mod in (("port", cli), ("ref", ref_cli)):
        args = [a.format(m=model_dir, o=tmp_path / tag) for a in argv]
        try:
            mod.main(args)
            code = 0
        except SystemExit as e:
            code = e.code
        text = capsys.readouterr().out
        outs.append((code, text.replace(str(tmp_path / tag), "OUT")))
    assert outs[0] == outs[1]
    if argv[0] == "convert":
        for f in (tmp_path / "ref").iterdir():
            assert (tmp_path / "port" / f.name).read_bytes() == f.read_bytes(), f.name
    elif argv[0] == "convert-gguf":
        assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "ref.gguf").read_bytes()
    elif argv[0] == "validate-model":
        assert outs[0][0] == 0 and json.loads(outs[0][1])["valid"]
    else:  # list-models over a cache that holds one converted model
        cloader.get_cached_or_convert(str(model_dir), skip_gcs=True)
        cli.main(argv)
        listed = capsys.readouterr().out
        ref_cli.main(argv)
        assert listed == capsys.readouterr().out and listed.count("\n") == 1


@pytest.mark.parametrize("flags", [
    ["--kv-dtype", "int8"], ["--kv-dtype", "fp8_e4m3"], ["--kv-dtype", "fp8_e5m2"],
    ["--kv-dtype", "fp16"], ["--kv-layout", "token"], ["--window", "32", "--global-tokens", "8"],
    ["--kv-dtype", "int8", "--window", "32"], ["--exact-head", "16"],
])
def test_serve_heads_and_kv_flags(flags, monkeypatch):
    """The CLI's ``serve`` passes the KV, window and head flags through the
    server's ``main`` to ``create_server``, and a tiny server on the CPU so
    configured answers a completion: quantized pools (token-major on the
    auto layout, dual under a window), the token layout, a window with a
    global prefix, the exact head."""
    from wrinklefree_tpu_torch import cli
    from wrinklefree_tpu_torch.server import http

    made = []
    real = http.create_server

    def create(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(http, "create_server", create)
    monkeypatch.setattr(http.web, "run_app", lambda app, **kw: None)
    cli.main(["serve", "--tiny", "--device", "cpu", *flags])
    (server,) = made
    eng = server.async_engine.engine
    opts = dict(zip(flags[::2], flags[1::2]))
    ecfg = eng.ecfg
    assert ecfg.kv_dtype == opts.get("--kv-dtype", "bf16")
    assert ecfg.attn_window == int(opts.get("--window", 0))
    assert ecfg.attn_global_tokens == int(opts.get("--global-tokens", 0))
    assert ecfg.exact_head_k == int(opts.get("--exact-head", 0))
    quantized = opts.get("--kv-dtype") in ("int8", "fp8_e4m3", "fp8_e5m2")
    layout = opts.get("--kv-layout") or ("token" if quantized and "--window" not in opts
                                         else "layer")
    assert eng.kv_layout == layout
    st = ServerThread(build_app(server))
    try:
        r = requests.post(f"{st.url}/v1/completions", timeout=120,
                          json={"prompt": "hello world", "max_tokens": 6, "temperature": 0})
    finally:
        st.stop()
        server.async_engine.shutdown()
    assert r.status_code == 200 and r.json()["usage"]["completion_tokens"] >= 1
