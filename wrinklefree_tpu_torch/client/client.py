"""HTTP clients for the inference server (sync + async), standard library only.

The port of ``wrinklefree_tpu/client/client.py`` on ``urllib`` (no
requests, no httpx): health, models, tokenize, detokenize, stats,
embeddings, generate (llama.cpp /completion) and chat (OpenAI), with SSE
streaming variants. An error status raises ``urllib.error.HTTPError``, as
the reference's ``raise_for_status``. ``AsyncInferenceClient`` runs the
same calls on a worker thread.
"""

from __future__ import annotations

import asyncio
import json
import urllib.request
from typing import AsyncIterator, Dict, Iterator, List


def _sse_data(resp) -> Iterator[bytes]:
    """The payloads of an SSE response's `data: ` lines."""
    for line in resp:
        line = line.rstrip(b"\r\n")
        if line.startswith(b"data: "):
            yield line[6:]


class InferenceClient:
    def __init__(self, base_url: str = "http://127.0.0.1:30000", timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _open(self, path: str, body=None, timeout=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            f"{self.base_url}{path}", data=data,
            headers={"Content-Type": "application/json"} if data is not None else {},
            method="GET" if data is None else "POST")
        return urllib.request.urlopen(req, timeout=timeout or self.timeout)

    def _json(self, path: str, body=None):
        with self._open(path, body) as r:
            return json.loads(r.read())

    # -- basics ----------------------------------------------------------

    def health(self) -> bool:
        try:
            with self._open("/health", timeout=5) as r:
                return r.status == 200
        except OSError:
            return False

    def models(self) -> List[str]:
        return [m["id"] for m in self._json("/v1/models")["data"]]

    def tokenize(self, text: str) -> List[int]:
        return self._json("/tokenize", {"content": text})["tokens"]

    def detokenize(self, tokens: List[int]) -> str:
        return self._json("/detokenize", {"tokens": tokens})["content"]

    def stats(self) -> Dict:
        return self._json("/stats")

    def embed(self, text: str) -> List[float]:
        """llama.cpp `/embedding` (single input)."""
        return self._json("/embedding", {"content": text})["embedding"]

    def embeddings(self, inputs: "str | List[str]", model: str = "") -> List[List[float]]:
        """OpenAI `/v1/embeddings` (batch)."""
        out = self._json("/v1/embeddings", {"model": model, "input": inputs})
        return [d["embedding"] for d in out["data"]]

    # -- generation --------------------------------------------------------

    def generate(self, prompt: str, max_tokens: int = 128, temperature: float = 0.7,
                 top_p: float = 0.9, **kw) -> str:
        return self._json("/completion", {
            "prompt": prompt, "n_predict": max_tokens, "temperature": temperature,
            "top_p": top_p, **kw})["content"]

    def generate_stream(self, prompt: str, max_tokens: int = 128, temperature: float = 0.7,
                        **kw) -> Iterator[str]:
        with self._open("/completion", {"prompt": prompt, "n_predict": max_tokens,
                                        "temperature": temperature, "stream": True,
                                        **kw}) as r:
            for data in _sse_data(r):
                payload = json.loads(data)
                if payload.get("content"):
                    yield payload["content"]
                if payload.get("stop"):
                    break

    def chat(self, messages: List[Dict[str, str]], max_tokens: int = 256,
             temperature: float = 0.7, model: str = "default", **kw) -> str:
        out = self._json("/v1/chat/completions", {
            "model": model, "messages": messages, "max_tokens": max_tokens,
            "temperature": temperature, **kw})
        return out["choices"][0]["message"]["content"]

    def chat_stream(self, messages: List[Dict[str, str]], max_tokens: int = 256,
                    temperature: float = 0.7, model: str = "default", **kw) -> Iterator[str]:
        with self._open("/v1/chat/completions", {
                "model": model, "messages": messages, "max_tokens": max_tokens,
                "temperature": temperature, "stream": True, **kw}) as r:
            for data in _sse_data(r):
                if data == b"[DONE]":
                    break
                delta = json.loads(data)["choices"][0]["delta"]
                if delta.get("content"):
                    yield delta["content"]


class AsyncInferenceClient:
    """The reference AsyncInferenceClient's methods, each running the sync
    client's call on a worker thread."""

    def __init__(self, base_url: str = "http://127.0.0.1:30000", timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self._sync = InferenceClient(base_url, timeout)

    async def aclose(self):
        pass  # no pooled connections

    async def health(self) -> bool:
        return await asyncio.to_thread(self._sync.health)

    async def generate(self, prompt: str, max_tokens: int = 128, **kw) -> str:
        return await asyncio.to_thread(self._sync.generate, prompt, max_tokens, **kw)

    async def chat(self, messages, max_tokens: int = 256, **kw) -> str:
        return await asyncio.to_thread(self._sync.chat, messages, max_tokens, **kw)

    async def chat_stream(self, messages, max_tokens: int = 256, **kw) -> AsyncIterator[str]:
        it = self._sync.chat_stream(messages, max_tokens, **kw)
        done = object()
        while True:
            chunk = await asyncio.to_thread(next, it, done)
            if chunk is done:
                return
            yield chunk
