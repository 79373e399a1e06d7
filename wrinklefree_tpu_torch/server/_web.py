"""A small HTTP/1.1 server on asyncio streams (standard library only).

It gives the few aiohttp names the server's handlers use, so they port
nearly line for line from ``wrinklefree_tpu/server/http.py``:
``Application`` with ``get``/``post`` routes, ``Request.json()``,
``Response``, ``json_response``, ``StreamResponse.prepare/write/write_eof``
(chunked transfer encoding, for SSE) and ``run_app``. ``ServerThread``
serves an application on its own event loop in a thread (tests, smoke
drives). Connections are kept alive between requests; request bodies come
with a Content-Length or chunked.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from http import HTTPStatus
from typing import Awaitable, Callable, Dict, Optional, Tuple
from urllib.parse import urlsplit

logger = logging.getLogger(__name__)

MAX_BODY = 64 << 20


class _BodyTooLarge(Exception):
    pass


class Request:
    def __init__(self, method: str, path: str, headers: Dict[str, str], body: bytes,
                 writer: asyncio.StreamWriter):
        self.method = method
        self.path = path
        self.headers = headers  # lower-case names
        self.body = body
        self._writer = writer
        self.started = False  # a StreamResponse has sent its head

    async def json(self):
        """The body as JSON; raises ``json.JSONDecodeError`` if it is not."""
        return json.loads(self.body.decode("utf-8"))


def _head(status: int, headers: Dict[str, str]) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    lines = [f"HTTP/1.1 {status} {reason}"] + [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Response:
    def __init__(self, *, body: bytes = b"", text: Optional[str] = None, status: int = 200,
                 content_type: str = "application/octet-stream"):
        if text is not None:
            body = text.encode("utf-8")
            content_type += "; charset=utf-8"
        self.body = body
        self.status = status
        self.content_type = content_type

    def encode(self) -> bytes:
        h = {"Content-Type": self.content_type, "Content-Length": str(len(self.body))}
        return _head(self.status, h) + self.body


def json_response(data, *, status: int = 200) -> Response:
    return Response(text=json.dumps(data), status=status, content_type="application/json")


class StreamResponse:
    """A response written as it is produced (chunked transfer encoding).
    ``write`` waits until the bytes are handed to the socket, so a client
    that went away raises ``ConnectionError`` at the next write."""

    def __init__(self, *, headers: Dict[str, str]):
        self.headers = headers
        self._writer: Optional[asyncio.StreamWriter] = None
        self.finished = False

    async def prepare(self, request: Request) -> None:
        self._writer = request._writer
        request.started = True
        h = {**self.headers, "Transfer-Encoding": "chunked"}
        self._writer.write(_head(200, h))
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if not data:
            return
        self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        await self._writer.drain()

    async def write_eof(self) -> None:
        self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()
        self.finished = True


Handler = Callable[[Request], Awaitable[object]]


class Application:
    def __init__(self):
        self.routes: Dict[Tuple[str, str], Handler] = {}

    def add_routes(self, routes) -> None:
        for method, path, handler in routes:
            self.routes[(method, path)] = handler

    async def _dispatch(self, request: Request):
        handler = self.routes.get((request.method, request.path))
        if handler is None:
            if any(p == request.path for _, p in self.routes):
                return Response(text="405: Method Not Allowed", status=405,
                                content_type="text/plain")
            return Response(text="404: Not Found", status=404, content_type="text/plain")
        return await handler(request)

    async def handle_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    method, target, version = line.decode("latin-1").split()
                except ValueError:
                    writer.write(Response(text="400: Bad Request", status=400,
                                          content_type="text/plain").encode())
                    break
                headers: Dict[str, str] = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                try:
                    body = await _read_body(reader, headers)
                except (_BodyTooLarge, ValueError) as e:
                    big = isinstance(e, _BodyTooLarge)
                    writer.write(Response(
                        text="413: Request Entity Too Large" if big else "400: Bad Request",
                        status=413 if big else 400, content_type="text/plain").encode())
                    await writer.drain()
                    break
                path = urlsplit(target).path
                request = Request(method.upper(), path, headers, body, writer)
                try:
                    resp = await self._dispatch(request)
                except (ConnectionError, asyncio.IncompleteReadError):
                    raise
                except Exception:
                    logger.exception("handler for %s %s failed", method, path)
                    if request.started:  # mid-stream: the connection is all we can end
                        break
                    resp = Response(text="500: Internal Server Error", status=500,
                                    content_type="text/plain")
                if isinstance(resp, StreamResponse):
                    if not resp.finished:  # a stream cut short: end the connection
                        break
                else:
                    writer.write(resp.encode())
                    await writer.drain()
                if (headers.get("connection", "").lower() == "close"
                        or version.upper() == "HTTP/1.0"):
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()


async def _read_body(reader: asyncio.StreamReader, headers: Dict[str, str]) -> bytes:
    """The request body, at most ``MAX_BODY`` bytes (``_BodyTooLarge`` past
    it, ``ValueError`` for a malformed length)."""
    if headers.get("transfer-encoding", "").lower() == "chunked":
        parts, total = [], 0
        while True:
            size = int((await reader.readline()).split(b";")[0].strip() or b"0", 16)
            if size == 0:
                await reader.readline()  # the empty trailer line
                return b"".join(parts)
            total += size
            if total > MAX_BODY:
                raise _BodyTooLarge
            parts.append(await reader.readexactly(size))
            await reader.readline()
    n = int(headers.get("content-length", 0) or 0)
    if n > MAX_BODY:
        raise _BodyTooLarge
    return await reader.readexactly(n) if n else b""


def get(path: str, handler: Handler):
    return ("GET", path, handler)


def post(path: str, handler: Handler):
    return ("POST", path, handler)


async def _serve(app: Application, host: str, port: int) -> None:
    server = await asyncio.start_server(app.handle_connection, host, port)
    logger.info("serving on http://%s:%d", host, port)
    async with server:
        await server.serve_forever()


def run_app(app: Application, *, host: str = "127.0.0.1", port: int = 30000) -> None:
    """Serve until interrupted."""
    try:
        asyncio.run(_serve(app, host, port))
    except KeyboardInterrupt:
        pass


class ServerThread:
    """Serve ``app`` on its own event loop in a daemon thread. ``port=0``
    takes a free port; ``url`` is set once the socket listens."""

    def __init__(self, app: Application, host: str = "127.0.0.1", port: int = 0):
        self.loop = asyncio.new_event_loop()
        ready = threading.Event()
        self._server = None

        def run():
            asyncio.set_event_loop(self.loop)
            self._server = self.loop.run_until_complete(
                asyncio.start_server(app.handle_connection, host, port))
            ready.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True, name="wf-http")
        self.thread.start()
        if not ready.wait(30):
            raise RuntimeError("the HTTP server did not start")
        self.port = self._server.sockets[0].getsockname()[1]
        self.url = f"http://{host}:{self.port}"

    def stop(self) -> None:
        def close():
            self._server.close()
            self.loop.stop()

        self.loop.call_soon_threadsafe(close)
        self.thread.join(timeout=10)
