"""Replicas of a tensor-parallel engine across processes (``create_server(dp=M,
tp=N)``).

What this reproduces is the reference's ``create_server(dp=M, tp=N)``
(``wrinklefree_tpu/server/http.py``): M tensor-parallel engines, replica r on
the devices ``[r*N, (r+1)*N)``, only replica 0 with the long-context mesh,
behind ``AsyncEngine``'s least-loaded pick. The reference has no counterpart
of this module: its one controller drives every replica. Here a
tensor-parallel engine is one process per rank, so the M replicas are the M
model groups of ``make_mesh(M, N)``: replica d is model group d, led by
global rank d*N.

- Global rank 0, replica 0's leader, serves HTTP. Its ``AsyncEngine`` holds
  its own engine and, for each other replica, a ``RemoteReplica``: a proxy
  with the part of ``Engine``'s surface that ``AsyncEngine`` and
  ``InferenceServer`` read (``submit`` with ``on_token``, ``cancel``, the
  load that ``pick`` reads, ``stats``, ``latency_summary``, the slot view,
  ``snapshot``, ``restore``, ``reset_prefix_cache``, ``warmup``,
  ``has_long_context``, ``token_pieces``).
- The leader of each other replica runs a ``ReplicaServer``: an
  ``AsyncEngine`` of its one engine (a scheduler thread that drives the
  replica's followers through the lockstep, as on replica 0) and the far end
  of the channel, until rank 0 shuts it down.

The channel is one TCP stream from rank 0 to each replica leader: on the
loopback interface when both are on one host, else on the leader host's
address. Its address goes through the process group once
(``all_gather_object``), with a random token of rank 0's that the replica
checks before it reads a message, so that no other process that reaches
the port can speak for rank 0. A stream is full-duplex, ordered and can be read
by a thread that waits for whichever message comes next, so the replica's
scheduler thread sends each token as its step emits it while rank 0's calls
and cancels arrive at any time. Messages are length-prefixed pickles: rank
0 sends ``("call", id, op, args)``, ``("cancel", request id, reason)``,
``("pieces", token pieces)`` and ``("shutdown",)``; the replica answers
``("reply", id, ok, value)``, streams ``("token", request id, token,
finished, new logprobs entries, finish reason)`` and ends with
``("bye",)`` once its scheduler and followers have stopped.
"""

from __future__ import annotations

import concurrent.futures
import hmac
import itertools
import logging
import pickle
import secrets
import socket
import struct
import threading
import time
import types
from typing import List, Optional

import torch.distributed as dist

from ..engine.engine import Request
from ..engine.sampling_params import SamplingParams

logger = logging.getLogger(__name__)

_HEADER = struct.Struct("!Q")
_TOKEN_BYTES = 32


def send_msg(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HEADER.pack(len(data)) + data)


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket):
    """The next message, or None once the other end has closed."""
    head = _read_exact(sock, _HEADER.size)
    if head is None:
        return None
    data = _read_exact(sock, _HEADER.unpack(head)[0])
    return None if data is None else pickle.loads(data)


def replica_channels(mesh, engine):
    """Every rank of a ``make_mesh(M, N)`` world calls this after building
    its engine, in one order (it is collective). The leader of each replica
    d > 0 opens a listening socket; global rank 0 connects to each and
    sends its token first. Returns (on a replica leader d > 0 its
    ``ReplicaServer``, else None; on global rank 0 the ``RemoteReplica`` of
    replicas 1..M-1, else [])."""
    group = dist.new_group(backend="gloo")
    world, rank = dist.get_world_size(), dist.get_rank()
    hosts = [None] * world
    token = secrets.token_bytes(_TOKEN_BYTES) if rank == 0 else None
    dist.all_gather_object(hosts, (socket.gethostname(), token), group=group)
    hosts, token = [h for h, _ in hosts], hosts[0][1]
    listener, addr = None, None
    if mesh.model.index == 0 and mesh.data.index > 0:
        ip = ("127.0.0.1" if hosts[rank] == hosts[0]
              else socket.gethostbyname(socket.gethostname()))
        listener = socket.create_server((ip, 0))
        addr = (ip, listener.getsockname()[1])
    addrs = [None] * world
    dist.all_gather_object(addrs, addr, group=group)
    proxies = []
    if rank == 0:
        n_model = mesh.shape["model"]
        for d in range(1, mesh.shape["data"]):
            sock = socket.create_connection(addrs[d * n_model])
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(token)
            proxies.append(RemoteReplica(sock, d, engine))
    return (ReplicaServer(engine, listener, token) if listener is not None else None), proxies


class RemoteReplica:
    """Rank 0's proxy of replica ``index``, led by another process: the
    ``Engine`` surface that ``AsyncEngine`` and ``InferenceServer`` read.
    Reads (``slots``, ``waiting``, ``stats``, ...) ask the replica, which
    answers from its engine's live state; ``submit`` returns this process's
    ``Request``, which the replica's token events fill in (tokens, logprobs,
    finish reason) before its ``on_token`` sees each one. ``local`` is rank
    0's engine, whose configuration every replica shares."""

    mesh = None  # the replica's mesh lives in its own processes

    def __init__(self, sock: socket.socket, index: int, local):
        self.index = index
        self.cfg, self.ecfg, self.eos_token_id = local.cfg, local.ecfg, local.eos_token_id
        self._sock = sock
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._calls = {}  # call id -> Future
        self._reqs = {}  # request id -> unfinished Request
        self._pieces = None
        self._closed = threading.Event()
        threading.Thread(target=self._read, daemon=True, name=f"wf-replica-{index}").start()

    # -- the channel ---------------------------------------------------------

    def _send(self, msg) -> None:
        with self._send_lock:
            send_msg(self._sock, msg)

    def _call(self, op: str, *args):
        if self._closed.is_set():
            raise ConnectionError(f"replica {self.index} has shut down")
        fut = concurrent.futures.Future()
        cid = next(self._ids)
        with self._lock:
            self._calls[cid] = fut
        self._send(("call", cid, op, args))
        return fut.result()

    def _read(self):
        try:
            while True:
                msg = recv_msg(self._sock)
                if msg is None or msg[0] == "bye":
                    break
                if msg[0] == "token":
                    self._on_token(*msg[1:])
                else:  # ("reply", id, ok, value)
                    _, cid, ok, value = msg
                    with self._lock:
                        fut = self._calls.pop(cid)
                    if ok:
                        fut.set_result(value)
                    else:
                        fut.set_exception(value)
        except OSError as e:
            logger.warning("replica %d: channel closed (%s)", self.index, e)
        finally:
            self._closed.set()
            with self._lock:
                calls, self._calls = self._calls, {}
                reqs, self._reqs = self._reqs, {}
            for fut in calls.values():
                fut.set_exception(ConnectionError(f"replica {self.index} has shut down"))
            for req in reqs.values():  # their streams end
                req.finished, req.finish_reason = True, "abort"
                self._notify(req, -1, True)

    def _on_token(self, rid, tok, fin, logprobs, reason):
        with self._lock:
            req = self._reqs.pop(rid, None) if fin else self._reqs.get(rid)
        if req is None:
            return
        if tok >= 0:
            if req.first_token_t is None:
                req.first_token_t = time.monotonic()
            req.output_ids.append(tok)
        req.logprobs_seq.extend(logprobs)
        if fin:
            req.finished, req.finish_reason, req.finish_t = True, reason, time.monotonic()
        self._notify(req, tok, fin)

    def _notify(self, req: Request, tok: int, fin: bool) -> None:
        """``req``'s callback; its failure (a consumer gone) leaves the
        channel's reader running."""
        if req.on_token is not None:
            try:
                req.on_token(tok, fin)
            except Exception:
                logger.exception("replica %d: request %d's on_token failed", self.index,
                                 req.rid)

    # -- the Engine surface --------------------------------------------------

    def submit(self, prompt_ids: List[int], sampling: SamplingParams | None = None,
               on_token=None) -> Request:
        """Queue a request on the replica; raises what its ``submit`` raises."""
        sampling = sampling or SamplingParams()
        req = Request(next(self._ids), list(prompt_ids), sampling, on_token)
        with self._lock:  # before the replica can emit its first token
            self._reqs[req.rid] = req
        try:
            self._call("submit", req.rid, req.prompt_ids, sampling)
        except BaseException:
            with self._lock:
                self._reqs.pop(req.rid, None)
            raise
        return req

    def cancel(self, req: Request, reason: str = "abort") -> bool:
        if req.finished or self._closed.is_set():
            return False
        self._send(("cancel", req.rid, reason))
        return True

    def step(self) -> bool:
        return False  # the replica steps itself

    def has_long_context(self) -> bool:
        return False  # only replica 0 holds the group

    def state(self) -> dict:
        """The replica's live state: ``slots`` (``Engine.slot_states``),
        ``queued``, ``stats``, ``free_pages``, ``cached_pages`` (None without
        a radix cache), ``latency``."""
        return self._call("state")

    def slot_states(self):
        return self.state()["slots"]

    @property
    def slots(self):
        return self.state()["slots"]

    @property
    def waiting(self):
        return types.SimpleNamespace(qsize=lambda: self.state()["queued"])

    @property
    def stats(self) -> dict:
        return self.state()["stats"]

    @property
    def allocator(self):
        return types.SimpleNamespace(num_free=self.state()["free_pages"])

    @property
    def radix(self):
        cached = self.state()["cached_pages"]
        return None if cached is None else types.SimpleNamespace(num_cached_pages=cached)

    def latency_summary(self) -> dict:
        return self.state()["latency"]

    def snapshot(self) -> dict:
        return self._call("snapshot")

    def restore(self, snap: dict, on_token_factory=None) -> list:
        """The replica restores the snapshot's requests between two steps;
        returns their ids there (their tokens are not streamed here, as a
        local restore's are not)."""
        return self._call("restore", snap)

    def reset_prefix_cache(self) -> int:
        return self._call("reset_prefix_cache")

    def warmup(self) -> dict:
        return self._call("warmup")

    @property
    def token_pieces(self):
        return self._pieces

    @token_pieces.setter
    def token_pieces(self, pieces):
        self._pieces = pieces
        self._send(("pieces", pieces))

    def stop_followers(self) -> None:
        """Shut the replica down: its scheduler thread, then its followers;
        returns once it has said so (no-op once closed)."""
        if self._closed.is_set():
            return
        self._send(("shutdown",))
        self._closed.wait()
        self._sock.close()


class _Stream:
    """A request of rank 0's on this replica: its ``on_token`` sends each
    token to rank 0 with the logprobs entries and finish reason that go
    with it."""

    def __init__(self, rid, send, done):
        self.rid, self._send, self._done = rid, send, done
        self.req = None
        self._bound = threading.Event()
        self._sent_lp = 0

    def bind(self, req: Request) -> None:
        self.req = req
        self._bound.set()

    def on_token(self, tok: int, fin: bool) -> None:
        self._bound.wait()  # the step may emit before submit has returned
        req = self.req
        lps = req.logprobs_seq[self._sent_lp:]
        self._sent_lp += len(lps)
        if fin:
            self._done(self.rid)
        self._send(("token", self.rid, tok, fin, lps, req.finish_reason if fin else None))


class ReplicaServer:
    """The leader of a replica other than 0 (``create_server(dp > 1, tp >
    1)``): ``serve()`` runs its engine's scheduler loop and answers rank 0's
    proxy until rank 0 shuts it down (or goes away), then stops its
    followers and returns."""

    def __init__(self, engine, listener: socket.socket, token: bytes):
        self.engine = engine
        self._listener = listener
        self._token = token

    def _accept(self) -> socket.socket:
        """Rank 0's connection: the first that sends its token (any other is
        closed unread)."""
        while True:
            conn, _ = self._listener.accept()
            conn.settimeout(60)
            try:
                got = _read_exact(conn, _TOKEN_BYTES)
            except OSError:
                got = None
            if got is not None and hmac.compare_digest(got, self._token):
                conn.settimeout(None)
                self._listener.close()
                return conn
            logger.warning("replica: a connection without rank 0's token, closed")
            conn.close()

    def serve(self) -> None:
        from ..server.async_engine import AsyncEngine

        conn = self._accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        lock = threading.Lock()

        def send(msg):
            with lock:
                send_msg(conn, msg)

        ae = AsyncEngine(self.engine)
        streams = {}
        try:
            while True:
                msg = recv_msg(conn)
                if msg is None or msg[0] == "shutdown":
                    break
                try:
                    self._handle(msg, ae, streams, send)
                except OSError:
                    raise
                except Exception:  # a malformed message: logged, the replica goes on
                    logger.exception("replica: message %r failed", msg[0])
        finally:
            ae.shutdown()  # its scheduler thread, then its followers
            try:
                send(("bye",))
            except OSError:
                pass
            conn.close()

    def _handle(self, msg, ae, streams, send):
        eng = self.engine
        kind = msg[0]
        if kind == "cancel":
            s = streams.get(msg[1])
            if s is not None and s.req is not None:
                ae.cancel(s.req, msg[2])
            return
        if kind == "pieces":
            eng.token_pieces = msg[1]
            return
        _, cid, op, args = msg

        def reply_with(fut):
            err = fut.exception()
            send(("reply", cid, err is None, err if err is not None else fut.result()))

        if op in ("snapshot", "restore", "warmup"):  # between two steps
            fn = {"snapshot": eng.snapshot, "warmup": eng.warmup,
                  "restore": lambda: [r.rid for r in eng.restore(args[0])]}[op]
            ae.call_between_steps(eng, fn).add_done_callback(reply_with)
            return
        try:
            if op == "submit":
                rid, prompt_ids, sampling = args
                s = _Stream(rid, send, lambda r: streams.pop(r, None))
                streams[rid] = s
                try:
                    s.bind(eng.submit(prompt_ids, sampling, on_token=s.on_token))
                except BaseException:
                    streams.pop(rid, None)
                    raise
                ae.wake(eng)
                value = None
            elif op == "state":
                value = dict(slots=eng.slot_states(), queued=eng.waiting.qsize(),
                             stats=dict(eng.stats), free_pages=eng.allocator.num_free,
                             cached_pages=(eng.radix.num_cached_pages if eng.radix is not None
                                           else None),
                             latency=eng.latency_summary())
            elif op == "reset_prefix_cache":
                value = eng.reset_prefix_cache()
            else:
                raise ValueError(f"unknown replica call {op!r}")
        except Exception as e:
            send(("reply", cid, False, e))
        else:
            send(("reply", cid, True, value))
