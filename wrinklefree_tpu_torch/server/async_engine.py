"""Async bridge over the Engine (PyTorch port of
``wrinklefree_tpu/server/async_engine.py``): a dedicated scheduler thread
per engine replica runs the step loop; asyncio consumers stream tokens via
thread-safe queues. Threads and asyncio only.

Beyond the reference: ``cancel`` and ``between_steps`` (the server's
snapshot and restore) hand their work to the replica's scheduler thread,
which runs it before its next step, under the engine's lock as the
reference's calls do (the event loop never waits on that lock, which a busy
scheduler thread would hold nearly all the time), and a stream whose
consumer goes away (a client that disconnects) cancels its request.

A greedy prompt of ``max_context`` tokens or more runs the ring path
(``Engine.generate``) of the replica that holds the long-context group, on
an executor thread beside the scheduler threads, as the reference runs it.
Beyond the reference: such a prompt goes straight to that replica (the
reference routes it least-loaded first, and a replica without the group
refuses it as too long), and its executor has one thread, so long requests
run one after another (the group's collectives run in one order).
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import logging
import threading
from typing import AsyncIterator, List, Tuple

from ..engine.engine import Engine, Request
from ..engine.sampling_params import SamplingParams

logger = logging.getLogger(__name__)


class AsyncEngine:
    """One scheduler thread per engine replica. With a single Engine this
    is the plain async bridge; with a list (data-parallel serving,
    ``dp > 1``) each replica runs its own step loop and requests are routed
    least-loaded-first."""

    def __init__(self, engine):
        engines = list(engine) if isinstance(engine, (list, tuple)) else [engine]
        if not engines:
            raise ValueError("need at least one engine")
        self.engines = engines
        self.engine = engines[0]  # primary: config/metadata endpoints
        self._rr = 0
        self._pick_lock = threading.Lock()
        self._stop = threading.Event()
        self._owners = {}  # id(request) -> index of the replica serving it
        self._calls = [collections.deque() for _ in engines]  # (fn, future or None)
        # per-replica wake events: an idle scheduler thread parks on its
        # event (50 ms cap) and a submit wakes it at once
        self._wakes = [threading.Event() for _ in engines]
        # the replica that serves the ring path, and its one-thread executor
        self._long = next((e for e in engines if e.has_long_context()), None)
        self._long_pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="wf-long-context")
            if self._long is not None else None)
        self._threads = [
            threading.Thread(target=self._loop, args=(i,), daemon=True, name=f"wf-engine-{i}")
            for i in range(len(engines))
        ]
        for t in self._threads:
            t.start()

    def _loop(self, i: int):
        engine, wake, calls = self.engines[i], self._wakes[i], self._calls[i]
        while not self._stop.is_set():
            while calls:
                fn, fut = calls.popleft()
                try:
                    out = fn()
                except Exception as e:
                    if fut is None:
                        logger.exception("scheduler call failed")
                    else:
                        fut.set_exception(e)
                else:
                    if fut is not None:
                        fut.set_result(out)
            try:
                did = engine.step()
            except Exception:
                logger.exception("engine step failed")
                did = False
            if not did:
                wake.wait(timeout=0.05)
                wake.clear()

    def _wake_for(self, engine: Engine):
        self._wakes[self.engines.index(engine)].set()

    def pick(self) -> Engine:
        """Least-loaded replica (active slots + queue depth), rotating
        among ties for fairness."""
        if len(self.engines) == 1:
            return self.engine
        with self._pick_lock:
            loads = [
                sum(s is not None for s in e.slots) + e.waiting.qsize()
                for e in self.engines
            ]
            m = min(loads)
            ties = [i for i, l in enumerate(loads) if l == m]
            choice = ties[self._rr % len(ties)]
            self._rr += 1
            return self.engines[choice]

    def _call(self, i: int, fn, fut=None):
        self._calls[i].append((fn, fut))
        self._wakes[i].set()

    def between_steps(self, engine: Engine, fn) -> "asyncio.Future":
        """Run ``fn()`` on ``engine``'s scheduler thread before its next step;
        an awaitable of its result (or its exception)."""
        fut = concurrent.futures.Future()
        self._call(self.engines.index(engine), fn, fut)
        return asyncio.wrap_future(fut)

    def cancel(self, req: Request, reason: str = "abort") -> None:
        """Cancel a request: its replica's scheduler thread applies it
        before its next step (a no-op if the request finished by then)."""
        i = self._owners.get(id(req), 0)
        self._call(i, lambda: self.engines[i].cancel(req, reason))

    def shutdown(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        if self._long_pool is not None:
            self._long_pool.shutdown(wait=False, cancel_futures=True)

    async def generate_stream(
        self, prompt_ids: List[int], sampling: SamplingParams
    ) -> AsyncIterator[Tuple[int, bool, Request]]:
        """Yield (token_id, finished, request) as the engine produces them.
        If the consumer stops before the request finished (a disconnect),
        the request is cancelled."""
        loop = asyncio.get_running_loop()
        lc = self._long
        if lc is not None and sampling.temperature == 0 and lc.long_context_route(prompt_ids):
            # a prompt beyond max_context: the sequence-parallel ring path on
            # the executor thread (its tokens arrive together at the end)
            req = await loop.run_in_executor(self._long_pool,
                                             lambda: lc.generate(prompt_ids, sampling))
            for i, tok in enumerate(req.output_ids):
                yield tok, i == len(req.output_ids) - 1, req
            return
        eng = self.pick()
        q: asyncio.Queue = asyncio.Queue()

        def on_token(tok: int, fin: bool):
            loop.call_soon_threadsafe(q.put_nowait, (tok, fin))

        req = eng.submit(prompt_ids, sampling, on_token=on_token)
        self._owners[id(req)] = self.engines.index(eng)
        self._wake_for(eng)
        try:
            while True:
                tok, fin = await q.get()
                yield tok, fin, req
                if fin:
                    break
        finally:
            if not req.finished:
                self.cancel(req, "abort")
            self._owners.pop(id(req), None)

    async def generate(
        self, prompt_ids: List[int], sampling: SamplingParams
    ) -> Request:
        req = None
        async for _, fin, r in self.generate_stream(prompt_ids, sampling):
            req = r
        return req
