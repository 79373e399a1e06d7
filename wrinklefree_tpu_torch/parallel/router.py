"""Data-parallel serving: a request router over engine replicas (PyTorch port).

Counterpart of ``wrinklefree_tpu/parallel/router.py``: one engine per model
replica (each replica itself tensor-parallel or not), requests spread across
them cache-aware and least-loaded first, behind the same submit/generate
surface as one ``Engine``. The replicas are engines of this process (a
tensor-parallel replica through its leader rank).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

from ..engine.engine import Engine, Request
from ..engine.sampling_params import SamplingParams


class ReplicaRouter:
    """Cache-aware least-loaded router over Engine replicas, as the
    reference's (SGLang's cache-aware load balancer):

    1. probe every replica's radix cache for the prompt's cached-prefix length
       (``Engine.prefix_match_len``: read-only, page-granular);
    2. if the best match is at least one KV page and that replica's load is
       within ``load_slack`` of the least-loaded one, route there;
    3. otherwise the least loaded, rotating among ties.

    ``cache_aware=False`` routes least-loaded only."""

    def __init__(self, engines: Sequence[Engine], *, cache_aware: bool = True,
                 load_slack: Optional[int] = None):
        if not engines:
            raise ValueError("need at least one engine replica")
        self.engines: List[Engine] = list(engines)
        self._rr = 0
        self._lock = threading.Lock()
        self.cache_aware = cache_aware
        # the queue depth a cache hit is worth; default half a batch of slots
        self.load_slack = (max(2, engines[0].ecfg.max_batch_slots // 2)
                           if load_slack is None else load_slack)

    def _load(self, e: Engine) -> int:
        return sum(s is not None for s in e.slots) + e.waiting.qsize()

    def pick(self, prompt_ids=None) -> Engine:
        with self._lock:
            loads = [self._load(e) for e in self.engines]
            m = min(loads)
            if self.cache_aware and prompt_ids is not None and len(self.engines) > 1:
                matches = [e.prefix_match_len(prompt_ids) for e in self.engines]
                best = max(range(len(matches)), key=lambda i: (matches[i], -loads[i]))
                page = self.engines[best].page_size
                if matches[best] >= page and loads[best] <= m + self.load_slack:
                    return self.engines[best]
            candidates = [i for i, l in enumerate(loads) if l == m]
            choice = candidates[self._rr % len(candidates)]
            self._rr += 1
            return self.engines[choice]

    def submit(self, prompt_ids, sampling: Optional[SamplingParams] = None,
               on_token=None) -> Request:
        return self.pick(prompt_ids).submit(prompt_ids, sampling, on_token)

    def generate(self, prompt_ids, sampling: Optional[SamplingParams] = None) -> Request:
        return self.pick(prompt_ids).generate(prompt_ids, sampling)

    def step_all(self) -> bool:
        """Drive every replica one scheduling step; True if any had work."""
        did = False
        for e in self.engines:
            did = e.step() or did
        return did

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    @property
    def stats(self) -> dict:
        agg: dict = {}
        for e in self.engines:
            for k, v in e.stats.items():
                agg[k] = agg.get(k, 0) + v
        agg["replicas"] = len(self.engines)
        return agg
