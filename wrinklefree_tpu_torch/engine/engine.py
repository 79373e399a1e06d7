"""Continuous-batching inference engine (PyTorch port).

Counterpart of ``wrinklefree_tpu/engine/engine.py``, with the same host
scheduler: fixed ``max_batch_slots`` decode slots; queued requests admitted
into free slots (fifo or sjf); chunked prefill at bucketed lengths, one
batched round per step (stagger / bucket / all), interleaved with decode; a
radix prefix cache over full KV pages with eager publish and in-queue
re-match; K-step decode bursts with one host read each; page 0 as trash.

The device half is ``paged_forward`` over the dual KV layout with the fused
kernels (``ops/ternary_cuda.py``, ``ops/kv_update_cuda.py``,
``ops/flash_attention.py``); on the CPU the same calls run their plain
versions. Features outside this slice raise ``NotImplementedError`` at
construction or at ``submit``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import BitNetConfig, EngineConfig
from ..kv.paged import PagedKV
from ..models.bitnet import fuse_projections, resolve_device
from ..ops.ternary_cuda import make_linear_fused
from .page_allocator import PageAllocator
from .programs import build_decode, prefill_for_bucket
from .radix_cache import RadixCache
from .sampling_params import SamplingParams

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    rid: int
    prompt_ids: List[int]
    sampling: SamplingParams
    on_token: Optional[Callable[[int, bool], None]] = None  # (token, finished)
    # runtime state
    output_ids: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)  # owned pages
    matched_nodes: list = dataclasses.field(default_factory=list)
    matched_pages: List[int] = dataclasses.field(default_factory=list)
    matched_tokens: int = 0
    seq_len: int = 0
    pending: List[int] = dataclasses.field(default_factory=list)  # prompt not yet prefilled
    seed: int = 0  # per-request sampling stream (sampling.seed or derived from rid)
    generator: Optional[torch.Generator] = None  # created at admission when sampling
    finished: bool = False
    finish_reason: str = ""
    arrival_t: float = dataclasses.field(default_factory=time.monotonic)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None


def _unsupported_config(cfg: BitNetConfig, e: EngineConfig) -> List[str]:
    out = []
    if cfg.num_experts > 0:
        out.append("num_experts > 0 (MoE)")
    if e.kv_dtype not in ("bf16", "f32"):
        out.append(f"kv_dtype {e.kv_dtype!r} (quantized KV)")
    if e.attn_window > 0:
        out.append("attn_window > 0 (sliding-window attention)")
    if e.exact_head_k > 0:
        out.append("exact_head_k > 0 (exact int8-scan head)")
    if e.int8_logits:
        out.append("int8_logits")
    if e.speculative_k > 0:
        out.append("speculative_k > 0 (speculative decoding)")
    if e.use_native_runtime:
        out.append("use_native_runtime (the C++ host runtime is not bound yet)")
    return out


class Engine:
    def __init__(
        self,
        params,
        cfg: BitNetConfig,
        ecfg: EngineConfig | None = None,
        *,
        eos_token_id: Optional[int] = None,
        linear_fn=None,
        attention_fn=None,
        mesh=None,
        long_context_mesh=None,
        device=None,
    ):
        """``params`` are the model's params (unfused: the engine fuses the
        projections, as the reference does on its kernel path) on
        ``device`` (default CUDA; raises without CUDA unless the caller asks
        for ``device='cpu'``). ``linear_fn``/``attention_fn`` override the
        kernels as in ``paged_forward``."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = e = ecfg or EngineConfig()
        missing = _unsupported_config(cfg, e)
        if mesh is not None:
            missing.append("mesh (tensor parallelism)")
        if long_context_mesh is not None:
            missing.append("long_context_mesh (ring-attention long context)")
        if missing:
            raise NotImplementedError(
                "not ported to the PyTorch engine yet: " + ", ".join(missing))
        if "qkv_qw" not in params["layers"]:
            params = fuse_projections(params, cfg)
        self.params = params
        self.eos_token_id = eos_token_id
        self._linear_fn = linear_fn or make_linear_fused()
        self._attention_fn = attention_fn

        self.page_size = ps = e.page_size
        # power-of-two table width (as the reference, whose flash tiling
        # needed 128-multiple histories; kept so page-table shapes agree)
        need = -(-e.max_context // ps)
        self.max_pages_per_seq = 8
        while self.max_pages_per_seq < need:
            self.max_pages_per_seq *= 2
        # dual layout: prefill chunks start page-aligned, so buckets are
        # multiples of page_size
        self.ecfg = e = dataclasses.replace(
            e, prefill_buckets=tuple(sorted({-(-b // ps) * ps for b in e.prefill_buckets})))
        self.pools = PagedKV.zeros_dual(
            cfg, e.num_pages, ps, e.max_batch_slots, e.kv_dtype, device=self.device)
        self.allocator = PageAllocator(e.num_pages)
        self.radix = RadixCache(self.allocator, ps) if e.enable_radix_cache else None

        S = e.max_batch_slots
        self.page_table = np.zeros((S, self.max_pages_per_seq), np.int32)
        self.seq_lens = np.zeros((S,), np.int32)
        self.slots: List[Optional[Request]] = [None] * S
        self.last_tokens = np.zeros((S,), np.int32)
        self.slot_temps = np.zeros((S,), np.float32)
        self.slot_tps = np.ones((S,), np.float32)
        self.slot_topks = np.zeros((S,), np.int32)
        self.slot_minps = np.zeros((S,), np.float32)
        self.slot_typps = np.ones((S,), np.float32)
        self.slot_tfs = np.ones((S,), np.float32)
        # penalty state: identity defaults + last-W token ring per slot
        self.slot_reps = np.ones((S,), np.float32)
        self.slot_pres = np.zeros((S,), np.float32)
        self.slot_freqs = np.zeros((S,), np.float32)
        self.slot_lastn = np.zeros((S,), np.int32)
        Kb = e.logit_bias_slots
        self.slot_bias_ids = np.full((S, Kb), -1, np.int32)
        self.slot_bias_vals = np.zeros((S, Kb), np.float32)
        # device copies of the scheduling state, uploaded after scheduling
        # events; the page table is sliced to the active-history bucket
        self._dstate = None
        self._mp_bucket = 0
        self._dirty = True

        self.waiting: "queue.Queue[Request]" = queue.Queue(maxsize=e.max_queue)
        self._backlog: List[Request] = []  # drained from `waiting`, policy-ordered
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self._decode_fns: Dict[int, Callable] = {}
        self._prefill_fns: Dict[int, Callable] = {}

        self.stats = {"decode_steps": 0, "decode_tokens": 0, "prefill_tokens": 0,
                      "radix_hit_tokens": 0, "requests": 0}
        # rolling (ttft_s, e2e_s, n_tokens) of the last 512 finished requests
        self.latency_log = collections.deque(maxlen=512)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def _validate_submit(self, prompt_ids, sampling: SamplingParams):
        limit = self.ecfg.max_context
        if len(prompt_ids) >= limit:
            raise ValueError(f"prompt too long: {len(prompt_ids)} >= max_context {limit}")
        if sampling.logit_bias and len(sampling.logit_bias) > self.ecfg.logit_bias_slots:
            raise ValueError(
                f"logit_bias has {len(sampling.logit_bias)} entries; engine supports "
                f"{self.ecfg.logit_bias_slots} (EngineConfig.logit_bias_slots)")
        missing = []
        if sampling.constrained:
            missing.append("json_mode/grammar (constrained decoding)")
        if sampling.logprobs_k > 0:
            missing.append("logprobs")
        if sampling.mirostat:
            missing.append("mirostat")
        if missing:
            raise NotImplementedError(
                "not ported to the PyTorch engine yet: " + ", ".join(missing))

    def submit(
        self,
        prompt_ids: List[int],
        sampling: SamplingParams | None = None,
        on_token: Optional[Callable[[int, bool], None]] = None,
    ) -> Request:
        sampling = sampling or SamplingParams()
        self._validate_submit(prompt_ids, sampling)
        req = Request(next(self._rid), list(prompt_ids), sampling, on_token)
        req.seed = (
            sampling.seed if sampling.seed is not None
            else ((req.rid + 1) * 2654435761) % (2**32)
        )
        self.waiting.put(req, timeout=5)
        self.stats["requests"] += 1
        return req

    def generate(self, prompt_ids: List[int], sampling: SamplingParams | None = None) -> Request:
        """Synchronous convenience: run the loop until this request finishes."""
        req = self.submit(prompt_ids, sampling)
        while not req.finished:
            if not self.step():
                time.sleep(0.001)
        return req

    def snapshot(self) -> dict:
        raise NotImplementedError("snapshot/restore is not ported to the PyTorch engine yet")

    def restore(self, snap: dict, on_token_factory=None):
        raise NotImplementedError("snapshot/restore is not ported to the PyTorch engine yet")

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def step(self) -> bool:
        """One engine iteration: admit new requests (host-side setup only),
        run ONE batched prefill round, then one decode burst for the fully
        prefilled slots."""
        with self._lock:
            did = self._admit()
            did = self._prefill_round() or did
            if not self.ecfg.interleave_prefill:
                while self._prefill_round():
                    pass
            did = self._decode() or did
            return did

    def _alloc_pages(self, n: int) -> List[int]:
        if n == 0:
            return []
        if self.allocator.num_free < n and self.radix is not None:
            self.radix.evict(n - self.allocator.num_free)
        return self.allocator.alloc(n)

    def _next_waiting(self) -> Optional[Request]:
        """Pop the next request per the admission policy: `fifo` is arrival
        order; `sjf` takes the shortest prompt first, except that requests
        older than admission_aging_s go first (oldest wins)."""
        while True:
            try:
                self._backlog.append(self.waiting.get_nowait())
            except queue.Empty:
                break
        if not self._backlog:
            return None
        if self.ecfg.admission_policy == "sjf":
            now = time.monotonic()
            aged = [r for r in self._backlog
                    if now - r.arrival_t > self.ecfg.admission_aging_s]
            if aged:
                req = min(aged, key=lambda r: r.arrival_t)
            else:
                req = min(self._backlog, key=lambda r: (len(r.prompt_ids), r.rid))
        else:
            req = self._backlog[0]
        self._backlog.remove(req)
        return req

    def _requeue(self, req: Request):
        self._backlog.insert(0, req)

    def _admit(self) -> bool:
        did = False
        cap = self.ecfg.max_prefill_slots
        for slot in range(len(self.slots)):
            if self.slots[slot] is not None:
                continue
            if cap is not None and sum(
                1 for r in self.slots if r is not None and r.pending
            ) >= cap:
                break
            req = self._next_waiting()
            if req is None:
                break
            try:
                self._start_request(slot, req)
                did = True
            except MemoryError:
                # nothing running and nothing cached: no pages will ever free
                # up, so the request can never fit — reject it
                busy = any(s is not None for s in self.slots)
                cached = self.radix is not None and self.radix.num_cached_pages > 0
                if not busy and not cached:
                    req.finish_reason = "oom"
                    req.finished = True
                    if req.on_token is not None:
                        req.on_token(-1, True)
                    logger.warning("rejecting request %d: needs more KV pages than exist",
                                   req.rid)
                else:
                    self._requeue(req)  # retry when pages free up
                break
        return did

    def _set_page_row(self, slot: int, pages: List[int]):
        row = np.zeros((self.max_pages_per_seq,), np.int32)
        row[: len(pages)] = pages
        self.page_table[slot] = row

    def _start_request(self, slot: int, req: Request):
        ps = self.page_size
        src = req.prompt_ids + req.output_ids
        remaining_new = max(1, req.sampling.max_new_tokens - len(req.output_ids))
        total_budget = min(len(src) + remaining_new, self.ecfg.max_context)
        pages_needed_total = min(-(-total_budget // ps), self.max_pages_per_seq)

        matched = 0
        matched_pages: List[int] = []
        nodes = []
        if self.radix is not None:
            matched, matched_pages, nodes = self.radix.match(src)
            # never match the full prompt: at least one token must run
            while matched >= len(src) and nodes:
                nodes.pop()
                matched_pages.pop()
                matched -= ps
            self.radix.lock(nodes)
            self.stats["radix_hit_tokens"] += matched

        own_needed = pages_needed_total - len(matched_pages)
        try:
            own_pages = self._alloc_pages(max(own_needed, 0))
        except MemoryError:
            if self.radix is not None:
                self.radix.unlock(nodes)
            raise

        req.slot = slot
        req.pages = own_pages
        req.matched_nodes = nodes
        req.matched_pages = matched_pages
        req.matched_tokens = matched
        req.seq_len = matched
        req.pending = list(src[matched:])
        self._set_page_row(slot, matched_pages + own_pages)
        self.seq_lens[slot] = matched
        self.slots[slot] = req
        s = req.sampling
        if s.temperature > 0 and req.generator is None:
            req.generator = torch.Generator(device=self.device)
            req.generator.manual_seed(int(req.seed))
        self.slot_temps[slot] = s.temperature
        self.slot_tps[slot] = s.top_p
        self.slot_topks[slot] = max(0, s.top_k)
        self.slot_minps[slot] = max(0.0, s.min_p)
        self.slot_typps[slot] = s.typical_p
        self.slot_tfs[slot] = s.tfs_z
        self.slot_reps[slot] = s.repetition_penalty
        self.slot_pres[slot] = s.presence_penalty
        self.slot_freqs[slot] = s.frequency_penalty
        W = self.ecfg.penalty_window
        ln = s.penalty_last_n
        self.slot_lastn[slot] = W if ln < 0 else min(ln, W)
        self.slot_bias_ids[slot] = -1
        self.slot_bias_vals[slot] = 0.0
        if s.logit_bias:
            for k, (tid, bv) in enumerate(s.logit_bias):
                self.slot_bias_ids[slot, k] = int(tid)
                self.slot_bias_vals[slot, k] = float(bv)
        self._dirty = True

    def _rematch_prefix(self, slot: int, req: Request) -> None:
        """Re-run the radix match for a row that has not written any KV yet
        (seq_len == matched_tokens) and adopt a longer cached prefix: lock the
        new nodes, release the superseded own pages, rebuild the page-table
        row. Token-identical — only who computes the shared prefix changes."""
        ps = self.page_size
        src = req.prompt_ids + req.output_ids
        matched, pages, nodes = self.radix.match(src)
        while matched >= len(src) and nodes:  # at least one token must run
            nodes.pop()
            pages.pop()
            matched -= ps
        if matched <= req.matched_tokens:
            return
        gained_pages = (matched - req.matched_tokens) // ps
        # never adopt more than the own pages we can release
        while gained_pages > len(req.pages) and nodes:
            nodes.pop()
            pages.pop()
            matched -= ps
            gained_pages -= 1
        if matched <= req.matched_tokens:
            return
        self.radix.lock(nodes)
        self.radix.unlock(req.matched_nodes)
        release = req.pages[:gained_pages]
        req.pages = req.pages[gained_pages:]
        self.allocator.release_all(release)
        self.stats["radix_hit_tokens"] += matched - req.matched_tokens
        req.matched_nodes = nodes
        req.matched_pages = pages
        req.matched_tokens = matched
        req.seq_len = matched
        req.pending = list(src[matched:])
        self._set_page_row(slot, pages + req.pages)
        self.seq_lens[slot] = matched
        self._dirty = True

    def _select_prefill_rows(self, rows):
        """Rows and bucket of this prefill round (see EngineConfig
        prefill_round_mode); the oldest row always advances."""
        by_bucket: Dict[int, list] = {}
        for i, r in rows:
            by_bucket.setdefault(self._pick_bucket(len(r.pending)), []).append((i, r))
        oldest = min(rows, key=lambda ir: ir[1].arrival_t)
        budget = self.ecfg.max_prefill_tokens_per_round
        mode = self.ecfg.prefill_round_mode
        if mode == "stagger":
            # depth-first: the oldest rows take the biggest bucket that fits
            # their pending length within the round budget
            bucket = self._pick_bucket(min(len(oldest[1].pending), budget))
            nrows = max(1, budget // bucket)
            rows_sorted = sorted(rows, key=lambda ir: (ir[1].arrival_t, ir[0]))
            if self.radix is not None:
                # same-wave prefix sharing: a row whose FIRST pending page
                # equals an earlier-selected row's waits a round, then
                # adopts the leader's published pages via _rematch_prefix
                ps = self.page_size
                seen, sel = set(), []
                for i, r in rows_sorted:
                    key = (
                        tuple(r.pending[:ps])
                        if r.seq_len == r.matched_tokens and len(r.pending) >= ps
                        else None
                    )
                    if key is not None and key in seen:
                        continue
                    if key is not None:
                        seen.add(key)
                    sel.append((i, r))
                    if len(sel) >= nrows:
                        break
                rows = sel
            else:
                rows = rows_sorted[:nrows]
        else:
            bucket = self._pick_bucket(len(oldest[1].pending))
            if mode != "all":  # "bucket": only the oldest row's bucket group
                rows = by_bucket[bucket]
        # bound the round's size: shrink the bucket until rows x bucket fits
        while len(rows) * bucket > budget and bucket > self.ecfg.prefill_buckets[0]:
            bucket = [b for b in self.ecfg.prefill_buckets if b < bucket][-1]
        return rows, bucket

    def _prefill_round(self) -> bool:
        """One batched prefill call: the next chunk for the selected
        mid-prefill slots. Rows are padded to a power-of-two batch (dummy
        rows write to the trash page / trash staging slot)."""
        rows = [(i, r) for i, r in enumerate(self.slots) if r is not None and r.pending]
        if not rows:
            return False
        if self.radix is not None:
            # in-queue re-match: rows that have not written KV yet can adopt
            # prefix pages another row published since admission
            for i, r in rows:
                if r.seq_len == r.matched_tokens:
                    self._rematch_prefix(i, r)
            rows = [(i, r) for i, r in rows if r.pending]
            if not rows:
                return False
        NS = len(self.slots)
        rows, bucket = self._select_prefill_rows(rows)
        chunks = [(i, r, r.pending[:bucket]) for i, r in rows]
        B = 1
        while B < len(chunks):
            B *= 2
        mp_pre = self._pages_bucket(max(r.seq_len + len(c) + 1 for _, r, c in chunks))

        toks = np.zeros((B, bucket), np.int32)
        pt = np.zeros((B, mp_pre), np.int32)
        seq = np.zeros((B,), np.int32)
        new = np.zeros((B,), np.int32)
        sids = np.full((B,), NS, np.int32)  # dummy rows -> trash staging
        W = self.ecfg.penalty_window
        Kb = self.ecfg.logit_bias_slots
        samp = {
            "temps": np.zeros((B,), np.float32), "tps": np.ones((B,), np.float32),
            "topks": np.zeros((B,), np.int32), "minps": np.zeros((B,), np.float32),
            "typps": np.ones((B,), np.float32), "tfs": np.ones((B,), np.float32),
            "reps": np.ones((B,), np.float32), "pres": np.zeros((B,), np.float32),
            "freqs": np.zeros((B,), np.float32), "lastn": np.zeros((B,), np.int32),
            "bias_ids": np.full((B, Kb), -1, np.int32),
            "bias_vals": np.zeros((B, Kb), np.float32),
        }
        ring = np.full((B, W), -1, np.int32)
        gens: List[Optional[torch.Generator]] = [None] * B
        for j, (i, r, chunk) in enumerate(chunks):
            toks[j, : len(chunk)] = chunk
            pt[j] = self.page_table[i, :mp_pre]
            seq[j] = r.seq_len
            new[j] = len(chunk)
            sids[j] = i
            if len(chunk) < len(r.pending):
                continue  # no token is sampled for this row this round
            # this chunk completes the prompt: its row samples the first token
            gens[j] = r.generator
            for key, arr in (("temps", self.slot_temps), ("tps", self.slot_tps),
                             ("topks", self.slot_topks), ("minps", self.slot_minps),
                             ("typps", self.slot_typps), ("tfs", self.slot_tfs),
                             ("bias_ids", self.slot_bias_ids),
                             ("bias_vals", self.slot_bias_vals)):
                samp[key][j] = arr[i]
            if r.sampling.has_penalties:
                for key, arr in (("reps", self.slot_reps), ("pres", self.slot_pres),
                                 ("freqs", self.slot_freqs), ("lastn", self.slot_lastn)):
                    samp[key][j] = arr[i]
                # window over the prompt as cached so far + this chunk
                stream = r.prompt_ids + r.output_ids
                n = r.seq_len + len(chunk)
                for p in range(max(0, n - W), min(n, len(stream))):
                    ring[j, p % W] = stream[p]

        dev = self.device
        fn = self._prefill_fns.get(bucket)
        if fn is None:
            fn = self._prefill_fns[bucket] = prefill_for_bucket(self, bucket)
        nxt, self.pools = fn(
            self.pools, torch.as_tensor(toks, device=dev), torch.as_tensor(pt, device=dev),
            torch.as_tensor(seq, device=dev), torch.as_tensor(new, device=dev),
            torch.as_tensor(sids, device=dev), torch.as_tensor(ring, device=dev), samp, gens,
        )
        for j, (i, r, chunk) in enumerate(chunks):
            r.pending = r.pending[len(chunk):]
            r.seq_len += len(chunk)
            self.seq_lens[i] = r.seq_len
            self.stats["prefill_tokens"] += len(chunk)
            if not r.pending:  # prompt fully cached: first sampled token
                if self.radix is not None:
                    # eager insert: publish the prompt's full pages now so
                    # queued same-wave rows can adopt them
                    fullp = r.seq_len // self.page_size
                    if fullp > 0:
                        src_r = r.prompt_ids + r.output_ids
                        self.radix.insert(
                            src_r[: fullp * self.page_size],
                            (r.matched_pages + r.pages)[:fullp],
                        )
                first_tok = int(nxt[j])
                self._emit_token(r, first_tok)
                if not r.finished:
                    self.last_tokens[i] = first_tok
        self.stats["prefill_rounds"] = self.stats.get("prefill_rounds", 0) + 1
        self._dirty = True
        return True

    def _pick_bucket(self, n: int) -> int:
        for b in self.ecfg.prefill_buckets:
            if n <= b:
                return b
        return self.ecfg.prefill_buckets[-1]

    def _pages_bucket(self, tokens_needed: int) -> int:
        """Page-table width covering `tokens_needed`, rounded to the next
        power of two (at least 8): attention gathers every table column."""
        need = -(-tokens_needed // self.page_size) + 1
        mp = 8
        while mp < need:
            mp *= 2
        return min(mp, self.max_pages_per_seq)

    def _upload_state(self, mp: int):
        """Device copies of the decode state. Mid-prefill slots are masked
        out of decode bursts: zeroed page-table row (writes land in the trash
        page), zeroed length/last token, trash staging slot NS."""
        NS = len(self.slots)
        pt = self.page_table[:, :mp].copy()
        sl = self.seq_lens.copy()
        last = self.last_tokens.copy()
        sids = np.arange(NS, dtype=np.int32)
        W = self.ecfg.penalty_window
        ring = np.full((NS, W), -1, np.int32)
        for i, r in enumerate(self.slots):
            if r is not None and r.pending:
                pt[i] = 0
                sl[i] = 0
                last[i] = 0
                sids[i] = NS
            elif r is not None:
                # penalty ring: the token at position p lives at ring[i, p % W]
                toks_all = r.prompt_ids + r.output_ids
                n = int(self.seq_lens[i])
                for p in range(max(0, n - W), min(n, len(toks_all))):
                    ring[i, p % W] = toks_all[p]
        dev = self.device
        self._dstate = tuple(
            torch.as_tensor(a, device=dev) for a in (last, pt, sl, sids, ring))
        self._mp_bucket = mp
        self._dirty = False

    def _decode(self) -> bool:
        # mid-prefill slots do not decode (masked to trash in _upload_state)
        active = [i for i, r in enumerate(self.slots) if r is not None and not r.pending]
        if not active:
            return False
        K = self.ecfg.decode_burst
        ps = self.page_size
        # pages must cover the burst's maximum advance per slot
        for i in active:
            req = self.slots[i]
            lp_lo = req.seq_len // ps
            lp_hi = min((req.seq_len + K - 1) // ps, self.max_pages_per_seq - 1)
            for lp in range(lp_lo, lp_hi + 1):
                if self.page_table[i, lp] == 0:
                    pg = self._alloc_or_preempt(req)
                    req.pages.append(pg)
                    self.page_table[i, lp] = pg
                    self._dirty = True
        max_seq = max(self.seq_lens[i] for i in active)
        mp = self._pages_bucket(int(max_seq) + K)
        if self._dirty or self._dstate is None or mp != self._mp_bucket:
            self._upload_state(mp)
        self._dispatch_burst(active)
        return True

    def _dispatch_burst(self, rows):
        """Run one decode burst for `rows` on the device state and emit the
        sampled tokens. The burst shortens (K/2, K/4, ... >= 8) when every
        row finishes within a shorter one."""
        d_last, d_pt, d_sl, d_sids, d_ring = self._dstate
        K = self.ecfg.decode_burst
        room_cap = min(self.ecfg.max_context, self.max_pages_per_seq * self.page_size)
        if K > 8:
            rem = 1
            for i in rows:
                r = self.slots[i]
                rem = max(rem, min(r.sampling.max_new_tokens - len(r.output_ids),
                                   room_cap - r.seq_len))
            while K // 2 >= max(8, rem):
                K //= 2
        fn = self._decode_fns.get(K)
        if fn is None:
            fn = self._decode_fns[K] = build_decode(self, burst_steps=K)
        # only decoding rows sample (a masked mid-prefill row must not draw
        # from its request's generator)
        on = np.zeros((len(self.slots),), bool)
        on[rows] = True
        samp = {
            "temps": np.where(on, self.slot_temps, 0.0).astype(np.float32),
            "tps": self.slot_tps, "topks": self.slot_topks, "minps": self.slot_minps,
            "typps": self.slot_typps, "tfs": self.slot_tfs, "reps": self.slot_reps,
            "pres": self.slot_pres, "freqs": self.slot_freqs, "lastn": self.slot_lastn,
            "bias_ids": self.slot_bias_ids, "bias_vals": self.slot_bias_vals,
        }
        gens = [self.slots[i].generator if on[i] else None for i in range(len(self.slots))]
        toks, self.pools, d_last, d_sl, d_ring = fn(
            self.pools, d_last, d_pt, d_sl, d_sids, d_ring, samp, gens)
        self._dstate = (d_last, d_pt, d_sl, d_sids, d_ring)
        self.stats["decode_steps"] += toks.shape[0]
        for i in rows:
            req = self.slots[i]
            for k in range(toks.shape[0]):
                if req.finished:
                    break
                if req.seq_len >= room_cap:
                    self._finish(req, "length")
                    break
                req.seq_len += 1
                self.seq_lens[i] = req.seq_len
                tok = int(toks[k, i])
                self.stats["decode_tokens"] += 1
                self._emit_token(req, tok)
                if not req.finished:
                    self.last_tokens[i] = tok

    # ------------------------------------------------------------------
    # finishing
    # ------------------------------------------------------------------

    def _emit_token(self, req: Request, tok: int):
        if req.first_token_t is None:
            req.first_token_t = time.monotonic()
        req.output_ids.append(tok)
        s = req.sampling
        finished, reason = False, ""
        if not s.ignore_eos and self.eos_token_id is not None and tok == self.eos_token_id:
            finished, reason = True, "stop"
        elif s.stop_token_ids and tok in s.stop_token_ids:
            finished, reason = True, "stop"
        elif len(req.output_ids) >= s.max_new_tokens:
            finished, reason = True, "length"
        elif req.seq_len + 1 >= self.ecfg.max_context:
            finished, reason = True, "length"
        if finished:
            # set the reason before notifying: stream consumers read it as
            # soon as they see fin=True
            req.finish_reason = reason
        if req.on_token is not None:
            req.on_token(tok, finished)
        if finished:
            self._finish(req, reason)

    def _alloc_or_preempt(self, req: Request) -> int:
        """Allocate one KV page. The reference retracts a victim request
        when the pool is dry; the port does not preempt yet."""
        try:
            (pg,) = self._alloc_pages(1)
            return pg
        except MemoryError:
            raise NotImplementedError(
                "KV pool exhausted during decode: preemption is not ported to the "
                "PyTorch engine yet (raise EngineConfig.num_pages)") from None

    def cancel(self, req: Request, reason: str = "abort") -> bool:
        """Terminate an in-flight or queued request. Thread-safe; no-op if
        already finished. Returns True if the request was cancelled."""
        with self._lock:
            if req.finished:
                return False
            while True:  # drain waiting -> backlog so queued reqs are visible
                try:
                    self._backlog.append(self.waiting.get_nowait())
                except queue.Empty:
                    break
            if req in self._backlog:
                self._backlog.remove(req)
            req.finish_reason = reason
            req.finished = True
            if req.on_token is not None:
                req.on_token(-1, True)
            self._finish(req, reason)
            return True

    def latency_summary(self) -> dict:
        """p50/p95/p99 TTFT and end-to-end latency over the rolling window of
        finished requests (empty dict until one finishes)."""
        log = list(self.latency_log)
        if not log:
            return {}
        ttfts = np.asarray([x[0] for x in log])
        e2es = np.asarray([x[1] for x in log])
        q = [50, 95, 99]
        t50, t95, t99 = np.percentile(ttfts, q)
        e50, e95, e99 = np.percentile(e2es, q)
        return {
            "window": len(log),
            "ttft_s": {"p50": round(float(t50), 4), "p95": round(float(t95), 4),
                       "p99": round(float(t99), 4)},
            "e2e_s": {"p50": round(float(e50), 4), "p95": round(float(e95), 4),
                      "p99": round(float(e99), 4)},
        }

    def _finish(self, req: Request, reason: str):
        self._dirty = True
        req.finished = True
        req.finish_reason = reason
        req.finish_t = time.monotonic()
        if req.first_token_t is not None:
            self.latency_log.append((
                req.first_token_t - req.arrival_t,
                req.finish_t - req.arrival_t,
                len(req.output_ids),
            ))
        slot = req.slot
        if slot >= 0 and self.slots[slot] is req:
            self.slots[slot] = None
            self.page_table[slot] = 0
            self.seq_lens[slot] = 0
            self.last_tokens[slot] = 0
        # hand full pages to the radix tree, release the rest
        seq_tokens = req.prompt_ids + req.output_ids
        full = req.seq_len // self.page_size
        if self.radix is not None and full > 0:
            all_pages = req.matched_pages + req.pages
            self.radix.insert(seq_tokens[: full * self.page_size], all_pages[:full])
        if self.radix is not None:
            self.radix.unlock(req.matched_nodes)
        self.allocator.release_all(req.pages)
        req.pages = []
        req.matched_nodes = []
        req.matched_pages = []
