"""Continuous-batching inference engine (PyTorch port).

Counterpart of ``wrinklefree_tpu/engine/engine.py``, with the same host
scheduler: fixed ``max_batch_slots`` decode slots; queued requests admitted
into free slots (fifo or sjf); chunked prefill at bucketed lengths, one
batched round per step (stagger / bucket / all), interleaved with decode; a
radix prefix cache over full KV pages with eager publish and in-queue
re-match; K-step decode bursts with one host read each; page 0 as trash;
a dry page pool retracts a victim request, which re-prefills later.

Request features as the reference's: counter-keyed sampling (a request's
n-th sampled token draws from ``fold_in(PRNGKey(seed), counter_base + n)``,
so a seeded stream does not depend on the batch, and a retracted or restored
request resumes it), logprobs, mirostat v2, constrained decoding (json_mode,
GBNF grammars; ``engine/constrained.py``) on single-step dispatches segregated
from the other rows' bursts, and request-level snapshot/restore
(``engine/snapshot.py``). With ``speculative_k`` > 0 a burst whose rows are
all greedy (no logprobs, penalties, bias or constraint) is speculative
(``programs.build_decode_spec``): n-gram drafts from a device history of
every slot's tokens, verified k+1 rows at a time, with a sticky adaptive
cutoff (``spec_min_accept`` over ``spec_min_accept_window`` drafts).

The device half is ``paged_forward`` with the fused kernels
(``ops/ternary_cuda.py``, ``ops/kv_update_cuda.py``,
``ops/flash_attention.py``) over the dual or token-major KV layout, bf16,
fp16, f32, int8 or fp8 pools, optionally a sliding attention window; the
output head is the bf16 one, the int8 one (``int8_logits``) or the exact
greedy head (``exact_head_k``). On the CPU the same calls run their plain
versions. The host's page allocator and radix cache are the native C++
classes (``native/``) when they build, else the Python ones. Engine
configurations outside the port raise ``NotImplementedError`` at
construction.
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
from ..kv.paged import PagedKV, make_dual_window_attention
from ..kv.quantized import needs_scale
from ..models.bitnet import fuse_projections, quantize_lm_head, resolve_device
from ..ops.ternary_cuda import make_linear_fused, make_linear_stacked
from .page_allocator import PageAllocator
from .programs import build_decode, build_decode_spec, prefill_for_bucket
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
    # per emitted token, when sampling.logprobs_k > 0: (chosen_logprob,
    # [(token_id, logprob), ...] top-k), appended before on_token fires
    logprobs_seq: List[tuple] = dataclasses.field(default_factory=list)
    # sampling-stream offset of a request restored from a snapshot: its key
    # is fold_in(PRNGKey(seed), counter_base + #sampled)
    counter_base: int = 0
    seed: int = 0  # per-request sampling stream (sampling.seed or derived from rid)
    finished: bool = False
    finish_reason: str = ""
    arrival_t: float = dataclasses.field(default_factory=time.monotonic)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    # constrained decoding's validator over the text emitted so far
    # (json_mode / grammar), created at admission
    grammar: object = None


def _host_runtime(e: EngineConfig):
    """(allocator, radix cache or None, native?): the native C++ classes when
    ``use_native_runtime`` and they build, else the Python ones (a warning
    says why), as the reference falls back."""
    if e.use_native_runtime:
        try:
            from ..native import NativePageAllocator, NativeRadixCache

            alloc = NativePageAllocator(e.num_pages)
            radix = NativeRadixCache(alloc, e.page_size) if e.enable_radix_cache else None
            return alloc, radix, True
        except Exception as err:
            logger.warning("native host runtime unavailable (%s); using the Python "
                           "allocator and radix cache", err)
    alloc = PageAllocator(e.num_pages)
    return alloc, RadixCache(alloc, e.page_size) if e.enable_radix_cache else None, False


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
        """``params`` are the model's params on ``device`` (default CUDA;
        raises without CUDA unless the caller asks for ``device='cpu'``).
        As on the reference's kernel path, a dense model's projections are
        fused and run the fused-prologue kernels (``make_linear_fused``); an
        MoE model (``cfg.num_experts > 0``) keeps them unfused and runs the
        stacked K7 linear (``make_linear_stacked``), its experts through K7
        too. ``linear_fn``/``attention_fn`` override the kernels as in
        ``paged_forward`` (an ``attention_fn`` takes the place of the window
        attention too; each KV layout calls it with its own arguments, as
        ``paged_forward`` documents). ``kv_layout`` is the resolved layout and
        ``native_runtime`` says whether the native host runtime runs. Every
        KV dtype serves on the card and on the CPU: K3, K4 and K6 take the
        unquantized pools (bf16, fp16, f32), the quantized ones (int8, fp8)
        take the plain attention, as in the reference."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = e = ecfg or EngineConfig()
        missing = []
        if mesh is not None:
            missing.append("mesh (tensor parallelism)")
        if long_context_mesh is not None:
            missing.append("long_context_mesh (ring-attention long context)")
        if missing:
            raise NotImplementedError(
                "not ported to the PyTorch engine yet: " + ", ".join(missing))
        if e.exact_head_k and e.int8_logits:
            raise ValueError("int8_logits (approximate) and exact_head_k (exact) are "
                             "mutually exclusive")
        if e.int8_logits or e.exact_head_k:
            # adds lm_head_q/lm_head_s, which compute_logits then prefers
            params = quantize_lm_head(params, cfg)
        moe = cfg.num_experts > 0
        if not moe and "qkv_qw" not in params["layers"]:
            params = fuse_projections(params, cfg)
        self.params = params
        # decode steps whose exact-head certificate failed (device counter)
        self.exact_fallbacks = torch.zeros((), dtype=torch.int64, device=self.device)
        self.eos_token_id = eos_token_id
        self._linear_fn = linear_fn or (make_linear_stacked() if moe else make_linear_fused())
        self._attention_fn = attention_fn

        self.page_size = ps = e.page_size
        # power-of-two table width (as the reference, whose flash tiling
        # needed 128-multiple histories; kept so page-table shapes agree)
        need = -(-e.max_context // ps)
        self.max_pages_per_seq = 8
        while self.max_pages_per_seq < need:
            self.max_pages_per_seq *= 2
        layout = e.kv_layout
        if layout == "auto":
            layout = "token" if needs_scale(e.kv_dtype) else "layer"
        if layout not in ("layer", "token"):
            raise ValueError(f"kv_layout {e.kv_layout!r}: auto, layer or token")
        self.kv_layout = layout
        if layout == "layer":
            # dual layout: prefill chunks start page-aligned, so buckets are
            # multiples of page_size
            self.ecfg = e = dataclasses.replace(
                e, prefill_buckets=tuple(sorted({-(-b // ps) * ps for b in e.prefill_buckets})))
        self.pools = self._zero_pools(e.num_pages)
        if self._attention_fn is None and e.attn_window > 0:
            # sliding-window attention: the page-skipping gather of the dual
            # layout, whose reads scale with the window, not the context
            if not self.pools.dual:
                raise ValueError("attn_window requires the dual KV layout (kv_layout "
                                 "'layer', or 'auto' with unquantized KV)")
            self._attention_fn = make_dual_window_attention(e.attn_window,
                                                            e.attn_global_tokens)
        self.allocator, self.radix, self.native_runtime = _host_runtime(e)

        S = e.max_batch_slots
        self.page_table = np.zeros((S, self.max_pages_per_seq), np.int32)
        self.seq_lens = np.zeros((S,), np.int32)
        self.slots: List[Optional[Request]] = [None] * S
        self.last_tokens = np.zeros((S,), np.int32)
        self.slot_seeds = np.zeros((S,), np.uint32)
        self.slot_counters = np.zeros((S,), np.int64)
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
        self.slot_miro = np.zeros((S,), np.int32)
        self.slot_mtau = np.full((S,), 5.0, np.float32)
        self.slot_meta = np.full((S,), 0.1, np.float32)
        self.slot_mu = np.zeros((S,), np.float32)  # mirostat state (2 * tau at admission)
        self._mu_fresh = set()  # slots whose mu was (re)initialised since the last upload
        Kb = e.logit_bias_slots
        self.slot_bias_ids = np.full((S, Kb), -1, np.int32)
        self.slot_bias_vals = np.zeros((S, Kb), np.float32)
        # device copies of the scheduling state, uploaded after scheduling
        # events; the page table is sliced to the active-history bucket
        self._dstate = None
        self._dstate_cand = None  # the constrained rows' view (segregated decode)
        self._mp_bucket = 0
        self._dirty = True
        # speculative decoding: the device token history [S, max_context]
        # (uploaded with the decode state) and the sticky adaptive cutoff
        self._dhist = None
        self._spec_off = False

        self.waiting: "queue.Queue[Request]" = queue.Queue(maxsize=e.max_queue)
        self._backlog: List[Request] = []  # drained from `waiting`, policy-ordered
        self._rid = itertools.count()
        self._lock = threading.Lock()
        # serving programs, built lazily: (kind, burst length or bucket,
        # *the variant's flags that are on)
        self._programs: Dict[tuple, Callable] = {}
        # id -> decoded text piece, set by the embedder (the server) before
        # constrained requests can run
        self.token_pieces: Optional[List[str]] = None

        self.stats = {"decode_steps": 0, "decode_tokens": 0, "prefill_tokens": 0,
                      "radix_hit_tokens": 0, "requests": 0}
        # rolling (ttft_s, e2e_s, n_tokens) of the last 512 finished requests
        self.latency_log = collections.deque(maxlen=512)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def _zero_pools(self, num_pages: int) -> PagedKV:
        """Zeroed pools of this engine's layout and dtype with ``num_pages``
        pages (the dual layout's staging for every slot)."""
        e = self.ecfg
        if self.kv_layout == "layer":
            return PagedKV.zeros_dual(self.cfg, num_pages, self.page_size, e.max_batch_slots,
                                      e.kv_dtype, device=self.device)
        return PagedKV.zeros(self.cfg, num_pages, self.page_size, e.kv_dtype,
                             device=self.device)

    def _validate_submit(self, prompt_ids, sampling: SamplingParams):
        limit = self.ecfg.max_context
        if len(prompt_ids) >= limit:
            raise ValueError(f"prompt too long: {len(prompt_ids)} >= max_context {limit}")
        if sampling.logit_bias and len(sampling.logit_bias) > self.ecfg.logit_bias_slots:
            raise ValueError(
                f"logit_bias has {len(sampling.logit_bias)} entries; engine supports "
                f"{self.ecfg.logit_bias_slots} (EngineConfig.logit_bias_slots)")
        if sampling.constrained:
            if self.token_pieces is None:
                raise ValueError("constrained decoding (json_mode/grammar) requires "
                                 "Engine.token_pieces (id -> decoded text) to be set")
            if sampling.logprobs_k > 0:
                raise ValueError("constrained decoding with logprobs not supported")
            if sampling.grammar and not sampling.json_mode:
                from .gbnf import GbnfValidator

                GbnfValidator(sampling.grammar)  # raises on parse errors
            if sampling.mirostat:
                raise ValueError("mirostat with constrained decoding not supported")
        if sampling.mirostat and sampling.logprobs_k > 0:
            raise ValueError("mirostat with logprobs not supported")

    def submit(
        self,
        prompt_ids: List[int],
        sampling: SamplingParams | None = None,
        on_token: Optional[Callable[[int, bool], None]] = None,
    ) -> Request:
        sampling = sampling or SamplingParams()
        self._validate_submit(prompt_ids, sampling)
        return self._enqueue(self._new_request(prompt_ids, sampling, on_token))

    def _new_request(self, prompt_ids, sampling: SamplingParams, on_token=None) -> Request:
        req = Request(next(self._rid), list(prompt_ids), sampling, on_token)
        req.seed = (
            sampling.seed if sampling.seed is not None
            else ((req.rid + 1) * 2654435761) % (2**32)
        )
        return req

    def _enqueue(self, req: Request) -> Request:
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

    def has_work(self) -> bool:
        return (
            not self.waiting.empty()
            or bool(self._backlog)
            or any(s is not None for s in self.slots)
        )

    def prefix_match_len(self, prompt_ids) -> int:
        """Length (tokens) of this engine's cached radix prefix for the
        prompt: a read-only probe (0 without a radix cache)."""
        if self.radix is None:
            return 0
        with self._lock:
            matched, _pages, _nodes = self.radix.match(list(prompt_ids))
        return matched

    def reset_prefix_cache(self) -> int:
        """Drop every radix-cached page, returning them to the free pool;
        returns the number of pages released. Radix pages outlive their
        requests, so a warmed engine near pool capacity would evict inside a
        measured window. Refuses while any request is active or queued."""
        with self._lock:
            if self.has_work():
                raise RuntimeError("reset_prefix_cache requires an idle engine")
            if self.radix is None:
                return 0
            n = self.radix.num_cached_pages
            self.radix.reset()
            return n

    def warmup(self) -> Dict[str, float]:
        """Build the kernels and run every serving program once on scratch
        pools (``engine/programs.py::warmup``); returns {program: seconds}."""
        from .programs import warmup

        return warmup(self)

    def snapshot(self) -> dict:
        """Request-level state capture (``engine/snapshot.py``)."""
        from .snapshot import snapshot

        return snapshot(self)

    def restore(self, snap: dict, on_token_factory=None) -> List[Request]:
        """Resubmit a snapshot's requests (``engine/snapshot.py``)."""
        from .snapshot import restore

        return restore(self, snap, on_token_factory)

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
        self.slot_seeds[slot] = req.seed
        # counter = counter_base + #sampled so far: a retracted request
        # resumes its seeded stream where it stopped
        self.slot_counters[slot] = req.counter_base + len(req.output_ids)
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
        self.slot_miro[slot] = s.mirostat
        self.slot_mtau[slot] = s.mirostat_tau
        self.slot_meta[slot] = s.mirostat_eta
        self.slot_mu[slot] = 2.0 * s.mirostat_tau
        self._mu_fresh.add(slot)
        if s.constrained and req.grammar is None:
            req.grammar = self._make_validator(s)
            # a continued request replays the text generated so far
            for t in req.output_ids:
                req.grammar.advance(self.token_pieces[t])
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
        seeds = np.zeros((B,), np.int64)
        ctrs = np.zeros((B,), np.int64)
        sids = np.full((B,), NS, np.int32)  # dummy rows -> trash staging
        W = self.ecfg.penalty_window
        samp = self._samp_arrays(B)
        ring = np.full((B, W), -1, np.int32)
        for j, (i, r, chunk) in enumerate(chunks):
            toks[j, : len(chunk)] = chunk
            pt[j] = self.page_table[i, :mp_pre]
            seq[j] = r.seq_len
            new[j] = len(chunk)
            sids[j] = i
            seeds[j] = r.seed
            ctrs[j] = r.counter_base + len(r.output_ids)
            if len(chunk) < len(r.pending):
                continue  # no token is sampled for this row this round
            # this chunk completes the prompt: its row samples the first token
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

        want_lp = any(r.sampling.logprobs_k > 0 and len(r.pending) <= bucket
                      for _, r, _ in chunks)
        want_cand = any(r.sampling.constrained and len(r.pending) <= bucket
                        for _, r, _ in chunks)
        # a round mixing logprobs rows and constrained rows runs the
        # full-logits variant; the logprobs are then computed on the host from
        # the same logits
        fn = self._prefill_fn(bucket, with_logprobs=want_lp and not want_cand,
                              return_logits=want_cand)
        dev = self.device
        out, self.pools = fn(
            self.pools, torch.as_tensor(toks, device=dev), torch.as_tensor(pt, device=dev),
            torch.as_tensor(seq, device=dev), torch.as_tensor(new, device=dev),
            torch.as_tensor(seeds, device=dev), torch.as_tensor(ctrs, device=dev),
            torch.as_tensor(sids, device=dev), torch.as_tensor(ring, device=dev), samp,
        )
        logits_d = lp_np = None
        if want_cand:
            nxt, logits_d = out
        elif want_lp:
            nxt, lp_np = out[0], out[1:]
        else:
            nxt = out
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
                row = None
                if logits_d is not None and (r.sampling.constrained
                                             or r.sampling.logprobs_k > 0):
                    row = logits_d[j].cpu().numpy()  # this row only
                status = ""
                if r.sampling.constrained:
                    first_tok, status = self._select_constrained(r, row)
                    if first_tok is None:
                        self._finish_notify(r, "stop")
                        continue
                else:
                    first_tok = int(nxt[j])
                lp = None
                if r.sampling.logprobs_k > 0:
                    if lp_np is not None:
                        lp = (lp_np[0][j], lp_np[1][j], lp_np[2][j])
                    elif row is not None:
                        # mixed round: logprobs from the full logits
                        lg = row.astype(np.float64)
                        lsm = lg - (lg.max() + np.log(np.exp(lg - lg.max()).sum()))
                        top = np.argsort(-lsm)[: self.ecfg.logprobs_top]
                        lp = (lsm[first_tok], top, lsm[top])
                self._emit_token(r, first_tok, lp)
                if not r.finished and status == "complete":
                    self._finish_notify(r, "stop")
                if not r.finished:
                    self.last_tokens[i] = first_tok
                self.slot_counters[i] = r.counter_base + len(r.output_ids)
        self.stats["prefill_rounds"] = self.stats.get("prefill_rounds", 0) + 1
        self._dirty = True
        return True

    def _samp_arrays(self, B: int) -> Dict[str, np.ndarray]:
        """Per-row sampler settings at their identity values; mirostat runs
        from the first decode step, so the prefill sampler never uses it."""
        Kb = self.ecfg.logit_bias_slots
        return {
            "temps": np.zeros((B,), np.float32), "tps": np.ones((B,), np.float32),
            "topks": np.zeros((B,), np.int32), "minps": np.zeros((B,), np.float32),
            "typps": np.ones((B,), np.float32), "tfs": np.ones((B,), np.float32),
            "reps": np.ones((B,), np.float32), "pres": np.zeros((B,), np.float32),
            "freqs": np.zeros((B,), np.float32), "lastn": np.zeros((B,), np.int32),
            "bias_ids": np.full((B, Kb), -1, np.int32),
            "bias_vals": np.zeros((B, Kb), np.float32),
            "miro": np.zeros((B,), np.int32), "mtau": np.full((B,), 5.0, np.float32),
            "meta": np.full((B,), 0.1, np.float32),
        }

    def _slot_samp(self, on: np.ndarray) -> Dict[str, np.ndarray]:
        """The slots' sampler settings for a decode dispatch; only the rows in
        ``on`` sample (the others are masked out of the dispatch)."""
        return {
            "temps": np.where(on, self.slot_temps, 0.0).astype(np.float32),
            "tps": self.slot_tps, "topks": self.slot_topks, "minps": self.slot_minps,
            "typps": self.slot_typps, "tfs": self.slot_tfs, "reps": self.slot_reps,
            "pres": self.slot_pres, "freqs": self.slot_freqs, "lastn": self.slot_lastn,
            "bias_ids": self.slot_bias_ids, "bias_vals": self.slot_bias_vals,
            "miro": self.slot_miro, "mtau": self.slot_mtau, "meta": self.slot_meta,
        }

    def _program(self, kind: str, size: int, build: Callable, **flags) -> Callable:
        key = (kind, size, *sorted(k for k, on in flags.items() if on))
        if key not in self._programs:
            self._programs[key] = build(self, size, **flags)
        return self._programs[key]

    def _prefill_fn(self, bucket: int, with_logprobs: bool = False,
                    return_logits: bool = False) -> Callable:
        return self._program("prefill", bucket, prefill_for_bucket,
                             with_logprobs=with_logprobs, return_logits=return_logits)

    def _decode_fn(self, K: int, with_logprobs: bool = False, return_logits: bool = False,
                   with_mirostat: bool = False) -> Callable:
        return self._program("decode", K, build_decode, with_logprobs=with_logprobs,
                             return_logits=return_logits, with_mirostat=with_mirostat)

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
        page), zeroed length/last token, trash staging slot NS. While a
        constrained request decodes, its row is masked the same way in the
        burst view, and a second view (``_dstate_cand``) masks every other
        row: the other slots keep their K-step bursts while the constrained
        rows step one token at a time through the full-logits program."""
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
        # mirostat's mu evolves on the device between uploads: pull it back
        # for running slots (freshly admitted slots keep their 2 * tau)
        if self._dstate is not None and any(
                r is not None and r.sampling.mirostat and i not in self._mu_fresh
                for i, r in enumerate(self.slots)):
            dev_mu = self._dstate[7].cpu().numpy()
            for i in range(NS):
                if i not in self._mu_fresh:
                    self.slot_mu[i] = dev_mu[i]
        self._mu_fresh.clear()
        dev = self.device

        def up(a):
            return torch.as_tensor(a, device=dev)

        d_seeds = up(self.slot_seeds.astype(np.int64))
        d_ctr = up(self.slot_counters)
        d_mu = up(self.slot_mu)
        cons_rows = [i for i, r in enumerate(self.slots)
                     if r is not None and not r.pending and r.sampling.constrained]
        self._dstate_cand = None
        if cons_rows:
            pt_c, sl_c, last_c = np.zeros_like(pt), np.zeros_like(sl), np.zeros_like(last)
            sids_c = np.full_like(sids, NS)
            for i in cons_rows:
                pt_c[i], sl_c[i], last_c[i], sids_c[i] = pt[i], sl[i], last[i], sids[i]
                pt[i], sl[i], last[i], sids[i] = 0, 0, 0, NS
            # its own ring: a burst writes the ring in place
            self._dstate_cand = (up(last_c), up(pt_c), up(sl_c), d_seeds, d_ctr, up(sids_c),
                                 up(ring), d_mu)
        self._dstate = (up(last), up(pt), up(sl), d_seeds, d_ctr, up(sids), up(ring), d_mu)
        if self.ecfg.speculative_k > 0 and not self._spec_off:
            # n-gram drafting's history: hist[b, pos] = the token at position pos
            hist = np.zeros((NS, self.ecfg.max_context), np.int32)
            for i, r in enumerate(self.slots):
                if r is not None and not r.pending:
                    toks_all = (r.prompt_ids + r.output_ids)[: self.ecfg.max_context]
                    hist[i, : len(toks_all)] = toks_all
            self._dhist = up(hist)
        self._mp_bucket = mp
        self._dirty = False

    def _decode(self) -> bool:
        # mid-prefill slots do not decode (masked to trash in _upload_state)
        active = [i for i, r in enumerate(self.slots) if r is not None and not r.pending]
        if not active:
            return False
        K = self.ecfg.decode_burst
        ps = self.page_size
        spec = self._spec_burst_applies(active)
        adv = K * (self.ecfg.speculative_k + 1) if spec else K  # max positions per burst
        # pages must cover the burst's maximum advance per slot; a dry pool
        # retracts a victim instead of failing anything
        for i in active:
            req = self.slots[i]
            if req is None:  # retracted as a victim earlier in this loop
                continue
            lp_lo = req.seq_len // ps
            lp_hi = min((req.seq_len + adv - 1) // ps, self.max_pages_per_seq - 1)
            for lp in range(lp_lo, lp_hi + 1):
                if self.page_table[i, lp] == 0:
                    pg = self._alloc_or_preempt(req)
                    if pg is None:  # req itself was the retracted victim
                        break
                    req.pages.append(pg)
                    self.page_table[i, lp] = pg
                    self._dirty = True
        active = [i for i, r in enumerate(self.slots) if r is not None and not r.pending]
        if not active:
            return True
        max_seq = max(self.seq_lens[i] for i in active)
        mp = self._pages_bucket(int(max_seq) + adv)
        if self._dirty or self._dstate is None or mp != self._mp_bucket:
            self._upload_state(mp)
        if spec:
            self._dispatch_spec_burst(active)
            return True
        cons = [i for i in active if self.slots[i].sampling.constrained]
        if not cons:
            self._dispatch_burst(active)
            return True
        # segregated constrained decoding: the other rows take their burst on
        # the burst view, then the constrained rows one step on theirs
        if self._dstate_cand is None:
            self._upload_state(mp)
        uncons = [i for i in active if not self.slots[i].sampling.constrained]
        if uncons:
            self._dispatch_burst(uncons)
        self._constrained_step(cons)
        # host-selected tokens must reach the device: re-upload before the
        # next dispatch
        self._dirty = True
        return True

    def _spec_burst_applies(self, active) -> bool:
        """Whether this decode step takes the speculative burst: speculation
        on and not cut off, and every active row greedy with no logprobs,
        penalties, bias or constraint. First the sticky adaptive cutoff: once
        ``spec_min_accept_window`` drafts have run, drafting turns off for
        good when the accepted tokens per drafted token fall below
        ``spec_min_accept``."""
        e = self.ecfg
        k = e.speculative_k
        drafted = self.stats.get("spec_drafted", 0)
        if (k > 0 and e.spec_min_accept > 0.0 and not self._spec_off
                and drafted >= e.spec_min_accept_window):
            rate = self.stats.get("spec_accepted", 0) / (drafted * k)
            if rate < e.spec_min_accept:
                self._spec_off = True
                logger.info("speculative decoding auto-disabled: accept rate %.3f < "
                            "spec_min_accept %.3f over %d drafts", rate, e.spec_min_accept,
                            drafted)
        return k > 0 and not self._spec_off and all(
            s.temperature == 0.0 and s.logprobs_k == 0 and not s.has_penalties
            and not s.has_logit_bias and not s.constrained
            for s in (self.slots[i].sampling for i in active))

    def _dispatch_spec_burst(self, rows):
        """Run one speculative burst on the burst view (always the full K
        steps) and emit each step's accepted tokens + 1; ``spec_drafted``
        counts a row's steps, ``spec_accepted`` its accepted drafts."""
        d_last, d_pt, d_sl, d_seeds, d_ctr, d_sids, d_ring, d_mu = self._dstate
        K = self.ecfg.decode_burst
        room_cap = min(self.ecfg.max_context, self.max_pages_per_seq * self.page_size)
        fn = self._program("decode_spec", K, lambda eng, _K: build_decode_spec(eng))
        (toks, counts), self.pools, d_last, d_sl, self._dhist = fn(
            self.pools, d_last, d_pt, d_sl, d_sids, self._dhist)
        self._dstate = (d_last, d_pt, d_sl, d_seeds, d_ctr, d_sids, d_ring, d_mu)
        self.stats["decode_steps"] += K
        for i in rows:
            req = self.slots[i]
            for step in range(K):
                if req.finished:
                    break
                n = int(counts[step, i])
                self.stats["spec_drafted"] = self.stats.get("spec_drafted", 0) + 1
                self.stats["spec_accepted"] = self.stats.get("spec_accepted", 0) + n - 1
                for j in range(n):
                    if req.finished:
                        break
                    if req.seq_len >= room_cap:
                        self._finish(req, "length")
                        break
                    req.seq_len += 1
                    self.seq_lens[i] = req.seq_len
                    tok = int(toks[step, i, j])
                    self.stats["decode_tokens"] += 1
                    self.slot_counters[i] += 1
                    self._emit_token(req, tok)
                    if not req.finished:
                        self.last_tokens[i] = tok

    def _constrained_step(self, cons):
        """One step of the full-logits program on the constrained rows'
        view; each row's token is re-selected on the host through its
        validator from that row's post-penalty logits (only those rows are
        fetched)."""
        c_last, c_pt, c_sl, c_seeds, c_ctr, c_sids, c_ring, _ = self._dstate_cand
        on = np.zeros((len(self.slots),), bool)
        on[cons] = True
        fn = self._decode_fn(1, return_logits=True)
        (_, logits_d), self.pools, *_ = fn(self.pools, c_last, c_pt, c_sl, c_seeds, c_ctr,
                                           c_sids, c_ring, self._slot_samp(on))
        self.stats["decode_steps"] += 1
        rows = logits_d[0, torch.as_tensor(cons, device=logits_d.device)].cpu().numpy()
        room_cap = min(self.ecfg.max_context, self.max_pages_per_seq * self.page_size)
        for j, i in enumerate(cons):
            req = self.slots[i]
            if req is None or req.finished:
                continue
            if req.seq_len >= room_cap:
                self._finish(req, "length")
                continue
            req.seq_len += 1
            self.seq_lens[i] = req.seq_len
            tok, status = self._select_constrained(req, rows[j])
            if tok is None:  # dead end: no legal continuation
                self._finish_notify(req, "stop")
                continue
            self.stats["decode_tokens"] += 1
            self.slot_counters[i] += 1
            self._emit_token(req, tok)
            if not req.finished and status == "complete":
                self._finish_notify(req, "stop")
            if not req.finished:
                self.last_tokens[i] = tok

    def _dispatch_burst(self, rows):
        """Run one decode burst for ``rows`` on the burst view and emit the
        sampled tokens. A burst with a logprobs row runs the logprobs
        variant, one with a mirostat row the mirostat variant (carrying mu;
        with logprobs too if a logprobs row shares it); otherwise the burst
        shortens (K/2, K/4, ... >= 8) when every row
        finishes within a shorter one."""
        d_last, d_pt, d_sl, d_seeds, d_ctr, d_sids, d_ring, d_mu = self._dstate
        K = self.ecfg.decode_burst
        room_cap = min(self.ecfg.max_context, self.max_pages_per_seq * self.page_size)
        want_lp = any(self.slots[i].sampling.logprobs_k > 0 for i in rows)
        want_miro = any(self.slots[i].sampling.mirostat for i in rows)
        if not want_lp and not want_miro and K > 8:
            rem = 1
            for i in rows:
                r = self.slots[i]
                rem = max(rem, min(r.sampling.max_new_tokens - len(r.output_ids),
                                   room_cap - r.seq_len))
            while K // 2 >= max(8, rem):
                K //= 2
        # only decoding rows sample (the masked rows' tokens are dropped)
        on = np.zeros((len(self.slots),), bool)
        on[rows] = True
        args = (self.pools, d_last, d_pt, d_sl, d_seeds, d_ctr, d_sids, d_ring,
                self._slot_samp(on))
        if want_miro:
            # a logprobs row beside a mirostat row gets its logprobs from the
            # same burst (the reference's engine fails on that mix)
            outs, self.pools, d_last, d_sl, d_ctr, d_ring, d_mu = self._decode_fn(
                K, with_logprobs=want_lp, with_mirostat=True)(*args, d_mu)
        else:
            outs, self.pools, d_last, d_sl, d_ctr, d_ring = self._decode_fn(
                K, with_logprobs=want_lp)(*args)
        self._dstate = (d_last, d_pt, d_sl, d_seeds, d_ctr, d_sids, d_ring, d_mu)
        toks, lp_data = (outs[0], outs[1:]) if want_lp else (outs, None)
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
                self.slot_counters[i] += 1
                lp = None
                if lp_data is not None and req.sampling.logprobs_k > 0:
                    lp = (lp_data[0][k, i], lp_data[1][k, i], lp_data[2][k, i])
                self._emit_token(req, tok, lp)
                if not req.finished:
                    self.last_tokens[i] = tok

    # ------------------------------------------------------------------
    # finishing
    # ------------------------------------------------------------------

    def _emit_token(self, req: Request, tok: int, lp=None):
        if req.first_token_t is None:
            req.first_token_t = time.monotonic()
        req.output_ids.append(tok)
        if lp is not None:
            chosen, tids, tlps = lp
            k = min(req.sampling.logprobs_k, len(tids))
            req.logprobs_seq.append(
                (float(chosen), [(int(tids[j]), float(tlps[j])) for j in range(k)]))
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

    def _finish_notify(self, req: Request, reason: str):
        """Finish without emitting a token (a grammar's dead end or its
        completion): stream consumers still get a final (fin=True) event."""
        req.finish_reason = reason
        req.finished = True
        if req.on_token is not None:
            req.on_token(-1, True)
        self._finish(req, reason)

    def _make_validator(self, s: SamplingParams):
        from .constrained import make_validator

        return make_validator(self, s)

    def _select_constrained(self, req: Request, logits_row: np.ndarray):
        from .constrained import select_constrained

        return select_constrained(self, req, logits_row)

    def _pick_victim(self, prefer_not: Optional[Request] = None) -> Optional[Request]:
        """Retraction victim under page pressure: the occupied slot with the
        most remaining token budget, ties broken toward the youngest arrival;
        ``prefer_not`` itself only when it is the only occupied slot."""
        cands = [r for r in self.slots if r is not None]
        if not cands:
            return None
        others = [r for r in cands if r is not prefer_not]
        return max(others or cands,
                   key=lambda r: (r.sampling.max_new_tokens - len(r.output_ids), r.arrival_t))

    def _alloc_or_preempt(self, req: Request) -> Optional[int]:
        """Allocate one KV page; on a dry pool, retract victims until the
        allocation succeeds. Returns None iff ``req`` itself was the victim."""
        while True:
            try:
                (pg,) = self._alloc_pages(1)
                return pg
            except MemoryError:
                victim = self._pick_victim(prefer_not=req)
                if victim is None:
                    return None
                self._preempt(victim)
                if victim is req:
                    return None

    def _preempt(self, req: Request):
        """Retract ``req`` under page pressure: free its slot and pages (its
        full pages feed the radix tree: they are valid KV for the stream so
        far) and requeue it at the front. Re-admission re-prefills prompt +
        generated tokens (``_start_request`` folds ``output_ids`` in), and
        its sampling counter is counter_base + #sampled, so a seeded stream
        resumes where it stopped; emitted tokens are never emitted again."""
        self._dirty = True
        slot = req.slot
        if slot >= 0 and self.slots[slot] is req:
            self.slots[slot] = None
            self.page_table[slot] = 0
            self.seq_lens[slot] = 0
            self.last_tokens[slot] = 0
        req.slot = -1
        seq_tokens = req.prompt_ids + req.output_ids
        full = req.seq_len // self.page_size
        if self.radix is not None:
            if full > 0:
                all_pages = req.matched_pages + req.pages
                self.radix.insert(seq_tokens[: full * self.page_size], all_pages[:full])
            self.radix.unlock(req.matched_nodes)
        self.allocator.release_all(req.pages)
        req.pages = []
        req.matched_nodes = []
        req.matched_pages = []
        req.matched_tokens = 0
        req.seq_len = 0
        req.pending = []
        self.stats["preemptions"] = self.stats.get("preemptions", 0) + 1
        logger.info("retracted request %d under page pressure (%d tokens generated so far)",
                    req.rid, len(req.output_ids))
        self._requeue(req)

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
