"""Greedy decode throughput of the PyTorch port on one GPU.

Counterpart of the repository's root ``bench.py``: random ternary weights
drawn on the card from a seed, a prompt prefill, then greedy decode: one
eager warm-up step, then the decode window of ``--steps`` steps captured
once in a CUDA graph (``DecodeGraph``), one warm replay and the best of three
timed replays, each ended by the host read of its tokens. The cache holds
prompt + 4 * steps + 8 positions per row, as ``bench.py``'s. Its runs, with
``bench.py``'s defaults:

- ``--batch B`` (``WF_BENCH_BATCH``, default 1): B rows of the same prompt;
  ``tok_s = steps * B / best window``;
- the head: at batch 1 the exact head (int8 scan and top-64 rescore,
  ``--exact-head K`` for another shortlist, ``--exact-head 0`` for none:
  ``WF_BENCH_EXACT_HEAD``, on by default at batch 1 only); ``--int8-logits``
  (``WF_BENCH_INT8_LOGITS``): the argmax of the int8 head; neither: the
  argmax of the bf16 head;
- the linears: ``fuse_projections`` and the fused-prologue kernels
  (``make_linear_fused()``: the attention and MLP blocks as one launch each
  per layer at batch-1 decode; K1's GEMV and K2 at up to 8 rows);
  ``--no-prologue`` (``WF_BENCH_PROLOGUE=0``) keeps the fused projections on
  the stacked linear (K7, ``make_linear_stacked()``), ``--no-fuse``
  (``WF_BENCH_FUSE_PROJ=0``) the unfused ones on it;
- ``--model bitnet2b|llama8b|tiny`` (``WF_BENCH_MODEL``): llama8b is
  ``BitNetConfig.llama3_8b_ternary`` at full size (32 layers, H 4096, I
  14336, 32 query / 8 KV heads, SiLU, no sub-norms, an untied head).

``bench.py`` switches to its XLA path above batch 4 (``WF_BENCH_PALLAS``);
the port has no such path and runs its kernels at every batch (the line's
``kernels_at_every_batch``).

``bench.py`` times its window as one dispatched program, a ``jax.jit`` of a
``lax.scan`` whose head picks its branch on the device (``lax.cond``). Here
the window is one CUDA graph of ``steps`` device steps. Under the exact head
each step's head is ``exact_topk_shortlist``, which writes the shortlist's
tokens and its certificate to the window's buffers without a host read. The
window ends with one host read of the tokens and flags; from the first step
whose certificate failed the window is repaired: that step's tokens become
the full bf16 head's argmax of its stored hidden rows, and the steps after
it run again eagerly (``decode_window``), overwriting the cache rows the
graph wrote. Tokens and cache then equal those of the reference's window.
The argmax heads need no certificate and no repair.

Prints one JSON line with ``bench.py``'s field names, the mode flags,
``captured``, ``repaired_steps`` (over the warm and the timed replays),
``replay_device_ms_per_token`` (CUDA events around the best timed replay,
per step), the card's name and its power limit:

    python -m wrinklefree_tpu_torch.bench.decode [--model bitnet2b|llama8b|tiny]
        [--prompt 64] [--steps 64] [--batch 1] [--exact-head K] [--int8-logits]
        [--no-fuse] [--no-prologue] [--device cuda] [--split] [--layer-mega]
        [--spec K]

``--split`` runs the unrolled decode over ``split_layers_for_decode``'s
per-layer views (``bench.py``'s ``WF_BENCH_SPLIT=1`` at batch 1);
``--layer-mega`` runs one whole-layer kernel per layer
(``make_linear_fused(layer_mega=True)``, the reference's
``WF_LAYER_MEGA=1``). Both are off by default, as in the reference, and take
batch 1 and the fused-prologue linears. ``decode_window`` is the eager
window (one ``forward`` per step, the exact head reading its certificate on
the host every step); the repair runs it.

``--spec K`` adds ``bench.py``'s ``WF_BENCH_SPEC`` metric (batch 1 only, as
there): after the timed windows, a 16-step
``models.spec_decode.spec_decode_window`` (n-gram drafts of K tokens, each
step verified in one K+1-row ``forward`` on the fused kernels: the GEMV and
K2 at K+1 <= 8 rows), one warm call and the best of three timed calls, each
ended by the host read of its counts; it reports ``spec_tok_s``,
``spec_accept_per_step`` (tokens per step) and ``spec_k``. The cache then
holds 4 * 16 * (K+1) more positions, as ``bench.py``'s. Acceptance depends
on how repetitive the output is, so the metric is a workload-dependent
multiplier on the plain one.

Throughput does not depend on the weights' values. ``--device cpu`` runs
the plain versions of the kernels and the window's device steps uncaptured
(a smoke of the path, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..config import BitNetConfig
from ..models.bitnet import (
    KVCache,
    compute_logits,
    exact_topk_shortlist,
    forward,
    full_head_argmax,
    fuse_projections,
    greedy_exact_topk,
    init_params,
    quantize_lm_head,
    resolve_device,
    split_layers_for_decode,
)
from ..models.spec_decode import spec_decode_window
from ..ops.ternary_cuda import make_linear_fused, make_linear_stacked

MODELS = {"bitnet2b": BitNetConfig.bitnet_2b, "llama8b": BitNetConfig.llama3_8b_ternary,
          "tiny": BitNetConfig.tiny}
NAMES = {"bitnet2b": "bitnet-2b", "llama8b": "llama-3-8b", "tiny": "tiny-smoke"}
EXACT_HEAD_K = 64


def prepare_params(params, cfg: BitNetConfig, split: bool = False, *,
                   quantize_head: bool = True, fuse: bool = True):
    """``bench.py``'s params from the model's: the int8 head
    (``quantize_head``: the exact and int8 heads read it), fused projections
    (``fuse``) and the per-layer views of ``split_layers_for_decode``
    (``split``)."""
    if quantize_head:
        params = quantize_lm_head(params, cfg)
    if fuse:
        params = fuse_projections(params, cfg)
    return split_layers_for_decode(params, cfg) if split else params


def bench_params(cfg: BitNetConfig, device, split: bool = False, *, quantize_head: bool = True,
                 fuse: bool = True):
    """Random weights from seed 0 through ``prepare_params``."""
    return prepare_params(init_params(cfg, seed=0, device=device), cfg, split,
                          quantize_head=quantize_head, fuse=fuse)


def bench_linear(prologue: bool = True, layer_mega: bool = False):
    """The decode's linear: the fused-prologue kernels (``make_linear_fused``,
    the batch-1 megakernels) or, without the prologue, the stacked K7."""
    return make_linear_fused(layer_mega=layer_mega) if prologue else make_linear_stacked()


def exact_head(cfg: BitNetConfig, k: int = EXACT_HEAD_K):
    """``forward``'s head_fn: greedy tokens [B, 1] int32 of the exact head."""

    def head_fn(hidden, params):
        return greedy_exact_topk(hidden, params, cfg, k=k)[0][:, None]

    return head_fn


def argmax_head(cfg: BitNetConfig):
    """``forward``'s head_fn: greedy tokens [B, 1] int32, the argmax of
    ``compute_logits`` (the int8 head where the params hold it, else the
    bf16 head), as ``bench.py``'s window without the exact head."""

    def head_fn(hidden, params):
        return torch.argmax(compute_logits(hidden, params, cfg), dim=-1).to(torch.int32)[:, None]

    return head_fn


def greedy_head(cfg: BitNetConfig, k: int):
    """The exact head with a shortlist of ``k`` (k > 0), else the argmax head."""
    return exact_head(cfg, k) if k else argmax_head(cfg)


def prefill(params, cfg, lf, prompt, max_len):
    """Prompt [B, P] -> (first tokens [B, 1], cache). The prompt's logits go
    through ``compute_logits`` (the int8 head where the params hold it), as
    in ``bench.py``."""
    dev = prompt.device
    b = prompt.shape[0]
    cache = KVCache.zeros(cfg, b, max_len, device=dev)
    logits, cache = forward(params, cfg, prompt, cache, torch.zeros(b, dtype=torch.int32,
                                                                    device=dev),
                            linear_fn=lf, logits_all=False)
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache


def _host(toks: torch.Tensor) -> torch.Tensor:
    """Window tokens [steps, B] on the host, [steps] at batch 1."""
    return toks[:, 0] if toks.shape[1] == 1 else toks


def decode_window(params, cfg, lf, tok, cache, pos, steps, head_fn):
    """``steps`` greedy decode steps from tokens ``tok`` [B, 1] at device
    positions ``pos`` ([B] int32); returns (tokens [steps, B] on the host,
    [steps] at batch 1; last tokens; cache; next positions). The host read
    of the tokens ends the window."""
    outs = []
    for _ in range(steps):
        tok, cache = forward(params, cfg, tok, cache, pos, linear_fn=lf, logits_all=False,
                             head_fn=head_fn)
        outs.append(tok[:, 0])
        pos = pos + 1
    return _host(torch.stack(outs).cpu()), tok, cache, pos


class DecodeGraph:
    """The greedy decode window of ``steps`` device steps over one cache of
    B rows, as one CUDA graph (``bench.py``'s ``lax.scan`` window).

    A device step is ``forward`` with a head that reads nothing on the host:
    under the exact head (``k`` > 0) ``exact_topk_shortlist``, which writes
    the shortlist's tokens, its certificate and the post-norm hidden rows
    into the window's static buffers; with ``k`` = 0 the argmax of
    ``compute_logits``, whose steps need no certificate. ``rec`` [B + 1,
    steps] int32 holds each row's tokens, then the flags (1 where no
    certificate is needed); ``hidden`` [steps * B, H] the hidden rows of
    step i at i * B. Each step's tokens feed the next. The inputs are the
    static ``tok`` [B, 1] and ``pos`` [B] int32 and the cache, which the steps
    update in place; ``run`` copies the tokens and positions in, replays,
    and ends with ``finish``.

    ``capture`` records the graph after one uncaptured ``warm_up`` step (CUDA
    only: on a CPU cache both raise); a host read inside the steps fails the
    capture. On the CPU ``run`` runs the same steps uncaptured; on the card
    it runs only a captured window. The kernel wrappers'
    launch counters move when the steps are recorded, not when they are
    replayed."""

    def __init__(self, params, cfg: BitNetConfig, lf, cache: KVCache, steps: int,
                 k: int = EXACT_HEAD_K):
        if steps < 1:
            raise ValueError("a decode window needs at least one step")
        dev = cache.k.device
        self.params, self.cfg, self.lf, self.cache, self.steps, self.k = (
            params, cfg, lf, cache, steps, k)
        self.batch = b = cache.k.shape[1] if cache.k.dim() == 5 else 1
        self.tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.rec = torch.zeros((b + 1, steps), dtype=torch.int32, device=dev)
        self.rec[b] = 1
        self.hidden = torch.zeros((steps * b, cfg.hidden_size), dtype=cfg.dtype, device=dev)
        self.graph, self.stream, self.warm = None, None, False
        self.replay_ms = None  # CUDA-event time of the last replay

    def _step(self, tok, i):
        b = self.batch

        def head(hidden, params):
            if self.k:
                self.hidden[i * b:(i + 1) * b].copy_(hidden)
                minid, certified = exact_topk_shortlist(hidden, params, self.cfg, self.k)
                self.rec[b, i].copy_(certified)
            else:
                minid = torch.argmax(compute_logits(hidden, params, self.cfg), dim=-1)
            self.rec[:b, i].copy_(minid)
            return minid.to(torch.int32)[:, None]

        tok, _ = forward(self.params, self.cfg, tok, self.cache, self.pos + i, linear_fn=self.lf,
                         logits_all=False, head_fn=head)
        return tok

    def _steps(self):
        tok = self.tok
        for i in range(self.steps):
            tok = self._step(tok, i)

    def _cuda(self, what):
        dev = self.cache.k.device
        if dev.type != "cuda":
            raise ValueError(f"DecodeGraph.{what} needs a CUDA cache; on the CPU call run() on "
                             "a window that was not captured")
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        return dev

    def warm_up(self, tok, pos):
        """One uncaptured device step from (tok, pos) on the capture stream:
        it builds the kernel library and sets the kernels' attributes before
        the capture. It writes cache row ``pos`` as the first step of a
        replay from (tok, pos) does."""
        dev = self._cuda("warm_up")
        self.tok.copy_(tok)
        self.pos.copy_(pos)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            self._step(self.tok, 0)
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        self.warm = True

    def capture(self, tok, pos):
        """Record the window (after ``warm_up`` from (tok, pos) unless it ran);
        returns the window."""
        self._cuda("capture")
        if not self.warm:
            self.warm_up(tok, pos)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            self._steps()
        self.graph = graph
        return self

    def run(self, tok, pos):
        """The window from tokens ``tok`` [B, 1] at device positions ``pos``
        [B]: the replay (or the uncaptured steps), then ``finish``. Returns
        (tokens [steps, B] on the host, [steps] at batch 1; last tokens [B,
        1]; cache; next positions; repaired steps). On the card the window
        runs only as its graph."""
        if self.graph is None and self.cache.k.device.type == "cuda":
            raise RuntimeError("DecodeGraph.run on a CUDA cache needs capture() first")
        self.tok.copy_(tok)
        self.pos.copy_(pos)
        if self.graph is None:
            self._steps()
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.graph.replay()
            end.record()
        out = self.finish(pos)
        if self.graph is not None:
            self.replay_ms = start.elapsed_time(end)  # complete: finish read the tokens
        return out

    def finish(self, pos):
        """The host read of the window's tokens and flags, and the repair
        from the first step whose certificate failed: its tokens are the
        full bf16 head's argmax of its stored hidden rows, and the steps
        after it run again eagerly, overwriting the cache rows the window
        wrote. The returned tokens ([steps, B], [steps] at batch 1) and cache
        equal those of the reference's window."""
        b = self.batch
        rec = self.rec.cpu()  # the one host read
        toks, failed = rec[:b].t().clone(), (rec[b] == 0).nonzero()
        last = self.rec[:b, -1:].clone()
        if len(failed) == 0:
            return _host(toks), last, self.cache, pos + self.steps, 0
        i = int(failed[0, 0])
        last = full_head_argmax(self.hidden[i * b:(i + 1) * b], self.params, self.cfg)[:, None]
        toks[i] = last[:, 0].cpu()
        if i + 1 < self.steps:
            rest, last, _, _ = decode_window(
                self.params, self.cfg, self.lf, last, self.cache, pos + i + 1,
                self.steps - i - 1, exact_head(self.cfg, self.k))
            toks[i + 1:] = rest.view(-1, b)
        return _host(toks), last, self.cache, pos + self.steps, self.steps - i


SPEC_WINDOW = 16  # bench.py's spec window (steps)


def spec_bench(params, cfg, lf, tok, cache, pos, prompt_len, k, sync=lambda: None) -> dict:
    """``bench.py``'s speculative metric from the bench's state after its
    timed windows: the history holds the prompt (token 1, as the bench's
    prompt) and the current token at ``pos``; one warm ``spec_decode_window``
    of ``SPEC_WINDOW`` steps, then the best of three, each ended by the host
    read of its counts."""
    dev = tok.device
    hist = torch.zeros((1, cache.k.shape[2]), dtype=torch.int32, device=dev)  # [1, T]
    hist[:, :prompt_len] = 1
    hist[0, int(pos[0])] = tok[0, 0]
    last, start = tok[:, 0].to(torch.int32), pos.to(torch.int32)
    kw = dict(steps=SPEC_WINDOW, k=k, linear_fn=lf)
    _, counts, last, cache, start, hist = spec_decode_window(params, cfg, last, cache, start,
                                                             hist, **kw)
    counts.cpu()  # warm
    best, tokens = float("inf"), 0
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        _, counts, last, cache, start, hist = spec_decode_window(params, cfg, last, cache, start,
                                                                 hist, **kw)
        c = counts.cpu()
        dt = time.perf_counter() - t0
        if dt < best:
            best, tokens = dt, int(c.sum())
    return {"spec_tok_s": tokens / best, "spec_accept_per_step": tokens / SPEC_WINDOW,
            "spec_k": k}


def card_info(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    name, limit = (s.strip() for s in smi.stdout.strip().split(","))
    return {"device_name": name, "power_limit": limit}


def run(model: str = "bitnet2b", prompt_len: int = 64, steps: int = 64, device=None,
        split: bool = False, layer_mega: bool = False, spec: int = 0, batch: int = 1,
        int8_logits: bool = False, exact_head_k=None, fuse: bool = True,
        prologue: bool = True) -> dict:
    """The benchmark; returns the result line as a dict. ``exact_head_k``
    None takes ``bench.py``'s default: 64 at batch 1, else 0 (off)."""
    if exact_head_k is None:
        exact_head_k = EXACT_HEAD_K if batch == 1 else 0
    prologue = prologue and fuse
    if (split or layer_mega) and not (batch == 1 and prologue):
        raise ValueError("--split and --layer-mega take batch 1 and the fused-prologue linears")
    if spec and batch != 1:
        raise ValueError("--spec takes batch 1, as bench.py's WF_BENCH_SPEC")
    dev = resolve_device(device)
    cfg = MODELS[model]()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    params = bench_params(cfg, dev, split, quantize_head=bool(int8_logits or exact_head_k),
                          fuse=fuse)
    sync()
    init_s = time.perf_counter() - t0
    lf = bench_linear(prologue, layer_mega)
    head_fn = greedy_head(cfg, exact_head_k)
    max_len = prompt_len + 4 * steps + 8
    if spec:
        max_len += 4 * SPEC_WINDOW * (spec + 1)  # spec windows write k+1 rows a step
    prompt = torch.ones((batch, prompt_len), dtype=torch.long, device=dev)

    t0 = time.perf_counter()
    tok, cache = prefill(params, cfg, lf, prompt, max_len)
    tok.cpu()
    prefill_s = time.perf_counter() - t0  # includes the kernels' build on first use

    pos = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)
    _, tok, cache, pos = decode_window(params, cfg, lf, tok, cache, pos, 1, head_fn)
    graph = DecodeGraph(params, cfg, lf, cache, steps, k=exact_head_k)
    if dev.type == "cuda":
        graph.capture(tok, pos)
    _, tok, cache, pos, repaired = graph.run(tok, pos)
    best, replay_ms = float("inf"), None
    for _ in range(3):
        t0 = time.perf_counter()
        _, tok, cache, pos, rep = graph.run(tok, pos)
        dt = time.perf_counter() - t0
        repaired += rep
        if dt < best:
            best, replay_ms = dt, graph.replay_ms
    result = {
        "metric": f"{NAMES[model]} ternary decode throughput (batch {batch}, greedy)",
        "value": steps * batch / best,
        "unit": "tok/s",
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "int8_logits": int8_logits,
        "ms_per_token": best / steps * 1e3,
        "fused_window_steps": steps,
        "prefill_first_call_s": prefill_s,
        "param_init_s": init_s,
        "batch": batch,
        "exact_head_k": exact_head_k,
        "fuse_proj": fuse,
        "prologue": prologue,
        "kernels_at_every_batch": True,
        "split": split,
        "layer_mega": layer_mega,
        "captured": graph.graph is not None,
        "repaired_steps": repaired,
        "replay_device_ms_per_token": None if replay_ms is None else replay_ms / steps,
    }
    if spec:
        result.update(spec_bench(params, cfg, lf, tok, cache, pos, prompt_len, spec, sync))
    if dev.type == "cuda":
        result.update(card_info(dev))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="bitnet2b")
    ap.add_argument("--prompt", type=int, default=64, help="prompt tokens")
    ap.add_argument("--steps", type=int, default=64, help="decode steps per window")
    ap.add_argument("--batch", type=int, default=1, help="rows decoded at once")
    ap.add_argument("--exact-head", type=int, default=None, metavar="K",
                    help="the exact head's shortlist (0: off; default 64 at batch 1, else 0)")
    ap.add_argument("--int8-logits", action="store_true",
                    help="greedy tokens from the int8 head (approximate)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="unfused projections on the stacked linear (K7)")
    ap.add_argument("--no-prologue", action="store_true",
                    help="fused projections on the stacked linear (K7), no fused prologue")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--split", action="store_true",
                    help="unrolled decode over split_layers_for_decode's per-layer views")
    ap.add_argument("--layer-mega", action="store_true",
                    help="one whole-layer kernel per layer at decode")
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="add the speculative window's metric with K-token drafts")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.model, a.prompt, a.steps, a.device, a.split, a.layer_mega, a.spec,
                         a.batch, a.int8_logits, a.exact_head, not a.no_fuse,
                         not a.no_prologue)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
