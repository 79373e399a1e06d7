"""The decode bench's runs (``wrinklefree_tpu_torch/bench/decode.py``, the
counterpart of ``bench.py``'s ``WF_BENCH_*`` runs) against the JAX reference
on the CPU.

Each mode builds its params and linear as the bench does
(``prepare_params``, ``bench_linear``), prefills a prompt per row, takes one
eager step and then the bench's window (``DecodeGraph``, uncaptured here:
its device steps and, under the exact head, the repair). The reference runs
``bench.py``'s window on the same weights: its ``forward`` with the same
head (the exact head, or the argmax of ``compute_logits`` over the int8 or
the bf16 head) and the same linear in interpret mode (the fused prologue
with its batch-1 megakernels, or the stacked linear over fused or unfused
projections), one ``lax.scan`` of greedy steps. Greedy tokens must be equal
up to a first parting, which may come only at a near-tie of the
reference's own logits for that head (``NEAR_TIE``, tests/test_torch_engine.py).

The ``silu`` mode stands in for llama8b's layout (a SiLU gate, no
sub-norms, an untied head) at the tiny widths. The port runs the plain
versions of its kernels, which its wrappers take for CPU tensors; the
captured windows run on the card (chip_smoke.py, PERF.md).
"""

import dataclasses
import functools
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.models import bitnet as rb
from wrinklefree_tpu.ops import ternary_pallas as ref_tp
from wrinklefree_tpu_torch.bench import decode as bd
from wrinklefree_tpu_torch.config import BitNetConfig
from wrinklefree_tpu_torch.weights import params_from_numpy

NEAR_TIE = 6e-2
P, T, STEPS = 5, 32, 6
HEAD_GAIN = 4.0  # widens the top logits' gaps (tests/test_torch_decode_window.py)

# name: (batch, exact-head k, int8 logits, fuse, prologue, llama-like layout)
MODES = {
    "batch2": (2, 0, False, True, True, False),
    "batch4": (4, 0, False, True, True, False),
    "batch2_exact": (2, 16, False, True, True, False),
    "int8_logits": (1, 0, True, True, True, False),
    "int8_logits_batch2": (2, 0, True, True, True, False),
    "exact_head_0": (1, 0, False, True, True, False),
    "no_fuse": (1, 16, False, False, False, False),
    "no_prologue": (1, 16, False, True, False, False),
    "silu": (1, 16, False, True, True, True),
    "silu_batch2": (2, 0, False, True, True, True),
}


def _configs(llama: bool):
    if llama:  # llama3_8b_ternary's layout at the tiny widths
        kw = dict(mlp_act="silu", sub_norms=False, tie_word_embeddings=False)
        return dataclasses.replace(RefConfig.tiny(), **kw), dataclasses.replace(
            BitNetConfig.tiny(), **kw)
    return RefConfig.tiny(), BitNetConfig.tiny()


@functools.lru_cache(maxsize=None)
def _weights(llama: bool):
    """The reference's weights (numpy), the head scaled by HEAD_GAIN."""
    rcfg, _ = _configs(llama)
    raw = rb.init_params(rcfg, seed=3)
    name = "lm_head" if "lm_head" in raw else "embed"
    raw = {**raw, name: (raw[name].astype(jnp.float32) * HEAD_GAIN).astype(rcfg.dtype)}
    return jax.tree.map(np.asarray, raw)


def _prompts(batch):
    rng = np.random.default_rng(batch)
    return rng.integers(1, BitNetConfig.tiny().vocab_size, (batch, P)).astype(np.int32)


def _reference(mode):
    """bench.py's prefill and window in this mode: (tokens [STEPS, B], the
    top-2 gap of the deciding head's logits at each step [STEPS, B])."""
    batch, k, int8, fuse, prologue, llama = MODES[mode]
    rcfg, _ = _configs(llama)
    params = jax.tree.map(jnp.asarray, _weights(llama))
    if int8 or k:
        params = rb.quantize_lm_head(params, rcfg)
    if fuse:
        params = rb.fuse_projections(params, rcfg)
    lf = (ref_tp.make_pallas_linear_fused(interpret=True, mega=True) if prologue
          else ref_tp.make_pallas_linear_stacked(interpret=True))
    bf16_head = {n: params[n] for n in ("embed", "lm_head") if n in params}

    def head_fn(h, p):
        deciding = p if int8 else bf16_head  # the int8 head's logits, else the bf16 head's
        if k:
            tok = rb.greedy_exact_topk(h, p, rcfg, k=k)[0]
        else:
            tok = jnp.argmax(rb.compute_logits(h, deciding, rcfg), axis=-1)
        top2 = jax.lax.top_k(rb.compute_logits(h, deciding, rcfg), 2)[0]
        return tok.astype(jnp.int32), top2[:, 0] - top2[:, 1]

    @jax.jit
    def window(params, tok, cache, start):
        def step(carry, _):
            tok, cache, pos = carry
            (nxt, gap), cache = rb.forward(params, rcfg, tok, cache, pos, logits_all=False,
                                           linear_fn=lf, head_fn=head_fn)
            return (nxt[:, None], cache, pos + 1), (nxt, gap)

        _, out = jax.lax.scan(step, (tok, cache, start), None, length=STEPS + 1)
        return out

    cache = rb.KVCache.zeros(rcfg, batch, T)
    logits, cache = rb.forward(params, rcfg, jnp.asarray(_prompts(batch)), cache,
                               jnp.zeros((batch,), jnp.int32), linear_fn=lf, logits_all=False)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    toks, gaps = window(params, tok, cache, jnp.full((batch,), P, jnp.int32))
    return np.asarray(toks), np.asarray(gaps)  # the eager step, then the window's


def _port(mode):
    batch, k, int8, fuse, prologue, llama = MODES[mode]
    _, cfg = _configs(llama)
    params = bd.prepare_params(params_from_numpy(_weights(llama), cfg, device="cpu"), cfg,
                               quantize_head=bool(int8 or k), fuse=fuse)
    lf = bd.bench_linear(prologue)
    tok, cache = bd.prefill(params, cfg, lf, torch.from_numpy(_prompts(batch)).long(), T)
    pos = torch.full((batch,), P, dtype=torch.int32)
    first, tok, cache, pos = bd.decode_window(params, cfg, lf, tok, cache, pos, 1,
                                              bd.greedy_head(cfg, k))
    win = bd.DecodeGraph(params, cfg, lf, cache, STEPS, k=k)
    toks, last, _, nxt, _ = win.run(tok, pos)
    toks = toks.view(STEPS, batch)
    assert torch.equal(last[:, 0], toks[-1]) and torch.equal(nxt, pos + STEPS)
    return torch.cat([first.view(1, batch), toks]).numpy()


@pytest.mark.parametrize("mode", list(MODES))
def test_bench_mode_tokens_match_reference(mode):
    """Each row's greedy tokens (the eager step, then the window) equal the
    reference's up to a first parting, which may come only where the
    reference's top-2 logits of the deciding head are closer than NEAR_TIE."""
    got = _port(mode)
    want, gaps = _reference(mode)
    assert got.shape == want.shape
    for b in range(got.shape[1]):
        for i, (a, w) in enumerate(zip(got[:, b], want[:, b])):
            if a != w:
                assert gaps[i, b] < NEAR_TIE, f"row {b}, step {i}: parted off a near-tie"
                break


def test_bench_line_carries_the_modes():
    """``python -m wrinklefree_tpu_torch.bench.decode --model tiny --device
    cpu`` with the new flags: tok/s counts every row, the line names the
    batch, head and linears, and the modes bench.py refuses to mix raise."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert bd.main(["--model", "tiny", "--device", "cpu", "--prompt", "4", "--steps", "3",
                        "--batch", "2", "--int8-logits", "--no-prologue"]) == 0
    res = json.loads(buf.getvalue())
    assert res["batch"] == 2 and res["exact_head_k"] == 0 and res["int8_logits"]
    assert res["fuse_proj"] and not res["prologue"] and res["kernels_at_every_batch"]
    assert "(batch 2, greedy)" in res["metric"]
    assert res["value"] == pytest.approx(3 * 2 / (res["ms_per_token"] * 3 / 1e3))
    with pytest.raises(ValueError, match="batch 1"):
        bd.run("tiny", 4, 3, "cpu", split=True, batch=2)
    with pytest.raises(ValueError, match="batch 1"):
        bd.run("tiny", 4, 3, "cpu", spec=2, batch=2)
    assert bd.MODELS["llama8b"]() == BitNetConfig.llama3_8b_ternary()
