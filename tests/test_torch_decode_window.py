"""The port's one-program batch-1 decode window vs the JAX reference, on the CPU.

  exact_topk_shortlist, full_head_argmax  vs models.bitnet.greedy_exact_topk
  bench.decode.DecodeGraph (device steps  vs bench.decode.decode_window (eager) and
    uncaptured, then the repair)            bench.py's window: a jax.lax.scan over the
                                            reference's forward + greedy_exact_topk

The window runs in the bench's three modes (the K5 + K2 pair, the unrolled
split path, the layer megakernel) under three heads: the int8 head as
quantized (it certifies every step here), a head whose certificate always
fails (one vocabulary row with zero int8 codes and a large scale, which
pushes the error bound above any margin; the other rows' codes negated, so
that the shortlist's winner is wrong) and a head whose certificate fails
from a step inside the window (that row's scale chosen between the steps'
margins). The greedy tokens do not depend on the head: the exact head
always gives the bf16 head's argmax.

Both packages run on identical weights: the reference's ``init_params``
carried over with ``params_from_numpy``. The port runs the plain versions
of its kernels, which its wrappers take for CPU tensors; the captured graph
itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
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
from wrinklefree_tpu_torch.models import bitnet as tb
from wrinklefree_tpu_torch.ops import ternary_cuda
from wrinklefree_tpu_torch.weights import params_from_numpy

# A divergence of greedy tokens is accepted only at a near-tie: where the
# reference's own top-2 logits are closer than this (tests/test_torch_engine.py).
NEAR_TIE = 6e-2

MODES = ["default", "split", "layer_mega"]
HEADS = ["certifies", "never", "partly"]
PROMPT = np.asarray([[3, 1, 4, 1, 5, 9]], np.int32)
# the window's first token: from it, the steps' certificate margins are not
# smallest at step 0, so a head can fail first inside the window
TOK0, T, STEPS, K = 11, 32, 8, 16
ZERO_ROW = -1  # the vocabulary row whose int8 codes the uncertifiable heads zero
EMBED_GAIN = 4.0


def bf16_np(x):
    """Round to bf16 and back to f32 (numpy)."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def with_head(np_params, scale, negate=False):
    """The reference's quantized params (numpy) with ZERO_ROW's int8 codes
    zeroed and its scale set to ``scale`` (None: unchanged); with ``negate``
    every other row's int8 codes change sign, so the int8 scan shortlists
    the worst rows. The bf16 head, and so every greedy token, stays as it
    is."""
    if scale is None:
        return np_params
    q, s = np_params["lm_head_q"].copy(), np_params["lm_head_s"].copy()
    if negate:
        q = -q
    q[ZERO_ROW] = 0
    s[ZERO_ROW] = scale
    return {**np_params, "lm_head_q": q, "lm_head_s": s}


# ---------------------------------------------------------------------------
# (a) the exact head, split at the reference's lax.cond
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def head_params():
    rcfg = RefConfig.tiny(vocab_size=512)
    rq = rb.quantize_lm_head(rb.init_params(rcfg, seed=0), rcfg)
    tq = params_from_numpy(jax.tree.map(np.asarray, rq), BitNetConfig.tiny(vocab_size=512),
                           device="cpu")
    return rcfg, rq, tq


@pytest.mark.parametrize("k,scale", [(16, 1.0), (1, 0.05)], ids=["certified", "fallback"])
def test_shortlist_and_full_head_match_reference(head_params, k, scale):
    """``exact_topk_shortlist`` gives the reference's certificate and, where
    it holds, the reference's token; ``full_head_argmax`` gives the
    reference's token on both branches. k = 16 at unit hiddens certifies,
    k = 1 at small hiddens fails (tests/test_torch_batch1.py's cases)."""
    rcfg, rq, tq = head_params
    cfg = BitNetConfig.tiny(vocab_size=512)
    rng = np.random.default_rng(int(k))
    flags = []
    for _ in range(8):
        h = bf16_np(rng.normal(0, 1, (4, cfg.hidden_size)) * scale)
        want, ref_cert = rb.greedy_exact_topk(jnp.asarray(h, jnp.bfloat16), rq, rcfg, k=k)
        th = torch.from_numpy(h.copy()).to(torch.bfloat16)
        minid, certified = tb.exact_topk_shortlist(th, tq, cfg, k=k)
        assert certified.dim() == 0 and certified.dtype == torch.bool
        assert bool(certified) == bool(ref_cert)
        if bool(certified):
            assert np.array_equal(minid.numpy(), np.asarray(want))
        full = tb.full_head_argmax(th, tq, cfg)
        assert full.dtype == torch.int32
        assert np.array_equal(full.numpy(), np.asarray(want))
        got, cert2 = tb.greedy_exact_topk(th, tq, cfg, k=k)
        assert np.array_equal(got.numpy(), np.asarray(want)) and bool(cert2) == bool(certified)
        flags.append(bool(certified))
    # each case holds its branch on most calls
    assert sum(flags) >= 6 if k == 16 else sum(flags) <= 2


# ---------------------------------------------------------------------------
# the window: the port's device steps + repair, its eager window, bench.py's
# ---------------------------------------------------------------------------


def _configs(dtype):
    if dtype == "f32":
        return (dataclasses.replace(RefConfig.tiny(), dtype=jnp.float32),
                dataclasses.replace(BitNetConfig.tiny(), dtype=torch.float32))
    return RefConfig.tiny(), BitNetConfig.tiny()


@functools.lru_cache(maxsize=None)
def _raw(dtype):
    """The reference's quantized params as numpy: fused for the bf16 modes'
    kernels, unfused for the f32 default linear (no fused kernel takes f32).
    The tied embedding is scaled by EMBED_GAIN, which widens the gaps
    between the top logits (at N(0, 0.02) the tiny model's top-2 gaps sit
    about the near-tie bar, which would excuse most splits)."""
    rcfg, _ = _configs(dtype)
    raw = rb.init_params(rcfg, seed=2)
    raw = {**raw, "embed": (raw["embed"].astype(jnp.float32) * EMBED_GAIN).astype(rcfg.dtype)}
    rq = rb.quantize_lm_head(raw, rcfg)
    if dtype == "bf16":
        rq = rb.fuse_projections(rq, rcfg)
    return jax.tree.map(np.asarray, rq)


def _port(np_params, cfg, mode):
    p = params_from_numpy(np_params, cfg, device="cpu")
    return tb.split_layers_for_decode(p, cfg) if mode == "split" else p


def _port_lf(dtype, mode):
    return None if dtype == "f32" else ternary_cuda.make_linear_fused(
        layer_mega=mode == "layer_mega")


def _port_start(params, cfg, lf):
    """The prompt's cache (its logits are not used) and the window's start."""
    cache = tb.KVCache.zeros(cfg, 1, T, device="cpu")
    _, cache = tb.forward(params, cfg, torch.from_numpy(PROMPT), cache,
                          torch.zeros(1, dtype=torch.int32), linear_fn=lf, logits_all=False)
    return (torch.tensor([[TOK0]], dtype=torch.int32), cache,
            torch.tensor([PROMPT.shape[1]], dtype=torch.int32))


def _device_window(params, cfg, lf, k=K):
    """The port's window as the card runs it, uncaptured: (tokens, cache,
    repaired steps, the window's certificate flags before the repair, the
    window)."""
    tok, cache, pos = _port_start(params, cfg, lf)
    win = bd.DecodeGraph(params, cfg, lf, cache, STEPS, k=k)
    toks, last, cache, nxt, repaired = win.run(tok, pos)
    assert int(nxt) == PROMPT.shape[1] + STEPS and int(last) == int(toks[-1])
    return toks, cache, repaired, win.rec[1].clone(), win


def _eager_window(params, cfg, lf, k=K):
    tok, cache, pos = _port_start(params, cfg, lf)
    toks, _, cache, _ = bd.decode_window(params, cfg, lf, tok, cache, pos, STEPS,
                                         bd.exact_head(cfg, k))
    return toks, cache


@functools.lru_cache(maxsize=None)
def _partial_scale(dtype):
    """ZERO_ROW's scale for the head that certifies some steps but not all:
    chosen from the hiddens of the default mode's window (the steps' hiddens
    do not depend on the head) so that step 0 certifies and a later step
    fails. Certification is monotone in the scale (it raises the error
    bound's s_max), so the first such scale on a rising grid is taken."""
    rcfg, cfg = _configs(dtype)
    params = _port(_raw(dtype), cfg, "default")
    *_, win = _device_window(params, cfg, _port_lf(dtype, "default"))
    hidden = win.hidden.clone()
    base = float(params["lm_head_s"].max())
    for scale in base * np.geomspace(1.0, 1e6, 241)[1:]:
        p = params_from_numpy(with_head(_raw(dtype), scale), cfg, device="cpu")
        flags = [bool(tb.exact_topk_shortlist(hidden[i:i + 1], p, cfg, K)[1])
                 for i in range(STEPS)]
        if flags[0] and not all(flags):
            return float(scale)
    raise AssertionError("no scale certifies step 0 and fails a later step")


def _head(dtype, head):
    """The reference's quantized params (numpy) under each head: as
    quantized; never certifying, with the int8 scan also turned upside down
    (its shortlist's winner is then wrong, and only the full head gives the
    token); certifying the first steps."""
    raw = _raw(dtype)
    if head == "partly":
        return with_head(raw, _partial_scale(dtype))
    return raw if head == "certifies" else with_head(raw, 1e6, negate=True)


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("mode", MODES)
def test_device_window_equals_eager_window(mode, head):
    """(b) The window's device steps (no host read) plus the repair give the
    eager window's tokens and cache bit for bit, in every mode and under
    every head. The certifying head repairs nothing; the never-certifying
    head repairs from step 0; the partly certifying head from a step inside
    the window."""
    _, cfg = _configs("bf16")
    params = _port(_head("bf16", head), cfg, mode)
    lf = _port_lf("bf16", mode)
    toks, cache, repaired, flags, _ = _device_window(params, cfg, lf)
    want, wcache = _eager_window(params, cfg, lf)
    assert torch.equal(toks, want)
    assert torch.equal(cache.k, wcache.k) and torch.equal(cache.v, wcache.v)
    first_fail = STEPS - repaired
    if head == "certifies":
        assert repaired == 0 and bool(flags.all())
    elif head == "never":
        assert repaired == STEPS and not bool(flags.any())
    else:
        assert 0 < first_fail < STEPS, repaired  # the repair starts mid-window
        assert bool(flags[:first_fail].all()) and not bool(flags[first_fail])


def _ref_window(rcfg, lf, steps):
    """bench.py's window (bench.py:151-163): one jax.jit of a lax.scan over
    the reference's forward + greedy_exact_topk. Each step also returns the
    top-2 gap of the bf16 head's logits, for the near-tie rule."""

    def head_fn(h, p):
        tok = rb.greedy_exact_topk(h, p, rcfg, k=K)[0]
        top2 = jax.lax.top_k(rb.compute_logits(h, {"embed": p["embed"]}, rcfg), 2)[0]
        return tok, top2[:, 0] - top2[:, 1]

    def _greedy(params, tok, cache, start):
        (out, gap), cache = rb.forward(params, rcfg, tok, cache, start, logits_all=False,
                                       linear_fn=lf, head_fn=head_fn)
        return out.astype(jnp.int32)[:, None], gap, cache

    @jax.jit
    def window(params, tok, cache, start):
        def step(carry, _):
            tok, cache, pos = carry
            nxt, gap, cache = _greedy(params, tok, cache, pos)
            return (nxt, cache, pos + 1), (nxt[:, 0], gap)

        (tok, cache, _), (toks, gaps) = jax.lax.scan(step, (tok, cache, start), None,
                                                     length=steps)
        return toks, gaps

    def run(params):
        cache = rb.KVCache.zeros(rcfg, 1, T)
        _, cache = rb.forward(params, rcfg, jnp.asarray(PROMPT), cache,
                              jnp.zeros((1,), jnp.int32), linear_fn=lf, logits_all=False)
        toks, gaps = window(params, jnp.full((1, 1), TOK0, jnp.int32), cache,
                            jnp.full((1,), PROMPT.shape[1], jnp.int32))
        return np.asarray(toks)[:, 0], np.asarray(gaps)[:, 0]

    return run


@functools.lru_cache(maxsize=None)
def _ref_runner(dtype, mode):
    rcfg, _ = _configs(dtype)
    lf = None if dtype == "f32" else ref_tp.make_pallas_linear_fused(interpret=True, mega=True)
    return _ref_window(rcfg, lf, STEPS)


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("mode", MODES)
def test_device_window_matches_reference_window_bf16(mode, head, monkeypatch):
    """(c) bf16, the bench's modes against the reference's window in the same
    mode (its kernels in interpret mode; ``WF_LAYER_MEGA=1`` for the layer
    megakernel, as tests/test_pallas_kernels.py sets it): equal greedy
    tokens up to the first split, which may come only at a near-tie of the
    reference's bf16 logits."""
    rcfg, cfg = _configs("bf16")
    monkeypatch.setenv("WF_LAYER_MEGA", "1" if mode == "layer_mega" else "0")
    raw = _head("bf16", head)
    rparams = jax.tree.map(jnp.asarray, raw)
    if mode == "split":
        rparams = rb.split_layers_for_decode(rparams, rcfg)
    want, gaps = _ref_runner("bf16", mode)(rparams)
    toks, *_ = _device_window(_port(raw, cfg, mode), cfg, _port_lf("bf16", mode))
    for i, (a, b) in enumerate(zip(toks.tolist(), want.tolist())):
        if a != b:
            assert gaps[i] < NEAR_TIE, f"step {i}: tokens differ off a near-tie ({gaps[i]})"
            break


@pytest.mark.parametrize("head", HEADS)
def test_device_window_matches_reference_window_f32(head):
    """(c) f32 through the default (plain) linear on both sides: the window's
    tokens equal the reference's lax.scan window's, and the eager window's."""
    rcfg, cfg = _configs("f32")
    raw = _head("f32", head)
    want, _ = _ref_runner("f32", "default")(jax.tree.map(jnp.asarray, raw))
    params = _port(raw, cfg, "default")
    toks, cache, repaired, *_ = _device_window(params, cfg, None)
    assert np.array_equal(toks.numpy(), want)
    eager, wcache = _eager_window(params, cfg, None)
    assert torch.equal(toks, eager) and torch.equal(cache.k, wcache.k)
    assert (repaired == 0) if head == "certifies" else (
        repaired == STEPS if head == "never" else 0 < repaired < STEPS)


def test_capture_refuses_a_cpu_cache():
    """The captured window is CUDA only: on a CPU cache ``capture`` raises
    (the CPU runs the same steps uncaptured through ``run``)."""
    _, cfg = _configs("bf16")
    params = _port(_raw("bf16"), cfg, "default")
    tok, cache, pos = _port_start(params, cfg, _port_lf("bf16", "default"))
    win = bd.DecodeGraph(params, cfg, _port_lf("bf16", "default"), cache, STEPS, k=K)
    with pytest.raises(ValueError, match="CUDA"):
        win.capture(tok, pos)
    with pytest.raises(ValueError):
        bd.DecodeGraph(params, cfg, None, cache, 0)


def test_bench_decode_window_fields():
    """``python -m wrinklefree_tpu_torch.bench.decode --model tiny --device
    cpu``: the window is not captured on the CPU, and the line carries the
    captured window's fields."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert bd.main(["--model", "tiny", "--device", "cpu", "--prompt", "4", "--steps", "3"]) == 0
    res = json.loads(buf.getvalue())
    assert res["captured"] is False and res["replay_device_ms_per_token"] is None
    assert res["repaired_steps"] >= 0 and res["value"] > 0
