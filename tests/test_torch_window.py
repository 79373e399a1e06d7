"""Sliding-window attention of the port (``kv/paged.py``
``make_dual_window_attention``, ``_gqa_core_windowed``) against the JAX
reference, on the CPU.

``tests/test_window_paged.py``'s cases run through both packages on the same
random dual pools (bf16 and int8 with scales): a window wider than every
history equals the full dual attention; the page-skipping gather equals the
reference's at page-aligned and odd windows, with and without a global
prefix, over seq_lens that cross pages and fill the staging page; a prefill
chunk. Then the engine: a window of at least ``max_context`` gives the full
attention's tokens, a 16-token window with a global prefix serves the
reference Engine's greedy streams (or parts at a near-tie), reads fewer
pages than the table holds, and the window without the dual layout raises
the reference's ``ValueError``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests.test_torch_engine import _run_jobs, assert_greedy_near_ties
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
from wrinklefree_tpu.engine import Engine as RefEngine
from wrinklefree_tpu.engine import SamplingParams as RefSampling
from wrinklefree_tpu.kv import paged as ref_paged
from wrinklefree_tpu.models.bitnet import fuse_projections as ref_fuse
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu.ops.ternary_pallas import make_pallas_linear_fused
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.engine import Engine, SamplingParams
from wrinklefree_tpu_torch.kv import paged, quantized
from wrinklefree_tpu_torch.weights import params_from_numpy

CFG, RCFG = BitNetConfig.tiny(), RefConfig.tiny()
B, L, P, PS, KV, NH, D = 2, 2, 18, 4, 2, 4, 8
ECFG_WIN = dict(max_batch_slots=2, page_size=8, num_pages=64, max_context=64,
                prefill_buckets=(8, 16, 32), kv_layout="layer", decode_burst=4)


def _mk(seed, S, seq_lens, kv_dtype="f32"):
    """Random dual pools (quantized with their scales for int8) and the
    current chunk; slot b owns pages 1 + b*MP.. of a dense page table."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.3)

    main, staging = f(P, 2 * L, PS, KV * D), f(B, PS, 2 * L, KV * D)
    scales = {}
    if kv_dtype != "f32":
        qm, sm = quantized.quantize_kv(main.reshape(P, 2 * L, PS, KV, D), kv_dtype)
        qs, ss = quantized.quantize_kv(staging.reshape(B, PS, 2 * L, KV, D), kv_dtype)
        main, staging = qm.reshape(main.shape), qs.reshape(staging.shape)
        scales = dict(main_scale=sm[..., 0], staging_scale_b=ss[..., 0])
    MP = P // B
    pt = np.minimum(1 + np.arange(B)[:, None] * MP + np.arange(MP)[None, :], P - 1)
    return (f(B, S, NH, D), f(B, S, KV, D), f(B, S, KV, D), main, staging,
            torch.from_numpy(pt.astype(np.int32)), torch.tensor(seq_lens, dtype=torch.int32),
            scales)


def _ref(x):
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    return {k: _ref(v) for k, v in x.items()}


def _both(fn_port, fn_ref, args, layer, new_lens):
    q, k, v, main, staging, pt, sl, scales = args
    nl = torch.tensor(new_lens, dtype=torch.int32)
    got = fn_port(q, k, v, main, staging, layer, pt, sl, nl, CFG, **scales)
    want = fn_ref(*map(_ref, (q, k, v, main, staging)), layer, _ref(pt), _ref(sl), _ref(nl),
                  RCFG, **_ref(scales))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("seq_lens", [[0, 3], [4, 9], [17, 30], [31, 32]])
def test_huge_window_equals_full_attention(seq_lens, kv_dtype):
    args = _mk(0, 1, seq_lens, kv_dtype)
    got, want = _both(paged.make_dual_window_attention(window=4096),
                      ref_paged.make_dual_window_attention(window=4096), args, 1, [1, 1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    full = paged._paged_attention_dual(*args[:5], 1, *args[5:7], torch.ones(B, dtype=torch.int32),
                                       CFG, **args[7])
    np.testing.assert_allclose(got, full.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,glob", [(4, 0), (8, 0), (5, 0), (4, 4), (8, 4), (4, 8)])
@pytest.mark.parametrize("seq_lens", [[0, 2], [4, 7], [13, 30], [32, 19]])
def test_page_skipping_matches_reference(window, glob, seq_lens):
    """Decode (S = 1) with the window and global prefix (the int8 pool on
    the odd window)."""
    args = _mk(1, 1, seq_lens, "int8" if window == 5 else "f32")
    got, want = _both(paged.make_dual_window_attention(window, glob),
                      ref_paged.make_dual_window_attention(window, glob), args, 0, [1, 1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_prefill_chunk_matches_reference():
    args = _mk(2, 4, [8, 12])
    got, want = _both(paged.make_dual_window_attention(8, 4),
                      ref_paged.make_dual_window_attention(8, 4), args, 1, [4, 3])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gather_is_smaller_than_the_table():
    """The cost shape: each layer call gathers (window + S) // ps + 2 pages
    per row (plus the global prefix's), not the table's MP."""
    args = _mk(3, 1, [30, 30])
    win = paged.make_dual_window_attention(window=4)
    win(*args[:5], 1, *args[5:7], torch.ones(B, dtype=torch.int32), CFG)
    wp = (4 + 1) // PS + 2
    assert win.gathered_pages == B * wp and wp < P // B


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, ref_init(RCFG, seed=0))


def _port(weights, **over):
    return Engine(params_from_numpy(weights, CFG, device="cpu"), CFG,
                  EngineConfig(**dict(ECFG_WIN, **over)), device="cpu")


def test_full_window_token_identical(weights):
    """A window of max_context takes the window attention and gives the
    tokens of the same engine with the full dual attention, and of the
    default engine."""
    sp = SamplingParams(max_new_tokens=12, ignore_eos=True)
    prompts = [[1, 5, 9, 2, 7], list(range(1, 20))]
    base = [_port(weights).generate(p, sp).output_ids for p in prompts]
    wide_eng = _port(weights, attn_window=64)
    assert wide_eng._attention_fn.window == 64
    wide = [wide_eng.generate(p, sp).output_ids for p in prompts]
    forced = Engine(params_from_numpy(weights, CFG, device="cpu"), CFG,
                    EngineConfig(**ECFG_WIN, attn_window=64), device="cpu",
                    attention_fn=paged._paged_attention_dual)
    assert forced._attention_fn is paged._paged_attention_dual
    assert wide == base == [forced.generate(p, sp).output_ids for p in prompts]


def test_small_window_matches_reference(weights):
    """A 16-token window with an 8-token global prefix on prompts longer than
    it: the reference Engine's greedy streams (or a near-tie), the same
    tokens twice, fewer pages gathered than the table holds."""
    jobs = [([1, 5, 9, 2, 7, 3, 3, 4], dict(max_new_tokens=24, ignore_eos=True)),
            (list(range(3, 30)), dict(max_new_tokens=20, ignore_eos=True))]
    port = _port(weights, attn_window=16, attn_global_tokens=8)
    got = _run_jobs(port, SamplingParams, jobs)
    again = _run_jobs(port, SamplingParams, jobs)
    ref = RefEngine(ref_fuse(jax.tree.map(jnp.asarray, weights), RCFG), RCFG,
                    RefEngineConfig(**ECFG_WIN, attn_window=16, attn_global_tokens=8),
                    linear_fn=make_pallas_linear_fused(interpret=True))
    want = _run_jobs(ref, RefSampling, jobs)
    assert got == again
    assert_greedy_near_ties(weights, [p for p, _ in jobs], got, want, window=16,
                            global_tokens=8)
    steps = port.stats["decode_steps"] + port.stats["prefill_rounds"]
    assert 0 < port._attention_fn.gathered_pages < steps * CFG.num_layers * 2 * 8


def test_window_requires_dual_layout(weights):
    with pytest.raises(ValueError, match="dual KV layout"):
        _port(weights, kv_layout="token", attn_window=16)
    with pytest.raises(ValueError, match="dual KV layout"):
        _port(weights, kv_layout="auto", kv_dtype="int8", attn_window=16)
