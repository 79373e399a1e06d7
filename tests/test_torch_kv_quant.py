"""Quantized KV pools and the token-major layout of the port against the JAX
reference, on the CPU.

``kv/quantized.py``'s stored bytes and scales against the reference's
``quantize_kv`` (the f32 -> fp8 casts of torch and ml_dtypes compared byte for
byte, the absmax element landing on the format's maximum); the pools'
shapes; what ``paged_forward`` stores (the quantized pool after a first
chunk holds ``quantize_kv`` of the bf16 pool's rows); its logits on the token
and layer layouts at every dtype against the reference's ``paged_forward``
(interpret-mode kernels, jitted) within the bar of
``tests/test_torch_engine.py``; ``paged_kv_update`` against its documented
writes; the engine on the token layout and quantized pools against the
reference Engine (``tests/test_dual_kv.py``'s cases)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests.test_torch_engine import ECFG, PROMPTS, _run_jobs, assert_greedy_near_ties
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
from wrinklefree_tpu.engine import Engine as RefEngine
from wrinklefree_tpu.engine import SamplingParams as RefSampling
from wrinklefree_tpu.kv import paged as ref_paged
from wrinklefree_tpu.kv import quantized as ref_quant
from wrinklefree_tpu.models.bitnet import fuse_projections as ref_fuse
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu.ops.ternary_pallas import make_pallas_linear_fused
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.engine import Engine, SamplingParams
from wrinklefree_tpu_torch.kv import paged, quantized
from wrinklefree_tpu_torch.models.bitnet import fuse_projections
from wrinklefree_tpu_torch.ops.kv_update_cuda import paged_kv_update
from wrinklefree_tpu_torch.weights import params_from_numpy

DTYPES = ["f32", "fp16", "bf16", "int8", "fp8_e4m3", "fp8_e5m2"]


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, ref_init(RefConfig.tiny(), seed=0))


def _vectors():
    """bf16 [N, 5, 128] head vectors: normal draws at scales 1e-3..1e3, plus a
    zero vector (the 1e-6 clamp), one spike, a negative absmax and equal
    magnitudes (every element on the format's maximum)."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((64, 5, 128)) * np.exp(rng.uniform(-7, 7, (64, 5, 1)))
    x[0, 0] = 0.0
    x[1, 1] = 0.0
    x[1, 1, 7] = 3.5
    x[2, 2, 3] = -abs(x[2, 2]).max() * 2
    x[3, 3] = np.where(np.arange(128) % 2, 1.0, -1.0) * 0.75
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("dt", DTYPES)
def test_quantize_kv_stores_the_reference_bytes(dt):
    x = _vectors()
    q, s = quantized.quantize_kv(x, dt)
    xr = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    rq, rs = jax.jit(functools.partial(ref_quant.quantize_kv, kv_dtype=dt))(xr)
    assert q.dtype == quantized.KV_DTYPES[dt]
    np.testing.assert_array_equal(q.view(torch.uint8 if q.element_size() == 1 else
                                         {2: torch.int16, 4: torch.int32}[q.element_size()])
                                  .numpy(),
                                  np.asarray(rq).view({1: np.uint8, 2: np.int16,
                                                       4: np.int32}[q.element_size()]))
    assert (s is None) == (rs is None) == (not quantized.needs_scale(dt))
    if s is None:
        return
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(rs).view(np.int32))
    if dt.startswith("fp8"):
        # the largest element of every nonzero vector lands on the maximum
        top = q.float().abs().amax(-1)
        assert float(top.max()) == quantized._FP8_MAX[dt]
        assert int((top == quantized._FP8_MAX[dt]).sum()) == x.shape[0] * x.shape[1] - 1
    got = quantized.dequantize_kv(q, s)
    want = ref_quant.dequantize_kv(rq, rs)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("dt", ["bf16", "int8"])
def test_pool_shapes(dt):
    cfg = BitNetConfig.tiny()
    tok = paged.PagedKV.zeros(cfg, 6, 8, dt, device="cpu")
    dual = paged.PagedKV.zeros_dual(cfg, 6, 8, 3, dt, device="cpu")
    assert not tok.dual and dual.dual and tok.page_size == dual.page_size == 8
    assert tuple(tok.kv.shape) == (6, 8, 4, 64) and tuple(dual.kv.shape) == (6, 4, 8, 64)
    assert tok.kv_dtype_name == dual.kv_dtype_name == dt
    if dt == "bf16":
        assert tok.scale is None and dual.scale is None and dual.staging_scale is None
        assert tok.nbytes == 6 * 8 * 4 * 64 * 2
        return
    assert tuple(tok.scale.shape) == (6, 8, 4, 2) and tuple(dual.scale.shape) == (6, 4, 8, 2)
    assert tuple(dual.staging_scale.shape) == (4, 8, 4, 2)
    assert all(float(t.min()) == 1.0 for t in (tok.scale, dual.scale, dual.staging_scale))
    assert tok.nbytes == 6 * 8 * 4 * (64 + 2 * 4)


def _pools(layout, cfg, P, ps, dt, ref=False):
    if ref:
        return (ref_paged.PagedKV.zeros_dual(cfg, P, ps, num_slots=2, kv_dtype=dt)
                if layout == "layer" else ref_paged.PagedKV.zeros(cfg, P, ps, dt))
    return (paged.PagedKV.zeros_dual(cfg, P, ps, 2, dt, device="cpu")
            if layout == "layer" else paged.PagedKV.zeros(cfg, P, ps, dt, device="cpu"))


@functools.lru_cache(maxsize=1)
def _ref_forward():
    return jax.jit(functools.partial(ref_paged.paged_forward, cfg=RefConfig.tiny(),
                                     linear_fn=make_pallas_linear_fused(interpret=True)))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("layout", ["token", "layer"])
def test_paged_forward_logits_match_reference(weights, layout, dt):
    """A 123-token chunk (K4's contiguous form on the token layout and the
    pool form on the dual one, for bf16: the table's 256 tokens + 128 fill
    whole tiles), then 6 decode steps that cross a page, both packages
    teacher-forced with the reference's token; logits within 6e-2."""
    rcfg, cfg = RefConfig.tiny(), BitNetConfig.tiny()
    ps, MP, P = 8, 32, 40
    r_params = ref_fuse(jax.tree.map(jnp.asarray, weights), rcfg)
    p_params = fuse_projections(params_from_numpy(weights, cfg, device="cpu"), cfg)
    r_pools, p_pools = _pools(layout, rcfg, P, ps, dt, ref=True), _pools(layout, cfg, P, ps, dt)
    pt = np.arange(1, MP + 1, dtype=np.int32)[None]
    toks = np.zeros((1, 128), np.int32)
    toks[0, :123] = np.random.default_rng(0).integers(1, cfg.vocab_size, 123)
    sl, n = 0, 123
    for step in range(7):
        lo_r, r_pools = _ref_forward()(
            r_params, tokens=jnp.asarray(toks), pools=r_pools, page_table=jnp.asarray(pt),
            seq_lens=jnp.asarray([sl]), new_lens=jnp.asarray([n]), slot_ids=jnp.asarray([1]))
        lo_p, p_pools = paged.paged_forward(
            p_params, cfg, torch.from_numpy(toks), p_pools, torch.from_numpy(pt),
            torch.tensor([sl]), torch.tensor([n]), slot_ids=torch.tensor([1]))
        np.testing.assert_allclose(lo_p.numpy(), np.asarray(lo_r), rtol=6e-2, atol=6e-2,
                                   err_msg=f"step {step} (seq_len {sl})")
        sl += n
        toks, n = np.asarray([[int(np.argmax(np.asarray(lo_r), -1)[0])]], np.int32), 1
    assert sl == 129  # crossed the page boundary at 128


def _rows(pools, layout, cfg, n):
    """The first n tokens' rows [n, 2L, KV*D] (values) and [n, 2L, KV]
    (scales, or None) of table pages 1.. of a pool."""
    ps = pools.page_size
    pages = torch.arange(1, 1 + -(-n // ps))

    def rows(t):
        if t is None:
            return None
        t = t[pages]
        if layout == "layer":
            t = t.transpose(1, 2)  # [pages, ps, 2L, w]
        return t.reshape(-1, *t.shape[2:])[:n]

    return rows(pools.kv), rows(pools.scale)


@pytest.mark.parametrize("dt", ["int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("layout", ["token", "layer"])
def test_first_chunk_stores_quantized_rows(weights, layout, dt):
    """After a first 40-token chunk (no history: its K/V rows do not depend
    on the pool) a quantized pool holds ``quantize_kv`` of the bf16 pool's
    rows, bit for bit, values and scales, and the other pages stay zero."""
    cfg = BitNetConfig.tiny()
    params = fuse_projections(params_from_numpy(weights, cfg, device="cpu"), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(1, 256, (1, 40)))
    pt = torch.arange(1, 9, dtype=torch.int32)[None]
    stored = {}
    for d in ("bf16", dt):
        pools = _pools(layout, cfg, 10, 8, d)
        _, pools = paged.paged_forward(params, cfg, toks, pools, pt, torch.tensor([0]),
                                       torch.tensor([40]), slot_ids=torch.tensor([0]))
        stored[d] = (pools, _rows(pools, layout, cfg, 40))
    bf_rows = stored["bf16"][1][0]
    q_pools, (q_rows, s_rows) = stored[dt]
    kv = cfg.num_kv_heads
    want_q, want_s = quantized.quantize_kv(bf_rows.reshape(40, -1, kv, cfg.head_dim), dt)
    assert torch.equal(q_rows.view(torch.uint8), want_q.reshape(q_rows.shape).view(torch.uint8))
    assert torch.equal(s_rows, want_s.reshape(s_rows.shape))
    assert not q_pools.kv[6:].view(torch.uint8).any()


def test_paged_kv_update_writes_each_layer():
    """``paged_kv_update`` (the reference's per-layer pool writer, no caller
    in either package): layer l's row (b, s) lands at page ``page_ids[b, s] +
    l * layer_stride``, offset ``offsets[b, s]``, nothing else changes."""
    rng = np.random.default_rng(3)
    L, P, ps, KV, D = 3, 5, 4, 2, 16
    pool = torch.from_numpy(rng.standard_normal((L, P, ps, KV, D)).astype(np.float32))
    before = pool.clone()
    vals = torch.from_numpy(rng.standard_normal((L, 2, 3, KV, D)).astype(np.float32))
    page_ids = torch.tensor([[1, 1, 2], [4, 3, 3]])
    offsets = torch.tensor([[1, 2, 0], [3, 0, 1]])
    out = paged_kv_update(pool, vals, page_ids, offsets, layer_stride=P)
    assert out is pool
    want = before.clone()
    for l in range(L):
        for b in range(2):
            for s in range(3):
                want[l, page_ids[b, s], offsets[b, s]] = vals[l, b, s]
    assert torch.equal(pool, want)


def _engines(weights, layout, dt, **over):
    e = dict(ECFG, kv_layout=layout, kv_dtype=dt, **over)
    cfg, rcfg = BitNetConfig.tiny(), RefConfig.tiny()
    port = Engine(params_from_numpy(weights, cfg, device="cpu"), cfg, EngineConfig(**e),
                  device="cpu")
    ref = RefEngine(ref_fuse(jax.tree.map(jnp.asarray, weights), rcfg), rcfg,
                    RefEngineConfig(**e), linear_fn=make_pallas_linear_fused(interpret=True))
    return port, ref


@pytest.mark.parametrize("layout,dt", [("token", "bf16"), ("token", "fp8_e4m3"),
                                       ("layer", "int8")])
def test_engine_streams_match_reference(weights, layout, dt):
    """``tests/test_dual_kv.py``'s prompts (a mid-page end, a page crossed in
    prefill, a tiny prompt, a multi-chunk prefill) greedy, plus 8 requests
    over 4 slots (slot reuse), on the port and the reference Engine with the
    same layout and dtype: equal streams, or parted only at a near-tie of
    the reference's own logits."""
    port, ref = _engines(weights, layout, dt)
    assert port.kv_layout == layout and port.pools.kv_dtype_name == dt
    jobs = [(p, dict(max_new_tokens=16, temperature=0.0))
            for p in (PROMPTS[0], PROMPTS[1], PROMPTS[3], PROMPTS[4])]
    jobs += [(list(range(i + 1, i + 7)), dict(max_new_tokens=8, temperature=0.0))
             for i in range(8)]
    got = _run_jobs(port, SamplingParams, jobs)
    want = _run_jobs(ref, RefSampling, jobs)
    assert_greedy_near_ties(weights, [p for p, _ in jobs], got, want, kv_layout=layout,
                            kv_dtype=dt)


@pytest.mark.parametrize("dt", ["fp16", "f32"])
def test_flash_engine_on_wide_pools_matches_reference(weights, dt, monkeypatch):
    """``Engine(kv_dtype="fp16"|"f32", flash_decode=True)`` on the dual
    layout, as the card serves it: prompts of 40 and 100 tokens prefill in
    the 128-token bucket through K4's pool wrapper, every decode step's
    attention goes through K6's (their plain versions here; the card's
    kernels compute the same functions, ``tests/test_torch_cuda.py``), both
    given the pool's type; greedy streams (with shorter prompts beside them)
    equal the reference Engine's on the same pool type or part only at a
    near-tie of the reference's own logits (``NEAR_TIE``, 6e-2)."""
    seen = {"k4": set(), "k6": set()}
    k4, k6 = paged.flash_paged_prefill_pool, paged.flash_paged_decode

    def spy_k4(q, k_cur, v_cur, main, *rest):
        seen["k4"].add((q.dtype, main.dtype))
        return k4(q, k_cur, v_cur, main, *rest)

    def spy_k6(q, k_cur, v_cur, main, staging_b, *rest):
        seen["k6"].add((q.dtype, main.dtype, staging_b.dtype))
        return k6(q, k_cur, v_cur, main, staging_b, *rest)

    monkeypatch.setattr(paged, "flash_paged_prefill_pool", spy_k4)
    monkeypatch.setattr(paged, "flash_paged_decode", spy_k6)
    e = dict(max_batch_slots=4, page_size=8, num_pages=140, max_context=256,
             prefill_buckets=(32, 128), kv_layout="layer", kv_dtype=dt)
    cfg, rcfg = BitNetConfig.tiny(), RefConfig.tiny()
    port = Engine(params_from_numpy(weights, cfg, device="cpu"), cfg,
                  EngineConfig(**e, flash_decode=True), device="cpu")
    ref = RefEngine(ref_fuse(jax.tree.map(jnp.asarray, weights), rcfg), rcfg,
                    RefEngineConfig(**e), linear_fn=make_pallas_linear_fused(interpret=True))
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (40, 100)]
    prompts += [PROMPTS[0], PROMPTS[3]]
    jobs = [(p, dict(max_new_tokens=12, temperature=0.0)) for p in prompts]
    got = _run_jobs(port, SamplingParams, jobs)
    want = _run_jobs(ref, RefSampling, jobs)
    pool_t = quantized.kv_torch_dtype(dt)
    assert seen["k4"] == {(pool_t, pool_t)}
    assert seen["k6"] == {(torch.bfloat16, pool_t, pool_t)}
    assert_greedy_near_ties(weights, prompts, got, want, kv_layout="layer", kv_dtype=dt)


def test_engine_token_layout_buckets_and_int8_quality(weights):
    """The token layout keeps the configured prefill buckets (only the dual
    layout rounds them to whole pages), and int8 KV stays close to bf16 on
    the dual layout (``tests/test_dual_kv.py``'s tripwire: the logits after
    one decode step that reads the int8 history, cosine > 0.99)."""
    cfg = BitNetConfig.tiny()
    params = params_from_numpy(weights, cfg, device="cpu")
    over = dict(ECFG, prefill_buckets=(5, 12, 30))
    tok = Engine(params, cfg, EngineConfig(**over, kv_layout="token"), device="cpu")
    lay = Engine(params, cfg, EngineConfig(**over), device="cpu")
    assert tok.ecfg.prefill_buckets == (5, 12, 30) and lay.ecfg.prefill_buckets == (8, 16, 32)
    r = tok.generate(list(range(1, 14)), SamplingParams(max_new_tokens=4))
    assert len(r.output_ids) == 4
    fp = fuse_projections(params, cfg)
    pt = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32)
    lo = {}
    for dt in ("bf16", "int8"):
        pools = paged.PagedKV.zeros_dual(cfg, 16, 8, 2, dt, device="cpu")
        _, pools = paged.paged_forward(fp, cfg, torch.arange(1, 9)[None], pools, pt,
                                       torch.tensor([0]), torch.tensor([8]),
                                       slot_ids=torch.tensor([0]))
        lo[dt], _ = paged.paged_forward(fp, cfg, torch.tensor([[9]]), pools, pt,
                                        torch.tensor([8]), torch.tensor([1]),
                                        slot_ids=torch.tensor([0]))
    a, b = lo["bf16"].ravel().double(), lo["int8"].ravel().double()
    assert float(a @ b / (a.norm() * b.norm())) > 0.99
