"""The port's MoE serving path and its prologue-free ternary matmul (K7)
against the JAX reference, on the CPU.

Both packages run tiny configs on identical weights (the reference's
``init_params`` carried over with ``params_from_numpy``). K7's plain
versions, which the wrappers take for CPU tensors, are held bit for bit
against the reference's ``ternary_matmul_pallas_stacked`` and
``ternary_matmul_pallas`` in interpret mode; the models and the engine
against the reference's own paths (its XLA expert linear, and its stacked
kernel in interpret mode for the paged layer step). The kernel itself is
held against its plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
import wrinklefree_tpu.models.moe as rmoe
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
from wrinklefree_tpu.engine import Engine as RefEngine
from wrinklefree_tpu.engine import SamplingParams as RefSampling
from wrinklefree_tpu.kv import paged as ref_paged
from wrinklefree_tpu.models import bitnet as rb
from wrinklefree_tpu.ops import ternary as rt
from wrinklefree_tpu.ops import ternary_pallas as ref_tp
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.engine import Engine, SamplingParams
from wrinklefree_tpu_torch.kv import paged
from wrinklefree_tpu_torch.models import bitnet as tb
from wrinklefree_tpu_torch.models import moe
from wrinklefree_tpu_torch.ops import ternary as tt
from wrinklefree_tpu_torch.ops import ternary_cuda
from wrinklefree_tpu_torch.weights import params_from_numpy

# tests/test_moe_model.py's MoE configuration and its dense twin
MOE = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=32, max_position=256, num_experts=4, num_experts_per_tok=2)
DENSE = dict(MOE, num_experts=0)
L, LAYER = 3, 1
NEAR_TIE = 6e-2  # tests/test_torch_engine.py's rule for greedy divergences


def to_np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def bf16_pair(x):
    """The same bf16 values for both packages."""
    return (jnp.asarray(x, jnp.float32).astype(jnp.bfloat16),
            torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16))


def ref_weights(rcfg, seed=0):
    """The reference's init_params as numpy arrays."""
    return jax.tree.map(np.asarray, rb.init_params(rcfg, seed=seed))


# ---------------------------------------------------------------------------
# K7: plain versions vs the reference's kernels in interpret mode
# ---------------------------------------------------------------------------


def k7_case(rows, seed, k=256, n=128):
    rng = np.random.default_rng(seed)
    qw = rng.integers(0, 256, (L, k // 4, n)).astype(np.uint8)
    xq = rng.integers(-128, 128, (rows, k)).astype(np.int8)
    sx = rng.uniform(0.5, 60.0, (rows, 1)).astype(np.float32)
    sw_layer = rng.uniform(10.0, 90.0, (L,)).astype(np.float32)
    sw_col = rng.uniform(10.0, 90.0, (L, n)).astype(np.float32)
    return qw, xq, sx, sw_layer, sw_col


DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


@pytest.mark.parametrize("rows", [1, 8, 37])
@pytest.mark.parametrize("scale", ["layer", "column"])
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_k7_stacked_plain_vs_reference(rows, scale, out):
    """K7 over a layer stack, scale per layer ([L]) or per column (the
    reference's [L, 8, N] rows, the port's [L, N]): bit for bit, since the
    dot is exact integer math and the rescale the same IEEE operations."""
    qw, xq, sx, sw_layer, sw_col = k7_case(rows, seed=rows)
    jdt, tdt = DTYPES[out]
    ref_sw = sw_layer if scale == "layer" else np.broadcast_to(sw_col[:, None], (L, 8, 128))
    ref = ref_tp.ternary_matmul_pallas_stacked(
        jnp.asarray(xq), jnp.asarray(qw), LAYER, jnp.asarray(sx), jnp.asarray(ref_sw),
        out_dtype=jdt, interpret=True)
    got = ternary_cuda.ternary_matmul_stacked(
        torch.from_numpy(xq), torch.from_numpy(qw), LAYER, torch.from_numpy(sx),
        torch.from_numpy(sw_layer if scale == "layer" else sw_col), out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (rows, 128)
    assert np.array_equal(to_np(ref), got.float().numpy())


@pytest.mark.parametrize("rows", [1, 8, 37])
@pytest.mark.parametrize("out", ["bf16", "f32", "int32"])
def test_k7_unstacked_plain_vs_reference(rows, out):
    """K7 on one [K/4, N] matrix with a scalar scale, and its exact int32
    mode (no scales): bit for bit."""
    qw, xq, sx, sw_layer, _ = k7_case(rows, seed=100 + rows)
    w = qw[LAYER]
    if out == "int32":
        ref = ref_tp.ternary_matmul_pallas(jnp.asarray(xq), jnp.asarray(w), interpret=True)
        got = ternary_cuda.ternary_matmul(torch.from_numpy(xq), torch.from_numpy(w))
        assert got.dtype == torch.int32
        assert np.array_equal(np.asarray(ref), got.numpy())
        return
    jdt, tdt = DTYPES[out]
    ref = ref_tp.ternary_matmul_pallas(
        jnp.asarray(xq), jnp.asarray(w), jnp.asarray(sx), jnp.asarray(sw_layer[LAYER]),
        out_dtype=jdt, interpret=True)
    got = ternary_cuda.ternary_matmul(
        torch.from_numpy(xq), torch.from_numpy(w), torch.from_numpy(sx),
        torch.tensor(sw_layer[LAYER]), out_dtype=tdt)
    assert got.dtype == tdt
    assert np.array_equal(to_np(ref), got.float().numpy())


@pytest.mark.parametrize("rows", [1, 8, 37])
def test_linears_equal_reference_linear(rows):
    """``make_linear()`` (quantize, then K7 on one matrix), the stacked
    ``make_linear_stacked()`` and ``ternary_linear(kernel=K7's int32
    mode)`` all equal the reference's XLA ``ternary_linear`` bit for bit:
    the experts' linear is a choice of kernel, not of function."""
    rng = np.random.default_rng(rows)
    qw, _, _, sw_layer, _ = k7_case(rows, seed=200 + rows)
    jx, tx = bf16_pair(rng.normal(0, 1, (rows, 256)))
    want = to_np(rt.ternary_linear(jx, jnp.asarray(qw[LAYER]), jnp.asarray(sw_layer[LAYER])))
    w, s = torch.from_numpy(qw[LAYER]), torch.tensor(sw_layer[LAYER])
    got = {
        "make_linear": ternary_cuda.make_linear()(tx, w, s),
        "make_linear_stacked": ternary_cuda.make_linear_stacked()(
            tx, torch.from_numpy(qw), torch.from_numpy(sw_layer), LAYER),
        "kernel hook": tt.ternary_linear(tx, w, s, kernel=ternary_cuda.ternary_matmul),
        "plain": tt.ternary_linear(tx, w, s),
    }
    for name, y in got.items():
        assert y.dtype == torch.bfloat16
        assert np.array_equal(want, y.float().numpy()), name


# ---------------------------------------------------------------------------
# models/moe.py against its reference
# ---------------------------------------------------------------------------


def test_init_moe_experts_bitwise():
    rex, rrouter = rmoe.init_moe_experts(RefConfig(**MOE), 4, seed=3)
    ex, router = moe.init_moe_experts(BitNetConfig(**MOE), 4, seed=3, device="cpu")
    assert set(ex) == set(rex)
    for k, v in rex.items():
        assert ex[k].dtype == (torch.uint8 if k.endswith("_qw") else torch.float32), k
        assert np.array_equal(np.asarray(v), ex[k].numpy()), k
    assert router.dtype == torch.float32
    assert np.array_equal(np.asarray(rrouter), router.numpy())


def test_routing_matches_reference():
    """A zero router picks experts 0..k-1 with weight 1/k (ties to the lower
    id, as ``jax.lax.top_k``); on random logits with exact ties the ids
    equal the reference's and the weights agree to 1e-6; the identity route
    and the aux loss equal the reference's."""
    w, i = moe.top_k_route(torch.zeros(5, 4), 2)
    assert torch.equal(i, torch.tensor([[0, 1]] * 5, dtype=torch.int32))
    assert torch.equal(w, torch.full((5, 2), 0.5))
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 1, (16, 8)).astype(np.float32)
    logits[:, 5] = logits[:, 2]  # exact ties
    logits[3] = 0.0
    for k in (1, 2, 3):
        rw, ri = rmoe.top_k_route(jnp.asarray(logits), k)
        tw, ti = moe.top_k_route(torch.from_numpy(logits), k)
        assert np.array_equal(np.asarray(ri), ti.numpy()), k
        np.testing.assert_allclose(tw.numpy(), np.asarray(rw), rtol=1e-6, atol=1e-6)
    rw, ri = rmoe.identity_route(6, 2, expert=3)
    tw, ti = moe.identity_route(6, 2, expert=3)
    assert np.array_equal(np.asarray(rw), tw.numpy()) and np.array_equal(np.asarray(ri), ti.numpy())
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    idx = rng.integers(0, 8, (16, 2)).astype(np.int32)
    want = float(rmoe.load_balancing_loss(jnp.asarray(probs), jnp.asarray(idx), 8))
    got = float(moe.load_balancing_loss(torch.from_numpy(probs), torch.from_numpy(idx), 8))
    assert abs(want - got) <= 1e-6 * abs(want)


def moe_inputs(seed=1, rows=6):
    rcfg, cfg = RefConfig(**MOE), BitNetConfig(**MOE)
    rex, rrouter = rmoe.init_moe_experts(rcfg, 4, seed=seed)
    ex, router = moe.init_moe_experts(cfg, 4, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    jx, tx = bf16_pair(rng.normal(0, 1, (rows, cfg.hidden_size)))
    jsub, tsub = bf16_pair(rng.normal(1, 0.1, cfg.intermediate_size))
    return (rex, rrouter, jx, jsub), (ex, router, tx, tsub)


@pytest.mark.parametrize("override", [False, True], ids=["top2", "route_override"])
def test_moe_ffn_matches_reference(override):
    """moe_ffn routed by its router (top-2) and by a fixed route: outputs
    equal to the reference's bit for bit (exact routing, exact integer
    dots, the combine's products exact in f32 and summed in expert order),
    aux losses within 1e-6. The port's experts through ``make_linear()``
    (K7) equal its default exact linear bit for bit."""
    (rex, rrouter, jx, jsub), (ex, router, tx, tsub) = moe_inputs()
    route = None
    if override:
        rng = np.random.default_rng(9)
        ids = np.stack([rng.permutation(4)[:2] for _ in range(6)]).astype(np.int32)
        w = rng.uniform(0.1, 1.0, (6, 2)).astype(np.float32)
        route = (w / w.sum(-1, keepdims=True), ids)
    ry, raux = rmoe.moe_ffn(jx, rex, jsub, rrouter, top_k=2,
                            route_override=None if route is None else tuple(map(jnp.asarray, route)))
    kw = dict(top_k=2, route_override=None if route is None else tuple(map(torch.from_numpy, route)))
    ty, taux = moe.moe_ffn(tx, ex, tsub, router, **kw)
    ky, kaux = moe.moe_ffn(tx, ex, tsub, router, lf=ternary_cuda.make_linear(), **kw)
    assert torch.equal(ty, ky) and torch.equal(taux, kaux)
    assert np.array_equal(to_np(ry), ty.float().numpy())
    assert abs(float(raux) - float(taux)) <= 1e-6


class _RecordingAxis:
    """One simulated rank of an expert axis: ``psum`` records the rank's f32
    partial and returns it (the other ranks' partials are added by the
    test)."""

    def __init__(self, index, size):
        self.index, self.size, self.partials = index, size, []

    def psum(self, x):
        self.partials.append(x.clone())
        return x


def test_moe_ffn_ep_axis_raises():
    """Expert parallelism (``ep_axis``, once refused): each of two ranks
    holding two of the four experts sums its experts' outputs under its
    columns of the combine matrix in f32; the two partials add up to the
    single-device f32 sum within 1e-6 (the order of the f32 sum differs),
    and the aux loss is the single device's. A local expert count that does
    not tile the router's raises ``ValueError``."""
    _, (ex, router, tx, tsub) = moe_inputs()
    x32 = tx.float()
    full, aux = moe.moe_ffn(x32, ex, tsub, router, top_k=2)
    partials = []
    for r in range(2):
        axis = _RecordingAxis(r, 2)
        _, aux_r = moe.moe_ffn(x32, {k: v[2 * r:2 * r + 2] for k, v in ex.items()}, tsub,
                               router, top_k=2, ep_axis=axis)
        assert torch.equal(aux_r, aux)
        partials += axis.partials
    np.testing.assert_allclose((partials[0] + partials[1]).numpy(), full.numpy(), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="local experts"):
        moe.moe_ffn(tx, {k: v[:3] for k, v in ex.items()}, tsub, router,
                    ep_axis=_RecordingAxis(0, 2))


def test_verify_moe_matches_dense():
    """The identity-router oracle holds at tol 0.0, with the default exact
    linear and with K7's (``make_linear()``)."""
    cfg = BitNetConfig(**DENSE)
    layers = tb.init_params(cfg, seed=4, device="cpu")["layers"]
    dense_layer = {k: v[1] for k, v in layers.items()}
    assert moe.verify_moe_matches_dense(dense_layer, cfg, num_experts=4, tol=0.0)
    assert moe.verify_moe_matches_dense(dense_layer, cfg, num_experts=4, tol=0.0,
                                        lf=ternary_cuda.make_linear())


# ---------------------------------------------------------------------------
# the dense-cache forward with MoE layers
# ---------------------------------------------------------------------------


def test_forward_moe_matches_reference_f32():
    """forward on the MoE config in f32, 8 prompt tokens: cosine > 0.9999 to
    the reference's logits at every position and equal argmax
    (tests/test_torch_batch1.py's bar for the plain path)."""
    rcfg = RefConfig(**MOE, dtype=jnp.float32)
    w = ref_weights(rcfg, seed=5)
    cfg = BitNetConfig(**MOE, dtype=torch.float32)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    rl, _ = rb.forward(jax.tree.map(jnp.asarray, w), rcfg, jnp.asarray(toks),
                       rb.KVCache.zeros(rcfg, 1, 16), jnp.zeros((1,), jnp.int32))
    tl, _ = tb.forward(params_from_numpy(w, cfg, device="cpu"), cfg, torch.from_numpy(toks).long(),
                       tb.KVCache.zeros(cfg, 1, 16, device="cpu"), torch.zeros(1, dtype=torch.int32))
    rl, tl = np.asarray(rl)[0], tl.numpy()[0]
    for s in range(8):
        a, b = tl[s], rl[s]
        assert np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.9999, s
    assert np.array_equal(tl.argmax(-1), rl.argmax(-1))


@pytest.mark.parametrize("linear", ["default", "stacked"])
def test_forward_fake_moe_equals_dense(linear):
    """The model-level identity oracle (``moe.fake_moe_model``: identical
    expert views, a zero router): the fake-MoE model's logits equal the
    dense model's, within the reference's atol 0.05 and in fact bit for bit
    (the top-2 weights are exactly 0.5 and 0.5*o + 0.5*o is exact in f32),
    through the default exact linear and through the stacked K7 linear with
    K7 experts."""
    cfg = BitNetConfig(**DENSE)
    dense = tb.init_params(cfg, seed=6, device="cpu")
    mcfg, fake = moe.fake_moe_model(dense, cfg, 4)
    lf = ternary_cuda.make_linear_stacked() if linear == "stacked" else None
    toks = torch.tensor([[1, 2, 3, 4, 9, 7]])

    def run(p, c):
        return tb.forward(p, c, toks, tb.KVCache.zeros(c, 1, 16, device="cpu"),
                          torch.zeros(1, dtype=torch.int32), linear_fn=lf)

    (la, ca), (lb, cb) = run(dense, cfg), run(fake, mcfg)
    np.testing.assert_allclose(lb.float().numpy(), la.float().numpy(), atol=0.05, rtol=0)
    assert torch.equal(la, lb) and torch.equal(ca.k, cb.k) and torch.equal(ca.v, cb.v)


def test_forward_moe_stacked_linear_equals_default():
    """forward on MoE params with the stacked K7 linear (experts through
    K7's ``make_linear()``) equals the default exact linear bit for bit."""
    cfg = BitNetConfig(**MOE)
    params = tb.init_params(cfg, seed=7, device="cpu")
    toks = torch.tensor([[5, 1, 4, 2]])

    def run(lf):
        return tb.forward(params, cfg, toks, tb.KVCache.zeros(cfg, 1, 8, device="cpu"),
                          torch.zeros(1, dtype=torch.int32), linear_fn=lf)[0]

    assert torch.equal(run(None), run(ternary_cuda.make_linear_stacked()))


# ---------------------------------------------------------------------------
# paged_forward's plain layer step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["unfused", "fused", "moe"])
def test_paged_forward_plain_step_matches_reference(variant):
    """paged_forward's plain layer step with the stacked linear (K7) against
    the reference's non-prologue step with ``make_pallas_linear_stacked
    (interpret=True)``: dense tiny params unfused and q/k/v + gate/up fused,
    and the MoE config. A 16-token chunk (13 real), then 3 decode steps,
    teacher-forced with the reference's tokens; logits within 6e-2
    (tests/test_dual_kv.py's bar)."""
    if variant == "moe":
        rcfg, cfg = RefConfig(**MOE), BitNetConfig(**MOE)
    else:
        rcfg, cfg = RefConfig.tiny(), BitNetConfig.tiny()
    w = ref_weights(rcfg, seed=8)
    rparams = jax.tree.map(jnp.asarray, w)
    tparams = params_from_numpy(w, cfg, device="cpu")
    if variant == "fused":
        rparams, tparams = rb.fuse_projections(rparams, rcfg), tb.fuse_projections(tparams, cfg)
    rlf = ref_tp.make_pallas_linear_stacked(interpret=True)
    tlf = ternary_cuda.make_linear_stacked()
    r_pools = ref_paged.PagedKV.zeros_dual(rcfg, 8, 8, num_slots=1)
    t_pools = paged.PagedKV.zeros_dual(cfg, 8, 8, 1, device="cpu")
    pt = np.arange(1, 5, dtype=np.int32)[None]
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = np.random.default_rng(8).integers(1, cfg.vocab_size, 13)
    sl, n, slot = 0, 13, np.asarray([0], np.int32)
    for step in range(4):
        lo_r, r_pools = ref_paged.paged_forward(
            rparams, rcfg, jnp.asarray(toks), r_pools, jnp.asarray(pt), jnp.asarray([sl]),
            jnp.asarray([n]), linear_fn=rlf, slot_ids=jnp.asarray(slot))
        lo_t, t_pools = paged.paged_forward(
            tparams, cfg, torch.from_numpy(toks), t_pools, torch.from_numpy(pt),
            torch.tensor([sl]), torch.tensor([n]), linear_fn=tlf, slot_ids=torch.from_numpy(slot))
        np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_r), rtol=6e-2, atol=6e-2,
                                   err_msg=f"step {step}")
        sl += n
        toks, n = np.asarray([[int(np.argmax(np.asarray(lo_r)[0]))]], np.int32), 1


def test_paged_forward_refuses_mismatched_linear():
    cfg = BitNetConfig.tiny()
    params = tb.init_params(cfg, seed=0, device="cpu")
    pools = paged.PagedKV.zeros_dual(cfg, 4, 8, 1, device="cpu")
    args = (cfg, torch.tensor([[1, 2]]), pools, torch.tensor([[1, 2]], dtype=torch.int32),
            torch.tensor([0]), torch.tensor([2]))
    with pytest.raises(ValueError, match="fused projections require a stacked"):
        paged.paged_forward(tb.fuse_projections(params, cfg), *args, linear_fn=tb.default_linear)
    with pytest.raises(ValueError, match="fused-prologue"):
        paged.paged_forward(params, *args, linear_fn=ternary_cuda.make_linear_fused())


# ---------------------------------------------------------------------------
# the engine on the MoE config
# ---------------------------------------------------------------------------

ECFG = dict(max_batch_slots=4, page_size=8, num_pages=64, max_context=64,
            prefill_buckets=(8, 16, 32))
PROMPTS = [list(range(1, 6)), list(range(2, 15)), [7, 7, 7], list(range(1, 25))]
CONCURRENT = [list(range(i + 1, i + 7)) for i in range(6)]  # 6 requests, 4 slots


def _scenarios(eng, sp_cls):
    out = {"sequential": [], "concurrent": []}
    for p in PROMPTS:
        r = eng.generate(p, sp_cls(max_new_tokens=12, temperature=0.0))
        out["sequential"].append((r.output_ids, r.finish_reason))
    reqs = [eng.submit(p, sp_cls(max_new_tokens=8, temperature=0.0)) for p in CONCURRENT]
    while any(not r.finished for r in reqs):
        eng.step()
    out["concurrent"] = [(r.output_ids, r.finish_reason) for r in reqs]
    return out


@pytest.fixture(scope="module")
def moe_weights():
    return ref_weights(RefConfig(**MOE), seed=0)


@pytest.fixture(scope="module")
def ref_engine_outputs(moe_weights):
    """The reference engine on the dual layout with its XLA linears (the
    experts' linear of its kernel path too)."""
    eng = RefEngine(jax.tree.map(jnp.asarray, moe_weights), RefConfig(**MOE),
                    RefEngineConfig(kv_layout="layer", **ECFG))
    return _scenarios(eng, RefSampling)


@pytest.fixture(scope="module")
def port_engine(moe_weights):
    cfg = BitNetConfig(**MOE)
    eng = Engine(params_from_numpy(moe_weights, cfg, device="cpu"), cfg, EngineConfig(**ECFG),
                 device="cpu")
    calls = []
    orig = ternary_cuda.ternary_matmul_stacked_plain
    ternary_cuda.ternary_matmul_stacked_plain = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        out = _scenarios(eng, SamplingParams)
    finally:
        ternary_cuda.ternary_matmul_stacked_plain = orig
    return eng, out, len(calls)


def _ref_top2_gap(weights, prompt, tokens, step):
    """The reference's top-2 logit gap where it chose tokens[step]: its own
    paged forward (XLA linears, dual pools), teacher-forced."""
    cfg = RefConfig(**MOE)
    params = jax.tree.map(jnp.asarray, weights)
    pools = ref_paged.PagedKV.zeros_dual(cfg, 16, 8, num_slots=1)
    pt = jnp.arange(1, 9, dtype=jnp.int32)[None]
    chunk = np.zeros((1, -(-len(prompt) // 8) * 8), np.int32)
    chunk[0, :len(prompt)] = prompt
    logits, pools = ref_paged.paged_forward(
        params, cfg, jnp.asarray(chunk), pools, pt, jnp.asarray([0]),
        jnp.asarray([len(prompt)]), slot_ids=jnp.asarray([0]))
    for i, t in enumerate(tokens[:step]):
        logits, pools = ref_paged.paged_forward(
            params, cfg, jnp.asarray([[t]], jnp.int32), pools, pt,
            jnp.asarray([len(prompt) + i]), jnp.asarray([1]), slot_ids=jnp.asarray([0]))
    top2 = np.sort(np.asarray(logits)[0])[-2:]
    assert int(np.argmax(np.asarray(logits)[0])) == tokens[step]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize("scenario,prompts", [("sequential", PROMPTS),
                                              ("concurrent", CONCURRENT)])
def test_moe_engine_matches_reference(ref_engine_outputs, port_engine, moe_weights, scenario,
                                      prompts):
    """The MoE engine's greedy tokens equal the reference engine's; a sequence
    may part only at a near-tie (< 6e-2) of the reference's own logits. The
    stacked K7 linear (its plain version here) ran the q/k/v/o projections."""
    _, out, k7_calls = port_engine
    assert k7_calls > 0
    for prompt, (got, got_why), (want, want_why) in zip(
            prompts, out[scenario], ref_engine_outputs[scenario]):
        assert got_why == want_why and len(got) == len(want)
        if got == want:
            continue
        step = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        gap = _ref_top2_gap(moe_weights, prompt, want, step)
        assert gap < NEAR_TIE, f"prompt {prompt}: diverged at token {step}, top-2 gap {gap}"


def test_moe_engine_concurrent_equals_sequential(port_engine):
    """Requests batched together give the tokens they give alone."""
    eng, out, _ = port_engine
    alone = [eng.generate(p, SamplingParams(max_new_tokens=8, temperature=0.0)).output_ids
             for p in CONCURRENT]
    assert alone == [ids for ids, _ in out["concurrent"]]


def _fake_mesh(tp, index):
    """A rank's mesh for construction only (sharding runs no collective)."""
    import types

    model = types.SimpleNamespace(name="model", index=index, size=tp)
    data = types.SimpleNamespace(name="data", index=0, size=1)
    return types.SimpleNamespace(shape={"data": 1, "model": tp}, model=model, data=data,
                                 axis={"model": model, "data": data},
                                 device=torch.device("cpu"), control=None, leader=0)


def test_moe_engine_keeps_params_unfused_and_refuses_mesh(moe_weights):
    """The MoE engine keeps its params unfused on the stacked linear; under a
    mesh (once refused) rank 1 of tp 2 holds experts 2-3 of every layer
    (the model axis doubles as the expert axis) and the whole router; a tp
    that does not divide the experts is refused with ``ValueError``."""
    cfg = BitNetConfig(**MOE)
    params = params_from_numpy(moe_weights, cfg, device="cpu")
    eng = Engine(params, cfg, EngineConfig(**ECFG), device="cpu")
    assert "q_qw" in eng.params["layers"] and getattr(eng._linear_fn, "stacked", False)
    assert not getattr(eng._linear_fn, "prologue", False)
    tp = Engine(params, cfg, EngineConfig(**ECFG), mesh=_fake_mesh(2, 1), device="cpu")
    lay = tp.params["layers"]
    assert torch.equal(lay["moe_gate_qw"], params["layers"]["moe_gate_qw"][:, 2:4])
    assert torch.equal(lay["router"], params["layers"]["router"])
    assert getattr(tp._linear_fn, "stacked", False) and "q_qw" in lay
    with pytest.raises(ValueError, match="num_experts 4 not divisible by tp=3"):
        Engine(params, dataclasses.replace(cfg, num_heads=6, num_kv_heads=3), EngineConfig(**ECFG),
               mesh=_fake_mesh(3, 0), device="cpu")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def test_params_from_numpy_carries_moe_keys(moe_weights):
    """moe_*_qw [L, E, K/4, N], moe_*_scale [L, E] (not taken for fused scale
    rows) and the f32 router [L, H, E] keep their shapes and bits."""
    cfg = BitNetConfig(**MOE)
    got = params_from_numpy(moe_weights, cfg, device="cpu")["layers"]
    want = moe_weights["layers"]
    keys = [f"moe_{k}" for k in moe.EXPERT_KEYS] + ["router"]
    assert set(keys) <= set(got) and "gate_qw" not in got
    for k in keys:
        assert tuple(got[k].shape) == want[k].shape, k
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert tuple(got["moe_gate_scale"].shape) == (2, 4)
    assert tuple(got["moe_down_qw"].shape) == (2, 4, 64, 128)
    assert got["router"].dtype == torch.float32
