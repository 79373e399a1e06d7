"""PyTorch port ops vs the JAX reference, on the CPU.

Same numpy inputs from a seed go through the reference function and its
port counterpart. Integer stages (packing, int8 activation codes, int32
ternary accumulators) must match bit for bit; float stages within the
stated tolerance. Also holds the port's hygiene rules: no jax or
wrinklefree_tpu import anywhere in the port, and entry points that refuse
to fall back to the CPU on their own.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrinklefree_tpu.models import bitnet as ref_bitnet
from wrinklefree_tpu.ops import norms as ref_norms
from wrinklefree_tpu.ops import rope as ref_rope
from wrinklefree_tpu.ops import sampling as ref_sampling
from wrinklefree_tpu.ops import ternary as ref_ternary
from wrinklefree_tpu_torch.models import bitnet as tb
from wrinklefree_tpu_torch.ops import norms, rope, sampling, ternary

REPO = Path(__file__).resolve().parent.parent


def bf16_pair(x: np.ndarray):
    """The same bf16 values on both sides (both round f32 to nearest even)."""
    j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    assert np.array_equal(np.asarray(j.astype(jnp.float32)), t.float().numpy())
    return j, t


def ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    ax = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(ax)) - 7)


@pytest.mark.parametrize("k,n,seed", [(8, 4, 0), (64, 48, 1), (256, 128, 2)])
def test_pack_unpack_bitwise(k, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    ref_q = np.asarray(ref_ternary.pack_ternary(jnp.asarray(w)))
    got_q = ternary.pack_ternary(torch.from_numpy(w)).numpy()
    assert np.array_equal(ref_q, got_q)
    assert np.array_equal(ref_q, ternary.pack_ternary_np(w))
    ref_w = np.asarray(ref_ternary.unpack_ternary(jnp.asarray(ref_q)))
    assert np.array_equal(ref_w, ternary.unpack_ternary(torch.from_numpy(got_q)).numpy())
    assert np.array_equal(ref_w, ternary.unpack_ternary_np(got_q))
    assert np.array_equal(ref_w, w)


def test_hf_repack_matches_reference():
    rng = np.random.default_rng(3)
    hf = rng.integers(0, 256, size=(16, 32)).astype(np.uint8)
    assert np.array_equal(ref_ternary.hf_packed_to_wf(hf), ternary.hf_packed_to_wf(hf))
    w = rng.normal(0, 0.02, size=(32, 16)).astype(np.float32)
    rt, rs = ref_ternary.quantize_weights_ternary(w)
    pt, ps = ternary.quantize_weights_ternary(w)
    assert np.array_equal(rt, pt) and rs == ps


@pytest.mark.parametrize("hf_exact", [False, True])
@pytest.mark.parametrize("rows,k", [(1, 128), (7, 256), (33, 512)])
def test_quantize_activations_bitwise(rows, k, hf_exact):
    rng = np.random.default_rng(rows * k)
    x = rng.normal(0, 1.5, size=(rows, k)).astype(np.float32)
    x[0, :3] = [0.0, -4.0, 4.0]  # exact ties and the absmax
    jx, tx = bf16_pair(x)
    rq, rs = ref_ternary.quantize_activations(jx, hf_exact=hf_exact)
    pq, ps = ternary.quantize_activations(tx, hf_exact=hf_exact)
    assert np.array_equal(np.asarray(rq), pq.numpy())
    assert np.array_equal(np.asarray(rs), ps.numpy())


@pytest.mark.parametrize("rows,k,n", [(1, 256, 64), (9, 512, 96), (40, 1024, 32)])
def test_ternary_matmul_and_linear_bitwise(rows, k, n):
    rng = np.random.default_rng(rows + k)
    xq = rng.integers(-128, 128, size=(rows, k)).astype(np.int8)
    w = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    qw = ternary.pack_ternary_np(w)
    ref = np.asarray(ref_ternary.ternary_matmul_reference(jnp.asarray(xq), jnp.asarray(qw)))
    got = ternary.ternary_matmul_reference(torch.from_numpy(xq), torch.from_numpy(qw))
    assert got.dtype == torch.int32
    assert np.array_equal(ref, got.numpy())
    # the full linear (quant -> dot -> 1/(sx*sw) rescale -> bf16): bitwise
    x = rng.normal(0, 1, size=(rows, k)).astype(np.float32)
    jx, tx = bf16_pair(x)
    ref_y = ref_bitnet.default_linear(jx, jnp.asarray(qw), jnp.float32(37.5))
    got_y = tb.default_linear(tx, torch.from_numpy(qw), torch.tensor(37.5))
    assert np.array_equal(np.asarray(ref_y.astype(jnp.float32)), got_y.float().numpy())


@pytest.mark.parametrize("rows,k", [(1, 128), (6, 2560)])
def test_rms_norm_within_one_ulp(rows, k):
    """Within 1 bf16 ulp: the f32 variance is a sum whose order differs
    between XLA and torch, which can move the normalized value across a bf16
    rounding boundary."""
    rng = np.random.default_rng(k)
    x = rng.normal(0, 2, size=(rows, k)).astype(np.float32)
    w = rng.normal(1, 0.1, size=(k,)).astype(np.float32)
    jx, tx = bf16_pair(x)
    jw, tw = bf16_pair(w)
    ref = np.asarray(ref_norms.rms_norm(jx, jw).astype(jnp.float32))
    got = norms.rms_norm(tx, tw).float().numpy()
    assert np.all(np.abs(ref - got) <= ulp_bf16(ref) + 1e-30)


def test_rope_within_one_ulp():
    """cos/sin in f32 within 2e-6 (f32 transcendental rounding); the rotated
    bf16 q/k within 1 bf16 ulp (XLA may fuse the multiply-add without the
    intermediate bf16 rounding torch performs)."""
    rng = np.random.default_rng(0)
    pos = np.arange(0, 300, 7, dtype=np.int32)[None, :]
    rc, rs = ref_rope.rope_cos_sin(jnp.asarray(pos), 32, 5e5, jnp.float32)
    pc, ps = rope.rope_cos_sin(torch.from_numpy(pos), 32, 5e5, torch.float32)
    np.testing.assert_allclose(np.asarray(rc), pc.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.asarray(rs), ps.numpy(), rtol=0, atol=2e-6)
    q = rng.normal(0, 1, size=(1, pos.shape[1], 4, 32)).astype(np.float32)
    k = rng.normal(0, 1, size=(1, pos.shape[1], 2, 32)).astype(np.float32)
    jq, tq = bf16_pair(q)
    jk, tk = bf16_pair(k)
    rcb, rsb = ref_rope.rope_cos_sin(jnp.asarray(pos), 32, 5e5, jnp.bfloat16)
    pcb, psb = rope.rope_cos_sin(torch.from_numpy(pos), 32, 5e5, torch.bfloat16)
    assert np.array_equal(np.asarray(rcb.astype(jnp.float32)), pcb.float().numpy())
    rq, rk = ref_rope.apply_rope(jq, jk, rcb, rsb)
    gq, gk = rope.apply_rope(tq, tk, pcb, psb)
    for r, g in ((rq, gq), (rk, gk)):
        r = np.asarray(r.astype(jnp.float32))
        g = g.float().numpy()
        assert np.all(np.abs(r - g) <= 2 * ulp_bf16(r))


def test_int8_head_and_logits():
    """quantize_lm_head: int8 rows and scales bitwise equal; the logits of
    both heads within f32 summation-order error of the reference's."""
    rng = np.random.default_rng(9)
    emb = rng.normal(0, 0.02, size=(300, 64)).astype(np.float32)
    h = rng.normal(0, 1, size=(3, 64)).astype(np.float32)
    je, te = bf16_pair(emb)
    jh, th = bf16_pair(h)
    cfg_r = ref_bitnet.BitNetConfig.tiny(vocab_size=300)
    from wrinklefree_tpu_torch.config import BitNetConfig
    cfg_p = BitNetConfig.tiny(vocab_size=300)
    ref = ref_bitnet.quantize_lm_head({"embed": je}, cfg_r)
    got = tb.quantize_lm_head({"embed": te}, cfg_p)
    assert np.array_equal(np.asarray(ref["lm_head_q"]), got["lm_head_q"].numpy())
    assert np.array_equal(np.asarray(ref["lm_head_s"]), got["lm_head_s"].numpy())
    for r, g in ((ref, got), ({"embed": je}, {"embed": te})):
        np.testing.assert_allclose(
            tb.compute_logits(th, g, cfg_p).numpy(),
            np.asarray(ref_bitnet.compute_logits(jh, r, cfg_r)), rtol=1e-5, atol=1e-5)


def _logits(b=3, v=97, seed=0):
    return np.random.default_rng(seed).normal(0, 3, size=(b, v)).astype(np.float32)


@pytest.mark.parametrize("k", [[1, 5, 97], [3, 3, 3], [10, 0, 50]])
def test_top_k_mask_equal(k):
    lg = _logits()
    ref = np.asarray(ref_sampling.apply_top_k(jnp.asarray(lg), jnp.asarray(k)))
    got = sampling.apply_top_k(torch.from_numpy(lg), np.asarray(k)).numpy()
    assert np.array_equal(np.isinf(ref), np.isinf(got))
    assert np.array_equal(ref[~np.isinf(ref)], got[~np.isinf(got)])


@pytest.mark.parametrize("p", [[0.1, 0.5, 0.9], [1.0, 0.0, 0.3]])
def test_top_p_mask_equal(p):
    lg = _logits(seed=1)
    ref = np.asarray(ref_sampling.apply_top_p(jnp.asarray(lg), jnp.asarray(p, jnp.float32)))
    got = sampling.apply_top_p(torch.from_numpy(lg), np.asarray(p, np.float32)).numpy()
    assert np.array_equal(np.isinf(ref), np.isinf(got))


@pytest.mark.parametrize(
    "rep,pres,freq",
    [([1.3, 1.0, 0.8], [0.0, 0.5, 0.0], [0.0, 0.0, 0.7]), ([1.0] * 3, [0.0] * 3, [0.0] * 3)],
)
def test_penalties_equal(rep, pres, freq):
    lg = _logits(seed=2)
    W = 8
    rng = np.random.default_rng(4)
    ring = rng.integers(-1, 97, size=(3, W)).astype(np.int32)
    sl = np.asarray([3, 8, 13], np.int32)
    lastn = np.asarray([8, 4, 6], np.int32)
    ref = np.asarray(ref_sampling.apply_penalties(
        jnp.asarray(lg), jnp.asarray(ring), jnp.asarray(sl), jnp.asarray(lastn),
        jnp.asarray(rep, jnp.float32), jnp.asarray(pres, jnp.float32),
        jnp.asarray(freq, jnp.float32)))
    got = sampling.apply_penalties(
        torch.from_numpy(lg), torch.from_numpy(ring), torch.from_numpy(sl), lastn,
        np.asarray(rep, np.float32), np.asarray(pres, np.float32),
        np.asarray(freq, np.float32)).numpy()
    np.testing.assert_array_equal(ref, got)


def test_logit_bias_equal():
    lg = _logits(seed=3)
    ids = np.asarray([[5, -1, 9], [-1, -1, -1], [96, 0, 5]], np.int32)
    vals = np.asarray([[2.0, 0.0, -1e9], [0, 0, 0], [1.5, -0.5, 3.0]], np.float32)
    ref = np.asarray(ref_sampling.apply_logit_bias(
        jnp.asarray(lg), jnp.asarray(ids), jnp.asarray(vals)))
    got = sampling.apply_logit_bias(torch.from_numpy(lg), ids, vals).numpy()
    np.testing.assert_array_equal(ref, got)


def test_greedy_and_seeded_sampling():
    lg = torch.from_numpy(_logits(b=4, v=300, seed=5))
    greedy = sampling.sample_token(lg)
    assert torch.equal(greedy, torch.argmax(lg, -1).int())

    def draw(seed):
        gens = [None, torch.Generator().manual_seed(seed), None, torch.Generator().manual_seed(7)]
        return sampling.sample_token(lg, gens, temperature=[0.0, 0.9, 0.0, 1.2],
                                     top_p=0.9, top_k=[0, 20, 0, 0], min_p=0.02,
                                     typical_p=[1.0, 0.95, 1.0, 1.0], tfs_z=[1.0, 1.0, 1.0, 0.9])
    a, b = draw(11), draw(11)
    assert torch.equal(a, b)
    assert a[0] == greedy[0] and a[2] == greedy[2]
    with pytest.raises(ValueError):
        sampling.sample_token(lg, None, temperature=0.5)


def _port_sources():
    files = sorted((REPO / "wrinklefree_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    banned = ("jax", "jaxlib", "wrinklefree_tpu")
    bad = []
    for f in _port_sources():
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    bad.append(f"{f.relative_to(REPO)}: {name}")
    assert not bad, bad


def test_entry_points_refuse_cpu_fallback():
    from wrinklefree_tpu_torch.config import BitNetConfig
    from wrinklefree_tpu_torch.engine import Engine
    from wrinklefree_tpu_torch.weights import params_from_numpy

    if torch.cuda.is_available():
        pytest.skip("the refusal applies to hosts without CUDA")
    cfg = BitNetConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.init_params(cfg)
    params = tb.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"embed": np.zeros((2, 2), np.float32)}, cfg)
