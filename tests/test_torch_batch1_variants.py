"""The port's batch-1 decode variants vs the JAX reference, on the CPU.

  layer_block_megakernel (plain, K8)      vs ternary_pallas.layer_block_megakernel (interpret)
  attn_/mlp_block_megakernel_static (plain) vs the reference's static kernels (interpret)
  split_layers_for_decode                 vs models.bitnet.split_layers_for_decode
  forward, unrolled split and layer-mega  vs models.bitnet.forward with
                                             make_pallas_linear_fused(interpret=True)
  bench.decode --split / --layer-mega     (smoke)

Both packages run on identical weights: seeded numpy arrays handed to both,
or the reference's ``init_params`` carried over with ``params_from_numpy``.
The port runs the plain versions of its kernels, which its wrappers take for
CPU tensors; tests/test_torch_cuda.py and chip_smoke.py hold the kernels
against those plain versions on the card.
"""

import dataclasses
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.models import bitnet as rb
from wrinklefree_tpu.ops import ternary_pallas as ref_tp
from wrinklefree_tpu_torch.bench import decode as bench_decode
from wrinklefree_tpu_torch.config import BitNetConfig
from wrinklefree_tpu_torch.models import bitnet as tb
from wrinklefree_tpu_torch.ops import ternary_cuda
from wrinklefree_tpu_torch.ops.rope import rope_cos_sin
from wrinklefree_tpu_torch.weights import params_from_numpy

# A divergence of greedy tokens is accepted only at a near-tie: where the
# reference's own top-2 logits are closer than this (tests/test_torch_engine.py).
NEAR_TIE = 6e-2

L, LAYER = 3, 1
H, NH, KVH, D, INTER = 256, 4, 2, 64, 256
Q = NH * D
NQ = Q + 2 * KVH * D
HEADS = dict(q_dim=Q, n_kv=KVH, n_heads=NH, head_dim=D)


def bf16_np(x):
    """Round to bf16 and back to f32 (numpy)."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def to_t(x, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t if dtype is None else t.to(dtype)


def bits_bf16(a):
    """bf16 values (a jax array or a torch tensor) as their uint16 bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.bfloat16).view(torch.int16).numpy().astype(np.uint16)
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)).view(np.uint16)


def rows8(a):
    """[L, N] -> the reference's [L, 8, N] rows."""
    return jnp.asarray(np.broadcast_to(a[:, None, :], (a.shape[0], 8, a.shape[1])))


def layer_case(T, norm2, seed, rows=1):
    rng = np.random.default_rng(seed)

    def norm(n):
        return bf16_np(rng.normal(1, 0.1, (L, n)))

    return dict(
        h=bf16_np(rng.normal(0, 1, (rows, H))),
        ck=bf16_np(rng.normal(0, 1, (L, 1, T, KVH, D))),
        cv=bf16_np(rng.normal(0, 1, (L, 1, T, KVH, D))),
        qkv_qw=rng.integers(0, 256, (L, H // 4, NQ)).astype(np.uint8),
        o_qw=rng.integers(0, 256, (L, Q // 4, H)).astype(np.uint8),
        gu_qw=rng.integers(0, 256, (L, H // 4, 2 * INTER)).astype(np.uint8),
        dn_qw=rng.integers(0, 256, (L, INTER // 4, H)).astype(np.uint8),
        qkv_s=rng.uniform(10, 90, (L, NQ)).astype(np.float32),
        o_s=rng.uniform(10, 90, (L, H)).astype(np.float32),
        gu_s=rng.uniform(10, 90, (L, 2 * INTER)).astype(np.float32),
        dn_s=rng.uniform(10, 90, (L, H)).astype(np.float32),
        iln=norm(H), pln=norm(H),
        sub=norm(Q) if norm2 else None, fsn=norm(INTER) if norm2 else None,
    )


def rope_rows(pos):
    cos, sin = rope_cos_sin(torch.tensor([pos]), D, 500_000.0, torch.bfloat16)
    cn, sn = cos.float().numpy(), sin.float().numpy()
    return cos[0], sin[0], jnp.asarray(np.broadcast_to(cn, (8, D))), jnp.asarray(
        np.broadcast_to(sn, (8, D)))


def check_block(ref_h, ref_k, ref_v, got_h, got_k, got_v, pos, layer=LAYER, lead=(LAYER, 0)):
    """K5's bars (tests/test_torch_batch1.py::test_k5_plain_vs_reference):
    h' within 4% of its largest value, the new k/v rows within 3% of the
    row's largest value, every other cache row bitwise equal. Returns the
    worst h' and row differences relative to those largest values."""
    ref_h = np.asarray(ref_h.astype(jnp.float32))
    got_h = got_h.float().numpy()
    dh = np.abs(ref_h - got_h).max() / np.abs(ref_h).max()
    assert dh <= 0.04
    others = np.ones(got_k.shape[-3], bool)
    others[pos] = False
    drow = 0.0
    for ref_c, got_c in ((ref_k, got_k), (ref_v, got_v)):
        assert np.array_equal(bits_bf16(ref_c)[..., others, :, :],
                              bits_bf16(got_c)[..., others, :, :])
        r = np.asarray(ref_c[lead + (pos,)].astype(jnp.float32))
        g = got_c[lead + (pos,)].float().numpy()
        drow = max(drow, np.abs(r - g).max() / np.abs(r).max())
        assert drow <= 0.03
    return dh, drow


# ---------------------------------------------------------------------------
# K8: the whole decode layer
# ---------------------------------------------------------------------------

FLAVOURS = [("relu2", True), ("silu", False), ("relu2", False), ("silu", True)]


@pytest.mark.parametrize("T,pos", [(16, 0), (24, 17)])
@pytest.mark.parametrize("act,norm2", FLAVOURS, ids=[f"{a}-{'sub' if n else 'nosub'}"
                                                     for a, n in FLAVOURS])
def test_k8_plain_vs_reference(act, norm2, T, pos):
    """K8's plain version vs the TPU kernel in interpret mode, with K5's
    bars (h' within 4% of its largest value, the new k/v rows within 3% of
    theirs, every other cache row bitwise equal): the reference, compiled by
    XLA on the CPU, keeps f32 across its fused bf16 ops (ROADMAP.md §3), so
    int8 codes of the four quantized stages can move by one. Measured worst
    over these cases: h' 3.6% (two stages more than K5's 0.8% here), written
    rows 1.2%."""
    c = layer_case(T, norm2, seed=T * 100 + pos + 7 * norm2)
    cos, sin, cos8, sin8 = rope_rows(pos)
    ref_h, ref_k, ref_v = ref_tp.layer_block_megakernel(
        jnp.asarray(c["h"], jnp.bfloat16), jnp.asarray(c["ck"], jnp.bfloat16),
        jnp.asarray(c["cv"], jnp.bfloat16), jnp.asarray(c["qkv_qw"]), jnp.asarray(c["o_qw"]),
        jnp.asarray(c["gu_qw"]), jnp.asarray(c["dn_qw"]), LAYER, pos, rows8(c["qkv_s"]),
        rows8(c["o_s"]), rows8(c["gu_s"]), rows8(c["dn_s"]), rows8(c["iln"]),
        rows8(c["sub"]) if norm2 else None, rows8(c["pln"]),
        rows8(c["fsn"]) if norm2 else None, cos8, sin8, act=act, norm2=norm2,
        interpret=True, **HEADS)
    ck, cv = to_t(c["ck"], torch.bfloat16), to_t(c["cv"], torch.bfloat16)

    def bf(name):
        return None if c[name] is None else to_t(c[name], torch.bfloat16)

    got_h, got_k, got_v = ternary_cuda.layer_block_megakernel(
        to_t(c["h"], torch.bfloat16), ck, cv, to_t(c["qkv_qw"]), to_t(c["o_qw"]),
        to_t(c["gu_qw"]), to_t(c["dn_qw"]), LAYER, pos, to_t(c["qkv_s"]), to_t(c["o_s"]),
        to_t(c["gu_s"]), to_t(c["dn_s"]), bf("iln"), bf("sub"), bf("pln"), bf("fsn"), cos, sin,
        act=act, norm2=norm2, **HEADS)
    assert got_k is ck and got_v is cv  # written in place
    check_block(ref_h, ref_k, ref_v, got_h, got_k, got_v, pos)


def test_k8_plain_is_k5_then_k2():
    """K8's plain version equals K5's plain version followed by K2's: the
    per-KV-head softmax and K5's form agree bit for bit on the CPU here."""
    c = layer_case(16, True, seed=3)
    cos, sin, _, _ = rope_rows(9)
    t = {k: (to_t(v, torch.bfloat16) if k in ("h", "ck", "cv", "iln", "sub", "pln", "fsn")
             else to_t(v)) for k, v in c.items()}
    ck2, cv2 = t["ck"].clone(), t["cv"].clone()
    a, _, _ = ternary_cuda.layer_block_megakernel_plain(
        t["h"], t["ck"], t["cv"], t["qkv_qw"], t["o_qw"], t["gu_qw"], t["dn_qw"], LAYER, 9,
        t["qkv_s"], t["o_s"], t["gu_s"], t["dn_s"], t["iln"], t["sub"], t["pln"], t["fsn"], cos,
        sin, **HEADS)
    h1, _, _ = ternary_cuda.attn_block_megakernel_plain(
        t["h"], ck2, cv2, t["qkv_qw"], t["o_qw"], LAYER, 9, t["qkv_s"], t["o_s"], t["iln"],
        t["sub"], cos, sin, **HEADS)
    b = ternary_cuda.mlp_block_megakernel_plain(h1, t["gu_qw"], t["dn_qw"], LAYER, t["gu_s"],
                                                t["dn_s"], t["pln"], t["fsn"])
    assert torch.equal(a, b) and torch.equal(t["ck"], ck2) and torch.equal(t["cv"], cv2)


# ---------------------------------------------------------------------------
# the static (one-layer) attention and MLP blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm2", [True, False], ids=["subnorm", "nosub"])
def test_attn_static_plain_vs_reference(norm2):
    """The static attention block on one layer's tensors vs
    attn_block_megakernel_static in interpret mode, with K5's bars
    (measured worst: h' 0.8%, written rows 0.9%)."""
    T, pos = 16, 11
    c = layer_case(T, norm2, seed=41 + norm2)
    cos, sin, cos8, sin8 = rope_rows(pos)
    r8 = lambda a: jnp.asarray(np.broadcast_to(a[LAYER], (8, a.shape[1])))  # noqa: E731
    ref_h, ref_k, ref_v = ref_tp.attn_block_megakernel_static(
        jnp.asarray(c["h"], jnp.bfloat16), jnp.asarray(c["ck"][LAYER], jnp.bfloat16),
        jnp.asarray(c["cv"][LAYER], jnp.bfloat16), jnp.asarray(c["qkv_qw"][LAYER]),
        jnp.asarray(c["o_qw"][LAYER]), pos, r8(c["qkv_s"]), r8(c["o_s"]), r8(c["iln"]),
        r8(c["sub"]) if norm2 else None, cos8, sin8, norm2=norm2, interpret=True, **HEADS)
    ck, cv = to_t(c["ck"], torch.bfloat16), to_t(c["cv"], torch.bfloat16)
    got_h, got_k, got_v = ternary_cuda.attn_block_megakernel_static(
        to_t(c["h"], torch.bfloat16), ck[LAYER], cv[LAYER], to_t(c["qkv_qw"])[LAYER],
        to_t(c["o_qw"])[LAYER], pos, to_t(c["qkv_s"])[LAYER], to_t(c["o_s"])[LAYER],
        to_t(c["iln"], torch.bfloat16)[LAYER],
        to_t(c["sub"], torch.bfloat16)[LAYER] if norm2 else None, cos, sin, norm2=norm2,
        **HEADS)
    assert got_k.data_ptr() == ck[LAYER].data_ptr()  # this layer's view, written in place
    check_block(ref_h, ref_k, ref_v, got_h, got_k, got_v, pos, lead=(0,))
    assert np.array_equal(bits_bf16(ck[:LAYER]), bits_bf16(c["ck"][:LAYER]))


@pytest.mark.parametrize("rows", [1, 12])
@pytest.mark.parametrize("act,norm2", [("relu2", True), ("silu", False)])
def test_mlp_static_plain_vs_reference(act, norm2, rows):
    """The static MLP block vs mlp_block_megakernel_static in interpret
    mode, at 1 row and at 12 (two K2 launches on the card): within K2's bar,
    4% of the largest output (tests/test_torch_kernels.py), and bitwise
    equal to K2's plain version on the stack."""
    c = layer_case(8, norm2, seed=rows * 3 + norm2, rows=rows)
    r8 = lambda a: jnp.asarray(np.broadcast_to(a[LAYER], (8, a.shape[1])))  # noqa: E731
    ref = ref_tp.mlp_block_megakernel_static(
        jnp.asarray(c["h"], jnp.bfloat16), jnp.asarray(c["gu_qw"][LAYER]),
        jnp.asarray(c["dn_qw"][LAYER]), r8(c["gu_s"]), r8(c["dn_s"]), r8(c["pln"]),
        r8(c["fsn"]) if norm2 else None, act=act, norm2=norm2, interpret=True)
    t = {k: to_t(c[k]) for k in ("gu_qw", "dn_qw", "gu_s", "dn_s")}
    pln = to_t(c["pln"], torch.bfloat16)
    fsn = to_t(c["fsn"], torch.bfloat16) if norm2 else None
    h = to_t(c["h"], torch.bfloat16)
    got = ternary_cuda.mlp_block_megakernel_static(
        h, t["gu_qw"][LAYER], t["dn_qw"][LAYER], t["gu_s"][LAYER], t["dn_s"][LAYER],
        pln[LAYER], None if fsn is None else fsn[LAYER], act=act, norm2=norm2)
    want = ternary_cuda.mlp_block_megakernel_plain(
        h, t["gu_qw"], t["dn_qw"], LAYER, t["gu_s"], t["dn_s"], pln, fsn, act=act, norm2=norm2)
    assert got.shape == (rows, H) and torch.equal(got, want)
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.all(np.abs(ref - got.float().numpy()) <= 0.04 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# split_layers_for_decode and forward's two other branches
# ---------------------------------------------------------------------------


def _configs(flavour):
    kw = {"relu2_subnorm": {}, "silu_nosub": {"sub_norms": False, "mlp_act": "silu"}}[flavour]
    return dataclasses.replace(RefConfig.tiny(), **kw), dataclasses.replace(BitNetConfig.tiny(), **kw)


def _port_params(rparams, cfg):
    return tb.fuse_projections(
        params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu"), cfg)


@pytest.mark.parametrize("flavour", ["relu2_subnorm", "silu_nosub"])
def test_split_layers_matches_reference(flavour):
    """The per-layer entries hold the reference's values: the same packed
    weights and column scales, and for the reference's 8-row broadcasts
    (``o``/``down`` scales, norms) their row 0. The port's entries are views
    of the stack (no copy)."""
    rcfg, cfg = _configs(flavour)
    rparams = rb.init_params(rcfg, seed=4)
    tparams = _port_params(rparams, cfg)
    ref = rb.split_layers_for_decode(rb.fuse_projections(rparams, rcfg), rcfg)["layers_split"]
    got = tb.split_layers_for_decode(tparams, cfg)["layers_split"]
    assert len(got) == len(ref) == cfg.num_layers
    for l, (r, g) in enumerate(zip(ref, got)):
        assert set(g) == set(r)
        for k, rv in r.items():
            rv = np.asarray(rv, np.float32) if rv.dtype != jnp.uint8 else np.asarray(rv)
            if rv.ndim == 2 and rv.shape[0] == 8 and not k.endswith("_qw"):
                rv = rv[0]  # an 8-row broadcast
            gv = g[k].float().numpy() if g[k].dtype != torch.uint8 else g[k].numpy()
            assert np.array_equal(np.broadcast_to(gv, rv.shape), rv), (l, k)
            assert g[k].data_ptr() == tparams["layers"][k][l].data_ptr(), (l, k)


def test_split_layers_requires_fused_params():
    cfg = BitNetConfig.tiny()
    params = tb.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="fuse_projections"):
        tb.split_layers_for_decode(params, cfg)
    with pytest.raises(ValueError, match="fuse_projections"):
        rb.split_layers_for_decode(rb.init_params(RefConfig.tiny(), seed=0), RefConfig.tiny())


@pytest.mark.parametrize("flavour", ["relu2_subnorm", "silu_nosub"])
@pytest.mark.parametrize("mode", ["split", "layer_mega"])
def test_forward_variant_matches_reference(mode, flavour, monkeypatch):
    """A 6-token prefill and 4 greedy decode steps through the unrolled
    split path or the layer megakernel vs the reference's forward in the
    same mode (its kernels in interpret mode; ``WF_LAYER_MEGA=1`` for the
    layer megakernel, as tests/test_pallas_kernels.py sets it), both
    teacher-forced with the reference's tokens: equal greedy tokens (except
    at a near-tie of the reference's logits), cosine > 0.999, the new cache
    row within 0.05."""
    rcfg, cfg = _configs(flavour)
    raw = rb.init_params(rcfg, seed=2)
    rparams, tparams = rb.fuse_projections(raw, rcfg), _port_params(raw, cfg)
    if mode == "split":
        rparams = rb.split_layers_for_decode(rparams, rcfg)
        tparams = tb.split_layers_for_decode(tparams, cfg)
    else:
        monkeypatch.setenv("WF_LAYER_MEGA", "1")
    lf = ref_tp.make_pallas_linear_fused(interpret=True, mega=True)
    tlf = ternary_cuda.make_linear_fused(layer_mega=mode == "layer_mega")
    assert hasattr(lf, "layer_mega") == hasattr(tlf, "layer_mega") == (mode == "layer_mega")
    T = 16
    rcache = rb.KVCache.zeros(rcfg, 1, T)
    tcache = tb.KVCache.zeros(cfg, 1, T, device="cpu")
    toks = np.asarray([[3, 1, 4, 1, 5, 9]], np.int32)
    rl, rcache = rb.forward(rparams, rcfg, jnp.asarray(toks), rcache, jnp.zeros((1,), jnp.int32),
                            linear_fn=lf, logits_all=False)
    tl, tcache = tb.forward(tparams, cfg, to_t(toks), tcache, torch.zeros(1, dtype=torch.int32),
                            linear_fn=tlf, logits_all=False)
    pos = toks.shape[1]
    for step in range(5):
        r = np.asarray(rl, np.float32)[0]
        g = tl.float().numpy()[0]
        assert (r * g).sum() / (np.linalg.norm(r) * np.linalg.norm(g)) > 0.999, step
        if int(r.argmax()) != int(g.argmax()):
            top2 = np.sort(r)[-2:]
            assert top2[1] - top2[0] < NEAR_TIE, f"step {step}: tokens differ off a near-tie"
        if step:
            rk = np.asarray(rcache.k[:, :, pos - 1], np.float32)
            assert np.allclose(rk, tcache.k[:, :, pos - 1].float().numpy(), atol=0.05)
        if step == 4:
            break
        tok = np.asarray([[int(r.argmax())]], np.int32)
        rl, rcache = rb.forward(rparams, rcfg, jnp.asarray(tok), rcache,
                                jnp.full((1,), pos, jnp.int32), linear_fn=lf, logits_all=False)
        tl, tcache = tb.forward(tparams, cfg, to_t(tok), tcache, torch.tensor([pos]),
                                linear_fn=tlf, logits_all=False)
        pos += 1


def _decode_run(params, cfg, lf, flat=False, steps=4):
    cache = tb.KVCache.zeros(cfg, 1, 16, device="cpu")
    if flat:
        cache = tb.flatten_cache_for_decode(cache)
    lo, cache = tb.forward(params, cfg, torch.tensor([[2, 7, 1, 8, 2]]), cache,
                           torch.zeros(1, dtype=torch.int32), linear_fn=lf, logits_all=False)
    out, pos = [lo], 5
    for _ in range(steps):
        lo, cache = tb.forward(params, cfg, lo.argmax(-1)[:, None], cache,
                               torch.tensor([pos], dtype=torch.int32), linear_fn=lf,
                               logits_all=False)
        out.append(lo)
        pos += 1
    return out, cache


@pytest.mark.parametrize("flat", [False, True], ids=["5d_cache", "flat_cache"])
@pytest.mark.parametrize("flavour", ["relu2_subnorm", "silu_nosub"])
def test_forward_variants_equal_default_branch(flavour, flat):
    """The unrolled split path and the layer megakernel against the default
    K5 + K2 branch of the port itself: the same functions on the same bytes,
    so the logits and the caches are bitwise equal (on the card the split
    path runs the same kernels, chip_smoke.py checks it there)."""
    _, cfg = _configs(flavour)
    params = tb.fuse_projections(tb.init_params(cfg, seed=6, device="cpu"), cfg)
    want, wc = _decode_run(params, cfg, ternary_cuda.make_linear_fused(), flat)
    for p, lf in ((tb.split_layers_for_decode(params, cfg), ternary_cuda.make_linear_fused()),
                  (params, ternary_cuda.make_linear_fused(layer_mega=True))):
        got, gc = _decode_run(p, cfg, lf, flat)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(gc.k, wc.k) and torch.equal(gc.v, wc.v)
        assert gc.k.dim() == (2 if flat else 5)


def test_split_depth_mismatch_raises():
    cfg = BitNetConfig.tiny()
    params = tb.split_layers_for_decode(
        tb.fuse_projections(tb.init_params(cfg, seed=0, device="cpu"), cfg), cfg)
    cut = dict(params, layers={k: v[:1] for k, v in params["layers"].items()})
    with pytest.raises(ValueError, match="layers_split"):
        _decode_run(cut, dataclasses.replace(cfg, num_layers=1),
                    ternary_cuda.make_linear_fused(), steps=1)


@pytest.mark.parametrize("flags", [["--split"], ["--layer-mega"]])
def test_bench_decode_modes_smoke(flags):
    """``python -m wrinklefree_tpu_torch.bench.decode --model tiny --device
    cpu`` with each mode: one JSON line recording the mode."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert bench_decode.main(["--model", "tiny", "--device", "cpu", "--prompt", "4",
                                  "--steps", "2", *flags]) == 0
    res = json.loads(buf.getvalue())
    assert res["split"] == ("--split" in flags)
    assert res["layer_mega"] == ("--layer-mega" in flags)
    assert res["platform"] == "cpu" and res["value"] > 0 and res["unit"] == "tok/s"
