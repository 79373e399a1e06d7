"""Which prefill attention the paged forward takes, in the port and in the
JAX reference, for the same chunk.

The reference runs its kernel path (``kv_write="pallas"``, as its Engine runs
on a TPU), where the flash prefill is taken only for chunks of 128 tokens or
more whose table width times the page size plus the chunk is a multiple of
128 (``wrinklefree_tpu/kv/paged.py::paged_forward``); the plain gather
attention otherwise. Its in-place row writer ``kv_write_pallas`` is a TPU DMA
kernel with no interpret mode, so for this test only it is replaced by a
scatter of the same rows (``.at[ids, offsets].set``, the reference's own
``kv_write="xla"`` write), and its flash prefill runs in interpret mode.
Recording wrappers around both packages' ``_paged_attention_dual_flash`` and
``_paged_attention_dual`` name the path taken.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
import wrinklefree_tpu.ops.flash_attention as ref_flash
import wrinklefree_tpu.ops.kv_update_pallas as ref_kv_update
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.kv import paged as ref_paged
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu_torch.config import BitNetConfig
from wrinklefree_tpu_torch.kv import paged
from wrinklefree_tpu_torch.weights import params_from_numpy

PATHS = ("_paged_attention_dual_flash", "_paged_attention_dual")


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, ref_init(RefConfig.tiny(), seed=0))


def _scatter_rows(pool, vals, flat_ids, offsets, rows_per_program=64):
    """pool[flat_ids[i], offsets[i]] = vals[i]: the rows kv_write_pallas writes."""
    return pool.at[flat_ids, offsets].set(vals.astype(pool.dtype))


def _spy(monkeypatch, module, log):
    for name in PATHS:
        orig = getattr(module, name)

        def wrapper(*args, _orig=orig, _name=name, **kw):
            log.append(_name)
            return _orig(*args, **kw)

        monkeypatch.setattr(module, name, wrapper)


# (page size, table width, chunk): ps 8 and 16 at the engine's power-of-two
# widths meet the reference's condition, as does ps 24 with a 192-token
# chunk; ps 24 and 40 at the engine's chunks of 128 rounded up to a page do
# not (192 + 144, 320 + 160); the last chunk is below 128 tokens.
CASES = [
    (8, 16, 128),   # 128 + 128
    (8, 32, 256),   # 256 + 256
    (16, 8, 128),   # 128 + 128
    (24, 8, 192),   # 192 + 192 = 384
    (24, 8, 144),   # 192 + 144 = 336
    (40, 8, 160),   # 320 + 160 = 480
    (8, 16, 64),    # a short chunk
]


def test_page_size_12_refused_by_both():
    """Page size 12 (a 16-page table and 132-token chunks in the engine)
    never reaches the dispatch: both packages' dual layout refuses a page
    size that is not a multiple of 8."""
    with pytest.raises(ValueError, match="page_size % 8"):
        ref_paged.PagedKV.zeros_dual(RefConfig.tiny(), 18, 12, num_slots=1)
    with pytest.raises(ValueError, match="page_size % 8"):
        paged.PagedKV.zeros_dual(BitNetConfig.tiny(), 18, 12, 1, device="cpu")


@pytest.mark.parametrize("ps,mp,s", CASES)
def test_prefill_dispatch_matches_reference(weights, monkeypatch, ps, mp, s):
    rcfg, cfg = RefConfig.tiny(), BitNetConfig.tiny()
    monkeypatch.setattr(ref_kv_update, "kv_write_pallas", _scatter_rows)
    monkeypatch.setattr(ref_flash, "flash_paged_prefill",
                        functools.partial(ref_flash.flash_paged_prefill, interpret=True))
    ref_log, port_log = [], []
    _spy(monkeypatch, ref_paged, ref_log)
    _spy(monkeypatch, paged, port_log)

    P = mp + 2
    rng = np.random.default_rng(ps * 1000 + s)
    toks = rng.integers(1, cfg.vocab_size, (1, s)).astype(np.int32)
    pt = np.arange(1, mp + 1, dtype=np.int32)[None]
    n = s - ps // 2  # a partial last page, left in staging
    r_pools = ref_paged.PagedKV.zeros_dual(rcfg, P, ps, num_slots=1)
    lo_r, _ = ref_paged.paged_forward(
        jax.tree.map(jnp.asarray, weights), rcfg, jnp.asarray(toks), r_pools, jnp.asarray(pt),
        jnp.asarray([0]), jnp.asarray([n]), kv_write="pallas", slot_ids=jnp.asarray([0]))
    p_pools = paged.PagedKV.zeros_dual(cfg, P, ps, 1, device="cpu")
    lo_p, _ = paged.paged_forward(
        params_from_numpy(weights, cfg, device="cpu"), cfg, torch.from_numpy(toks), p_pools,
        torch.from_numpy(pt), torch.tensor([0]), torch.tensor([n]),
        slot_ids=torch.tensor([0]))

    want = "_paged_attention_dual_flash" if s >= 128 and (mp * ps + s) % 128 == 0 \
        else "_paged_attention_dual"
    # the reference traces its layer step once (a scan over the layers); the
    # port calls its attention once per layer
    assert ref_log and set(ref_log) == {want}
    assert port_log == [want] * cfg.num_layers
    assert np.isfinite(np.asarray(lo_r)).all() and torch.isfinite(lo_p).all()


PORT_PATHS = ("_paged_attention_dual_flash", "_paged_attention_dual_flash_decode",
              "_paged_attention_dual", "_paged_attention_token_flash", "_paged_attention_token")


@pytest.mark.parametrize("layout", ["layer", "token"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "fp16", "f32", "int8", "fp8_e4m3", "fp8_e5m2"])
def test_kernel_dispatch_by_kv_dtype(weights, monkeypatch, layout, kv_dtype):
    """As the reference's kernel path (its ``kv_write="pallas"`` proxy for
    unquantized pools): every unquantized pool, whatever its dtype, takes
    K4 for a 128-token chunk over a 128-token table and, on the dual
    layout with ``flash_decode``, K6 for a decode step; quantized pools
    take the plain gather attention for both."""
    cfg = BitNetConfig.tiny()
    log = []
    for name in PORT_PATHS:
        orig = getattr(paged, name)
        monkeypatch.setattr(paged, name, lambda *a, _o=orig, _n=name, **k: log.append(_n)
                            or _o(*a, **k))
    params = params_from_numpy(weights, cfg, device="cpu")
    pools = (paged.PagedKV.zeros_dual(cfg, 18, 8, 1, kv_dtype, device="cpu")
             if layout == "layer" else paged.PagedKV.zeros(cfg, 18, 8, kv_dtype, device="cpu"))
    pt = torch.arange(1, 17, dtype=torch.int32)[None]
    toks = torch.from_numpy(np.random.default_rng(3).integers(1, cfg.vocab_size, (1, 128)))
    kw = dict(slot_ids=torch.tensor([0]), flash_decode=True)
    lo, pools = paged.paged_forward(params, cfg, toks, pools, pt, torch.tensor([0]),
                                    torch.tensor([100]), **kw)
    lo2, _ = paged.paged_forward(params, cfg, toks[:, :1], pools, pt, torch.tensor([100]),
                                 torch.tensor([1]), **kw)
    unq = kv_dtype in ("bf16", "fp16", "f32")
    prefill, decode = {
        ("layer", True): ("_paged_attention_dual_flash", "_paged_attention_dual_flash_decode"),
        ("layer", False): ("_paged_attention_dual", "_paged_attention_dual"),
        ("token", True): ("_paged_attention_token_flash", "_paged_attention_token"),
        ("token", False): ("_paged_attention_token", "_paged_attention_token"),
    }[layout, unq]
    assert log == [prefill] * cfg.num_layers + [decode] * cfg.num_layers
    assert torch.isfinite(lo).all() and torch.isfinite(lo2).all()
