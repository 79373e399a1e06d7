"""Loading weights: the port's safetensors reader and writer, ``models/loader.py``
and ``convert/{cache_key,convert,loader,validate}.py`` against the reference's.

Every model directory is written here from seed-made tiny weights (2 layers,
H 128): an HF-packed directory (``uint8 [out/4, in]`` + a bf16
``weight_scale``, bf16 norms and embedding), a float-ternary one (f32
projections, an f16 embedding), the reference's ``convert_and_save`` of the
first, and a Llama-family directory (SiLU, no sub-norms, an untied head).
The port's ``load_params`` must equal ``weights.params_from_numpy`` of the
reference's ``load_params`` on the same directory tensor for tensor, bit for
bit; the port's ``convert_and_save`` must write the reference's files byte
for byte; the port's safetensors files must read in the installed
``safetensors`` package and the other way round.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_file
from safetensors.numpy import save as st_save
from safetensors.numpy import save_file as st_save_file

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.convert import cache_key as ref_cache_key
from wrinklefree_tpu.convert import convert as ref_convert
from wrinklefree_tpu.convert import loader as ref_cloader
from wrinklefree_tpu.convert import validate as ref_validate
from wrinklefree_tpu.models import loader as ref_loader
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.convert import cache_key, convert, safetensors_io, validate
from wrinklefree_tpu_torch.convert import loader as cloader
from wrinklefree_tpu_torch.engine import Engine, SamplingParams
from wrinklefree_tpu_torch.models import loader
from wrinklefree_tpu_torch.weights import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
CFG_JSON = {
    "vocab_size": 256, "hidden_size": 128, "intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "head_dim": 32, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "max_position_embeddings": 256, "tie_word_embeddings": True,
    "hidden_act": "relu2", "model_type": "bitnet",
}
DIMS = {  # [out, in]
    "self_attn.q_proj": (128, 128), "self_attn.k_proj": (64, 128),
    "self_attn.v_proj": (64, 128), "self_attn.o_proj": (128, 128),
    "mlp.gate_proj": (256, 128), "mlp.up_proj": (256, 128),
    "mlp.down_proj": (128, 256),
}
NORM_DIMS = {"input_layernorm": 128, "post_attention_layernorm": 128,
             "self_attn.attn_sub_norm": 128, "mlp.ffn_sub_norm": 256}


def bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def hf_pack(w):
    """HF BitNet packing of ternary [out, in]: uint8 [out/4, in], the out
    axis in four planes, value+1 in bits (2i, 2i+1)."""
    o, i = w.shape
    planes = (w + 1).astype(np.uint8).reshape(4, o // 4, i)
    return planes[0] | (planes[1] << 2) | (planes[2] << 4) | (planes[3] << 6)


def write_model(d, fmt, seed=0):
    """A tiny model directory: fmt 'hf_packed', 'float_ternary', 'llama'
    (dense f32 projections, SiLU, no sub-norms, untied) or 'llama_ternary'
    (the same with ternary f32 projections)."""
    d = Path(d)
    d.mkdir(parents=True)
    cfg = dict(CFG_JSON)
    llama = fmt.startswith("llama")
    if llama:
        cfg.update(model_type="llama", hidden_act="silu", tie_word_embeddings=False)
    (d / "config.json").write_text(json.dumps(cfg))
    rng = np.random.default_rng(seed)
    t = {}
    emb = rng.normal(0, 0.02, (256, 128))
    t["model.embed_tokens.weight"] = (emb.astype(np.float16) if fmt == "float_ternary"
                                      else bf16(emb))
    t["model.norm.weight"] = bf16(rng.normal(1, 0.1, 128))
    if llama:
        t["lm_head.weight"] = bf16(rng.normal(0, 0.02, (256, 128)))
    for li in range(2):
        p = f"model.layers.{li}"
        for nm, (o, i) in DIMS.items():
            w = rng.integers(-1, 2, (o, i)).astype(np.int8)
            scale = rng.uniform(0.5, 3.0)
            if fmt == "hf_packed":
                t[f"{p}.{nm}.weight"] = hf_pack(w)
                t[f"{p}.{nm}.weight_scale"] = bf16([scale])
            elif fmt in ("float_ternary", "llama_ternary"):
                t[f"{p}.{nm}.weight"] = w.astype(np.float32)
                t[f"{p}.{nm}.weight_scale"] = np.asarray([scale], np.float32)
            else:
                t[f"{p}.{nm}.weight"] = rng.normal(0, 0.02, (o, i)).astype(np.float32)
        for nm, n in NORM_DIMS.items():
            if llama and "sub_norm" in nm:
                continue
            t[f"{p}.{nm}.weight"] = bf16(rng.normal(1, 0.1, n))
    st_save_file(t, str(d / "model.safetensors"))
    return d


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    out = {f: write_model(root / f, f) for f in ("hf_packed", "float_ternary")}
    out["packed_cache"] = ref_convert.convert_and_save(out["hf_packed"], root / "packed_cache")
    out["llama"] = ref_convert.convert_and_save(write_model(root / "llama_src", "llama"),
                                                root / "llama", ternarize=True)
    return out


def assert_params_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_params_equal(got[k], want[k], f"{path}{k}.")
            continue
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, path + k
        assert torch.equal(got[k], want[k]), f"{path}{k} differs"


def ref_params(path, cfg):
    params, _ = ref_loader.load_params(path)
    return params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")


def config_fields(c):
    return {k: v for k, v in dataclasses.asdict(c).items() if k != "dtype"}


@pytest.mark.parametrize("fmt", ["hf_packed", "float_ternary", "packed_cache", "llama"])
def test_load_params_matches_reference(dirs, fmt):
    params, cfg = loader.load_params(dirs[fmt], device="cpu")
    ref_cfg = RefConfig.from_hf_config(dirs[fmt])
    assert config_fields(cfg) == config_fields(ref_cfg)
    assert_params_equal(params, ref_params(dirs[fmt], cfg))
    assert ("lm_head" in params) == (fmt == "llama")


@pytest.mark.parametrize("overrides", [
    {}, {"model_type": "llama", "hidden_act": "silu", "tie_word_embeddings": False},
    {"hidden_act": "silu"}, {"model_type": "llama"}, {"tie_word_embeddings": False}])
def test_from_hf_config_matches_reference(tmp_path, overrides):
    (tmp_path / "config.json").write_text(json.dumps({**CFG_JSON, **overrides}))
    got, want = BitNetConfig.from_hf_config(tmp_path), RefConfig.from_hf_config(tmp_path)
    assert config_fields(got) == config_fields(want)
    assert (got.sub_norms, got.mlp_act, got.tie_word_embeddings) == (
        want.sub_norms, want.mlp_act, want.tie_word_embeddings)


def test_loaded_model_serves_like_the_carried_weights(dirs):
    """An Engine on the loaded params gives the greedy tokens of an Engine
    on the reference's loaded params carried over."""
    params, cfg = loader.load_params(dirs["hf_packed"], device="cpu")
    ecfg = EngineConfig(max_batch_slots=2, page_size=8, num_pages=32, max_context=64,
                        prefill_buckets=(8, 16, 32))
    outs = []
    for p in (params, ref_params(dirs["hf_packed"], cfg)):
        eng = Engine(p, cfg, ecfg, device="cpu")
        outs.append([eng.generate(list(range(1, 1 + n)), SamplingParams(max_new_tokens=6))
                     .output_ids for n in (5, 17)])
    assert outs[0] == outs[1]


# -- safetensors -------------------------------------------------------------

SAMPLE = {
    "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
    "f16": np.linspace(-1, 1, 5).astype(np.float16),
    "bf16": bf16(np.linspace(-2, 2, 7)),
    "u16": np.arange(4, dtype=np.uint16),
    "u8": np.arange(12, dtype=np.uint8).reshape(3, 4),
    "i8": np.arange(-3, 3, dtype=np.int8),
    "i32": np.arange(3, dtype=np.int32),
    "i64": np.arange(2, dtype=np.int64),
    "t_view": np.arange(12, dtype=np.float32).reshape(3, 4).T,  # F-ordered
    "empty": np.zeros((0, 4), np.float32),
}


# (one metadata key: the package writes several in its hash map's order)
@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_safetensors_writer_is_the_package_s(tmp_path, metadata):
    """The port's writer gives the installed package's bytes, and each reads
    the other's file: BF16 as uint16 bits in the port (tagged, so it is
    written back as BF16), U16 as U16."""
    path = tmp_path / "port.safetensors"
    safetensors_io.save_file(SAMPLE, path, metadata=metadata)
    assert path.read_bytes() == st_save({k: np.ascontiguousarray(v) for k, v in SAMPLE.items()},
                                        metadata=metadata)
    theirs = st_load_file(str(path))
    ours = safetensors_io.load_file(path)
    assert safetensors_io.read_header(path)[0].get("__metadata__", {}) == (metadata or {})
    for k, v in SAMPLE.items():
        np.testing.assert_array_equal(theirs[k], v)
        assert theirs[k].dtype == v.dtype
        want = v.view(np.uint16) if k == "bf16" else v
        assert ours[k].dtype == want.dtype and np.array_equal(ours[k], want), k
    assert safetensors_io.dtype_name(ours["bf16"]) == "BF16"
    assert safetensors_io.dtype_name(ours["u16"]) == "U16"
    again = tmp_path / "again.safetensors"
    safetensors_io.save_file(ours, again, metadata=metadata)
    assert again.read_bytes() == path.read_bytes()


def test_safetensors_reader_rejects_bad_files(tmp_path):
    f = tmp_path / "short.safetensors"
    f.write_bytes(b"\x01\x00")
    with pytest.raises(ValueError):
        safetensors_io.load_file(f)
    good = tmp_path / "good.safetensors"
    st_save_file({"x": np.arange(4, dtype=np.float32)}, str(good))
    raw = bytearray(good.read_bytes())
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(bytes(raw[:-4]))  # data cut short
    with pytest.raises(ValueError, match="offsets"):
        safetensors_io.load_file(bad)


# -- convert_and_save ----------------------------------------------------------

@pytest.mark.parametrize("src,ternarize", [("hf_packed", False), ("float_ternary", False),
                                           ("llama_src", True)])
def test_convert_and_save_writes_the_reference_files(dirs, tmp_path, src, ternarize):
    """The same files byte for byte (names, dtypes, bytes; BF16 stays BF16),
    and each package loads the other's output to the same params."""
    source = dirs["llama"].parent / src if src == "llama_src" else dirs[src]
    ref_out = ref_convert.convert_and_save(source, tmp_path / "ref", ternarize=ternarize)
    out = convert.convert_and_save(source, tmp_path / "port", ternarize=ternarize)
    names = sorted(p.name for p in ref_out.iterdir())
    assert names == sorted(p.name for p in out.iterdir())
    for n in names:
        assert (out / n).read_bytes() == (ref_out / n).read_bytes(), n
    header, _ = safetensors_io.read_header(out / "model.safetensors")
    assert header["model.norm.weight"]["dtype"] == "BF16"
    cfg = BitNetConfig.from_hf_config(out)
    assert_params_equal(loader.load_params(ref_out, device="cpu")[0], ref_params(out, cfg))


def test_convert_keeps_u16_tensors_u16(tmp_path):
    """A U16 tensor (bf16 bits written as plain uint16) is copied as U16 by
    both packages, and loads through _to_float as bf16 bits in both."""
    src = write_model(tmp_path / "src", "hf_packed")
    t = st_load_file(str(src / "model.safetensors"))
    t["model.norm.weight"] = t["model.norm.weight"].view(np.uint16)
    st_save_file(t, str(src / "model.safetensors"))
    ref_out = ref_convert.convert_and_save(src, tmp_path / "ref")
    out = convert.convert_and_save(src, tmp_path / "port")
    assert (out / "model.safetensors").read_bytes() == (ref_out / "model.safetensors").read_bytes()
    header, _ = safetensors_io.read_header(out / "model.safetensors")
    assert header["model.norm.weight"]["dtype"] == "U16"
    cfg = BitNetConfig.from_hf_config(out)
    assert_params_equal(loader.load_params(out, device="cpu")[0], ref_params(out, cfg))


def test_convert_preserves_logits_exactly(dirs, tmp_path):
    """tests/test_convert.py's check on the port: the packed cache of a
    model loads to the model's own params."""
    for src in ("hf_packed", "float_ternary"):
        out = convert.convert_and_save(dirs[src], tmp_path / src)
        meta = json.loads((out / "cache_metadata.json").read_text())
        assert meta["format_version"] == cache_key.PACK_FORMAT and meta["packed_tensors"] == 14
        assert_params_equal(loader.load_params(out, device="cpu")[0],
                            loader.load_params(dirs[src], device="cpu")[0])


# -- cache key, cache, validation ---------------------------------------------

def test_cache_key_matches_reference(dirs, tmp_path):
    d = dirs["hf_packed"]
    for rev in (None, "v2"):
        assert cache_key.compute_cache_key(str(d), rev) == ref_cache_key.compute_cache_key(
            str(d), rev)
    assert cache_key.compute_cache_key(str(d)) != cache_key.compute_cache_key(str(d), "v2")
    e = write_model(tmp_path / "edit", "hf_packed")
    k0 = cache_key.compute_cache_key(str(e))
    (e / "config.json").write_text(json.dumps({**CFG_JSON, "vocab_size": 512}))
    assert cache_key.compute_cache_key(str(e)) != k0
    assert len(cache_key.compute_cache_key("microsoft/bitnet-b1.58-2B-4T")) == 16
    assert cache_key.PACK_FORMAT == ref_cache_key.PACK_FORMAT


def test_get_cached_or_convert_and_list(dirs, tmp_path, monkeypatch):
    """A local hit (no second conversion), a miss under WF_SKIP_GCS=1 that
    converts, and list_cached_models as the reference lists the same cache."""
    cache = tmp_path / "cache"
    monkeypatch.setattr(cloader, "LOCAL_CACHE", cache)
    monkeypatch.setattr(ref_cloader, "LOCAL_CACHE", cache)
    monkeypatch.setenv("WF_SKIP_GCS", "1")
    assert cloader.list_cached_models() == []
    src = str(dirs["hf_packed"])
    out1 = cloader.get_cached_or_convert(src)  # miss: the GCS cache is off
    assert (out1 / "cache_metadata.json").exists() and out1.parent == cache
    (out1 / "sentinel").write_text("x")
    out2 = cloader.get_cached_or_convert(src, skip_gcs=True)
    assert out2 == out1 and (out2 / "sentinel").exists()
    assert ref_cloader.get_cached_or_convert(src, skip_gcs=True) == out1
    listed = cloader.list_cached_models()
    assert listed == ref_cloader.list_cached_models() and len(listed) == 1
    assert listed[0].startswith(out1.name) and cache_key.PACK_FORMAT in listed[0]


def test_gcs_cache_is_a_miss_without_the_library(monkeypatch):
    from wrinklefree_tpu_torch.convert.gcs import GCSModelCache

    monkeypatch.setenv("WF_SKIP_GCS", "1")
    g = GCSModelCache()
    assert not g.enabled and not g.exists("k") and g.download("k", Path("x")) is None
    monkeypatch.setenv("WF_SKIP_GCS", "0")
    monkeypatch.setitem(sys.modules, "google.cloud", None)
    g = GCSModelCache()
    assert not g.exists("k") and not g.upload("k", Path("x")) and not g.enabled


def _break(d, how):
    if how == "no_config":
        (d / "config.json").unlink()
    elif how == "dense":
        t = st_load_file(str(d / "model.safetensors"))
        t["model.layers.1.mlp.up_proj.weight"] = np.full((256, 128), 0.3, np.float32)
        st_save_file(t, str(d / "model.safetensors"))
    elif how == "shape":
        t = st_load_file(str(d / "model.safetensors"))
        t["model.layers.0.self_attn.q_proj.weight"] = np.zeros((16, 128), np.uint8)
        del t["model.embed_tokens.weight"]
        st_save_file(t, str(d / "model.safetensors"))
    return d


@pytest.mark.parametrize("fmt,how", [
    ("hf_packed", None), ("float_ternary", None), ("packed_cache", None), ("llama", None),
    ("float_ternary", "no_config"), ("float_ternary", "dense"), ("hf_packed", "shape")])
def test_validate_model_matches_reference(dirs, tmp_path, fmt, how):
    d = dirs[fmt]
    if how:
        d = _break(write_model(tmp_path / "m", fmt), how)
    rep = validate.validate_model(d)
    assert rep == ref_validate.validate_model(d)
    assert rep["valid"] == (how is None)


def test_load_tokenizer_needs_transformers(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        loader.load_tokenizer(tmp_path)


def test_loaders_import_no_reference_stack():
    """The loaders import none of jax, the reference, safetensors,
    transformers or huggingface_hub, and load on a host without them."""
    code = """
import sys
for m in ("jax", "safetensors", "transformers", "huggingface_hub", "ml_dtypes"):
    sys.modules[m] = None
import wrinklefree_tpu_torch.convert, wrinklefree_tpu_torch.models.loader
import wrinklefree_tpu_torch.server.http, wrinklefree_tpu_torch.cli
print(sorted(m for m in sys.modules if m.split(".")[0] == "wrinklefree_tpu"))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.strip()
    assert out == "[]"
