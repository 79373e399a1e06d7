"""GGUF: the port's ``convert/gguf.py`` against the reference's, and
``ops.ternary``'s i2_s packing.

The cases of ``tests/test_gguf.py`` on the port (writer round trip, metadata
types, missing / too small / wrong magic files, llama.cpp names, i2_s,
tl1/tl2 and f16 export, the i2_s byte spec, a BitNet.cpp-style artifact,
GGUF against the safetensors load, f16 rejected), and files written by
either package read identically in the other: the port's export is the
reference's byte for byte, and ``load_params_gguf`` of either file equals
``weights.params_from_numpy`` of the reference's ``load_params_gguf`` bit
for bit.
"""

import struct

import jax
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests.test_torch_loader import assert_params_equal, write_model
from wrinklefree_tpu.convert import gguf as ref_gguf
from wrinklefree_tpu.ops import ternary as ref_ternary
from wrinklefree_tpu_torch.convert import gguf
from wrinklefree_tpu_torch.convert.gguf import (
    GGML_F16,
    GGML_F32,
    GGML_I2_S,
    convert_hf_to_gguf,
    hf_name_to_gguf,
    load_params_gguf,
    read_gguf,
    validate_gguf,
    write_gguf,
)
from wrinklefree_tpu_torch.models import loader
from wrinklefree_tpu_torch.models.bitnet import KVCache, forward
from wrinklefree_tpu_torch.ops.ternary import pack_i2s_np, unpack_i2s_np, unpack_ternary_np
from wrinklefree_tpu_torch.weights import params_from_numpy


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("gguf") / "hf", "hf_packed")


def ref_gguf_params(path, cfg):
    params, _ = ref_gguf.load_params_gguf(path)
    return params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")


class TestWriter:
    def test_roundtrip_f32(self, tmp_path):
        rng = np.random.default_rng(0)
        t = {
            "a.weight": (rng.normal(size=(4, 8)).astype(np.float32), GGML_F32),
            "b.weight": (rng.normal(size=(16,)).astype(np.float16), GGML_F16),
        }
        p = write_gguf(tmp_path / "m.gguf", {"general.architecture": "bitnet"}, t)
        meta, rt = read_gguf(p)
        assert meta["general.architecture"] == "bitnet"
        for k, (arr, gt) in t.items():
            got, gt2 = rt[k]
            assert gt2 == gt
            np.testing.assert_array_equal(got, arr)
        # the reference reads the port's file, and writes the same bytes
        _, rt_ref = ref_gguf.read_gguf(p)
        for k, (arr, gt) in t.items():
            np.testing.assert_array_equal(rt_ref[k][0], arr)
        ref_p = ref_gguf.write_gguf(tmp_path / "r.gguf", {"general.architecture": "bitnet"}, t)
        assert ref_p.read_bytes() == p.read_bytes()

    def test_metadata_types(self, tmp_path):
        p = write_gguf(
            tmp_path / "m.gguf",
            {"i": 7, "f": 2.5, "s": "hello", "b": True},
            {"t": (np.zeros((2, 2), np.float32), GGML_F32)},
        )
        meta, _ = read_gguf(p)
        assert meta["i"] == 7 and meta["s"] == "hello" and meta["b"] is True
        assert abs(meta["f"] - 2.5) < 1e-6
        assert ref_gguf.read_gguf(p)[0] == meta

    def test_every_value_type_and_arrays(self, tmp_path):
        """The reader takes all thirteen GGUF value types, arrays of scalars
        and of strings included (a BitNet.cpp file's tokenizer vocabulary is
        an array); the writer refuses a value it has no type for."""
        def s(x):
            b = x.encode()
            return struct.pack("<Q", len(b)) + b

        kvs = [("u8", 0, "<B", 200), ("i8", 1, "<b", -5), ("u16", 2, "<H", 60000),
               ("i16", 3, "<h", -300), ("u32", 4, "<I", 70000), ("i32", 5, "<i", -70000),
               ("f32", 6, "<f", 0.5), ("bool", 7, "<?", False), ("u64", 10, "<Q", 2**40),
               ("i64", 11, "<q", -(2**40)), ("f64", 12, "<d", 0.1)]
        body = b"".join(s(k) + struct.pack("<I", vt) + struct.pack(fmt, v)
                        for k, vt, fmt, v in kvs)
        body += s("str") + struct.pack("<I", 8) + s("héllo")
        body += s("arr_i32") + struct.pack("<IIQ", 9, 5, 3) + struct.pack("<3i", 1, -2, 3)
        body += s("arr_str") + struct.pack("<IIQ", 9, 8, 2) + s("<s>") + s("</s>")
        head = b"GGUF" + struct.pack("<IQQ", 3, 0, len(kvs) + 3)
        f = tmp_path / "kv.gguf"
        f.write_bytes(head + body)
        meta, tensors = read_gguf(f)
        assert tensors == {}
        for k, _, _, v in kvs:
            assert meta[k] == v, k
        assert meta["str"] == "héllo" and meta["arr_i32"] == [1, -2, 3]
        assert meta["arr_str"] == ["<s>", "</s>"]
        with pytest.raises(TypeError):
            write_gguf(tmp_path / "x.gguf", {"toks": ["a", "b"]}, {})


class TestValidation:
    def test_missing_file(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            validate_gguf(tmp_path / "nope.gguf")

    def test_too_small(self, tmp_path):
        f = tmp_path / "small.gguf"
        f.write_bytes(b"GGUF" + b"\x00" * 16)
        with pytest.raises(ValueError, match="too small"):
            validate_gguf(f, min_size_bytes=1024)

    def test_wrong_magic(self, tmp_path):
        f = tmp_path / "bad.gguf"
        f.write_bytes(b"NOPE" + b"\x00" * 2048)
        with pytest.raises(ValueError, match="Invalid GGUF magic"):
            validate_gguf(f)
        with pytest.raises(ValueError, match="Invalid GGUF magic"):
            read_gguf(f)

    def test_valid_file_stats(self, tmp_path):
        p = write_gguf(tmp_path / "ok.gguf", {},
                       {"t": (np.zeros((64, 64), np.float32), GGML_F32)})
        info = validate_gguf(p)
        assert info["version"] == 3 and info["n_tensors"] == 1
        assert info == ref_gguf.validate_gguf(p)


class TestNameMapping:
    def test_known_names(self):
        assert hf_name_to_gguf("model.embed_tokens.weight") == "token_embd.weight"
        assert hf_name_to_gguf("model.norm.weight") == "output_norm.weight"
        assert hf_name_to_gguf("model.layers.3.self_attn.q_proj.weight") == "blk.3.attn_q.weight"
        assert (hf_name_to_gguf("model.layers.12.mlp.ffn_sub_norm.weight")
                == "blk.12.ffn_sub_norm.weight")
        assert hf_name_to_gguf("rotary.inv_freq") is None
        for name in ("lm_head.weight", "model.layers.0.mlp.down_proj.weight",
                     "model.layers.7.post_attention_layernorm.weight"):
            assert hf_name_to_gguf(name) == ref_gguf.hf_name_to_gguf(name)


class TestHFConversion:
    @pytest.mark.parametrize("qt", ["i2_s", "tl1", "tl2", "f16", "f32"])
    def test_export_is_the_reference_s(self, src, tmp_path, qt):
        """The port's export of a model equals the reference's byte for byte."""
        out = convert_hf_to_gguf(src, tmp_path / "p.gguf", quant_type=qt)
        ref = ref_gguf.convert_hf_to_gguf(src, tmp_path / "r.gguf", quant_type=qt)
        assert out.read_bytes() == ref.read_bytes()

    def test_i2s_export_roundtrips_exactly(self, tmp_path):
        d = write_model(tmp_path / "ft", "float_ternary")
        out = convert_hf_to_gguf(d, tmp_path / "m.gguf", quant_type="i2_s")
        info = validate_gguf(out)
        # 2 layers x (7 proj + 7 scales + 4 norms) + embed + final norm
        assert info["n_tensors"] == 2 * 18 + 2
        meta, tensors = read_gguf(out)
        assert meta["general.architecture"] == "bitnet" and meta["llama.block_count"] == 2
        src_w = loader._load_safetensors_dir(d)["model.layers.0.self_attn.q_proj.weight"]
        qw, gt = tensors["blk.0.attn_q.weight"]
        assert gt == GGML_I2_S and meta["bitnet.i2s_layout"] == "ggml"
        np.testing.assert_array_equal(unpack_i2s_np(qw).astype(np.float32), src_w)

    @pytest.mark.parametrize("qt,want_id", [("tl1", 31), ("tl2", 32)])
    def test_tl_export_loads_identically_to_i2s(self, src, tmp_path, qt, want_id):
        out_i = convert_hf_to_gguf(src, tmp_path / "i.gguf", quant_type="i2_s")
        out_t = convert_hf_to_gguf(src, tmp_path / "t.gguf", quant_type=qt)
        meta, tensors = read_gguf(out_t)
        assert tensors["blk.0.attn_q.weight"][1] == want_id and meta["bitnet.quant_type"] == qt
        pi, ci = load_params_gguf(out_i, device="cpu")
        pt, ct = load_params_gguf(out_t, device="cpu")
        assert ci == ct
        assert_params_equal(pt, pi)

    def test_f16_export(self, src, tmp_path):
        out = convert_hf_to_gguf(src, tmp_path / "m16.gguf", quant_type="f16")
        w, gt = read_gguf(out)[1]["blk.0.attn_q.weight"]
        assert gt == GGML_F16 and w.dtype == np.float16 and w.shape == (128, 128)


class TestI2SByteConformance:
    @staticmethod
    def _spec_pack(ternary_nk: np.ndarray) -> np.ndarray:
        # the BitNet quantizer's loop: groups of 32, strided i::4, shift 6-2i
        out_features, in_features = ternary_nk.shape
        enc = (ternary_nk + 1).astype(np.uint8).reshape(out_features, -1, 32)
        packed = np.zeros((out_features, in_features // 4), np.uint8)
        for i in range(4):
            packed |= enc[:, :, i::4].reshape(out_features, -1) << (6 - 2 * i)
        return packed

    def test_pack_matches_spec_and_reference(self):
        rng = np.random.default_rng(7)
        w = rng.integers(-1, 2, size=(16, 64)).astype(np.int8)
        np.testing.assert_array_equal(pack_i2s_np(w), self._spec_pack(w))
        np.testing.assert_array_equal(pack_i2s_np(w), ref_ternary.pack_i2s_np(w))
        np.testing.assert_array_equal(unpack_i2s_np(self._spec_pack(w)), w)
        np.testing.assert_array_equal(unpack_i2s_np(pack_i2s_np(w)),
                                      ref_ternary.unpack_i2s_np(pack_i2s_np(w)))
        with pytest.raises(ValueError):
            pack_i2s_np(w[:, :6])

    @pytest.mark.parametrize("quant_type,gtype,marker", [
        ("i2_s", GGML_I2_S, True),   # the export's convention (id 36 + marker)
        ("i2_s", 30, False),         # the I2_S id of the BitNet enum
        ("tl1", 31, False),
        ("tl2", 32, False),
        ("i2_s", GGML_I2_S, None),   # legacy: id 36 without marker, plane-major bytes
    ])
    def test_bitnetcpp_style_artifact_loads(self, tmp_path, quant_type, gtype, marker):
        """A GGUF whose ternary payloads come from the spec packer (standing
        in for a BitNet.cpp artifact) loads to the exact source ternary in
        both packages, to bit-equal params; without the layout marker an
        id-36 payload is the legacy plane-major layout, used as it is."""
        from wrinklefree_tpu_torch.ops.ternary import pack_ternary_np

        rng = np.random.default_rng(8)
        H, I, NH, NKV, D, V, L = 64, 128, 4, 2, 16, 96, 2
        meta = {
            "general.architecture": "bitnet", "general.name": "spec-fixture",
            "bitnet.quant_type": quant_type, "llama.context_length": 64,
            "llama.embedding_length": H, "llama.block_count": L,
            "llama.feed_forward_length": I, "llama.attention.head_count": NH,
            "llama.attention.head_count_kv": NKV, "llama.attention.key_length": D,
            "llama.rope.freq_base": 10000.0, "llama.attention.layer_norm_rms_epsilon": 1e-5,
            "llama.vocab_size": V,
        }
        if marker:
            meta["bitnet.i2s_layout"] = "ggml"
        dims = {"attn_q.weight": (NH * D, H), "attn_k.weight": (NKV * D, H),
                "attn_v.weight": (NKV * D, H), "attn_output.weight": (H, NH * D),
                "ffn_gate.weight": (I, H), "ffn_up.weight": (I, H), "ffn_down.weight": (H, I)}
        short_by_g = {"attn_q.weight": "q", "attn_k.weight": "k", "attn_v.weight": "v",
                      "attn_output.weight": "o", "ffn_gate.weight": "gate",
                      "ffn_up.weight": "up", "ffn_down.weight": "down"}
        tensors = {
            "token_embd.weight": (rng.normal(size=(V, H)).astype(np.float16), GGML_F16),
            "output_norm.weight": (rng.normal(1, 0.1, (H,)).astype(np.float16), GGML_F16),
        }
        truth = {}
        for li in range(L):
            for g, (n, k) in dims.items():
                w = rng.integers(-1, 2, size=(n, k)).astype(np.int8)
                truth[(li, g)] = w
                payload = self._spec_pack(w) if marker is not None else pack_ternary_np(w.T)
                tensors[f"blk.{li}.{g}"] = (payload, gtype)
                tensors[f"blk.{li}.{g}.scale"] = (np.asarray([2.5], np.float32), GGML_F32)
            for nm, dim in (("attn_norm", H), ("ffn_norm", H), ("attn_sub_norm", NH * D),
                            ("ffn_sub_norm", I)):
                tensors[f"blk.{li}.{nm}.weight"] = (
                    rng.normal(1, 0.1, (dim,)).astype(np.float16), GGML_F16)
        path = write_gguf(tmp_path / "spec.gguf", meta, tensors)

        params, cfg = load_params_gguf(path, device="cpu")
        assert cfg.num_layers == L and cfg.hidden_size == H and cfg.tie_word_embeddings
        for li in range(L):
            for g in dims:
                short = short_by_g[g]
                got = unpack_ternary_np(params["layers"][f"{short}_qw"][li].numpy())
                np.testing.assert_array_equal(got.T, truth[(li, g)], err_msg=f"{li} {g}")
                assert float(params["layers"][f"{short}_scale"][li]) == 2.5
        assert_params_equal(params, ref_gguf_params(path, cfg))


class TestGGUFLoad:
    @pytest.mark.parametrize("writer", ["port", "reference"])
    @pytest.mark.parametrize("qt", ["i2_s", "tl1"])
    def test_either_package_s_file_loads_identically(self, src, tmp_path, writer, qt):
        conv = convert_hf_to_gguf if writer == "port" else ref_gguf.convert_hf_to_gguf
        out = conv(src, tmp_path / "m.gguf", quant_type=qt)
        params, cfg = load_params_gguf(out, device="cpu")
        assert_params_equal(params, ref_gguf_params(out, cfg))

    def test_untied_llama_gguf(self, tmp_path):
        """A Llama-family export (no sub-norms, an output tensor) loads with
        placeholder sub-norms, an untied head and SiLU, as the reference's."""
        d = write_model(tmp_path / "l", "llama_ternary")
        out = convert_hf_to_gguf(d, tmp_path / "l.gguf", quant_type="i2_s")
        params, cfg = load_params_gguf(out, device="cpu")
        assert not cfg.tie_word_embeddings and cfg.mlp_act == "silu" and not cfg.sub_norms
        assert "lm_head" in params
        assert_params_equal(params, ref_gguf_params(out, cfg))

    def test_gguf_roundtrip_matches_safetensors_load(self, src, tmp_path):
        """Projections and scales bit-equal to the safetensors load; embed
        and norms pass through f16, so the logits agree to f16 precision."""
        out = convert_hf_to_gguf(src, tmp_path / "m.gguf", quant_type="i2_s")
        p_st, cfg_st = loader.load_params(src, device="cpu")
        p_gg, cfg_gg = load_params_gguf(out, device="cpu")
        assert (cfg_gg.num_layers, cfg_gg.hidden_size, cfg_gg.sub_norms) == (
            cfg_st.num_layers, cfg_st.hidden_size, cfg_st.sub_norms)
        for k, v in p_st["layers"].items():
            if k.endswith(("_qw", "_scale")):
                assert torch.equal(p_gg["layers"][k], v), k
        toks = torch.tensor([[1, 5, 9, 2]])
        outs = []
        for p, c in ((p_st, cfg_st), (p_gg, cfg_gg)):
            lg, _ = forward(p, c, toks, KVCache.zeros(c, 1, 8, device="cpu"),
                            torch.zeros((1,), dtype=torch.int32))
            outs.append(lg.float().numpy())
        np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=2e-2)
        np.testing.assert_array_equal(outs[0].argmax(-1), outs[1].argmax(-1))

    @pytest.mark.parametrize("qt", ["i2_s", "tl2"])
    def test_packed_cache_gguf_loads_as_its_hf_directory_s(self, src, tmp_path, qt):
        """The GGUF of a packed cache (``convert_and_save``'s output, whose
        projections are ``.qweight``) holds every projection and loads equal
        to the GGUF of the HF directory it came from."""
        from wrinklefree_tpu_torch.convert.convert import convert_and_save

        cache = convert_and_save(str(src), tmp_path / "cache")
        assert any(k.endswith(".qweight") for k in loader._load_safetensors_dir(cache))
        out_c = convert_hf_to_gguf(cache, tmp_path / "c.gguf", quant_type=qt)
        out_h = convert_hf_to_gguf(src, tmp_path / "h.gguf", quant_type=qt)
        assert validate_gguf(out_c)["n_tensors"] == validate_gguf(out_h)["n_tensors"]
        pc, cc = load_params_gguf(out_c, device="cpu")
        ph, ch = load_params_gguf(out_h, device="cpu")
        assert cc == ch
        assert_params_equal(pc, ph)

    def test_f16_gguf_rejected(self, src, tmp_path):
        out = convert_hf_to_gguf(src, tmp_path / "m16.gguf", quant_type="f16")
        with pytest.raises(ValueError, match="i2_s"):
            load_params_gguf(out, device="cpu")

    def test_truncated_file_rejected(self, src, tmp_path):
        out = convert_hf_to_gguf(src, tmp_path / "m.gguf", quant_type="i2_s")
        cut = tmp_path / "cut.gguf"
        cut.write_bytes(out.read_bytes()[:-4096])
        with pytest.raises(ValueError, match="past the end"):
            gguf.read_gguf(cut)
