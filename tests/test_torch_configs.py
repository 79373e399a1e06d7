"""The port's YAML config tier vs the JAX reference's, on the CPU.

Every file under ``configs/`` is read by both packages' readers (its
directory names the reader) and gives equal fields; ``use_pallas: false``
raises in the port; importing the port's ``config`` needs no PyYAML.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu import config as rconfig
from wrinklefree_tpu_torch import config as tconfig

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(str(p.relative_to(ROOT / "configs")) for p in (ROOT / "configs").rglob("*.yaml"))
READERS = {
    "models": "model_config_from_yaml",
    "serving": "engine_config_from_yaml",
    "sparsity": "activation_sparsity_from_yaml",
    "attention": "attention_sparsity_from_yaml",
}


def fields(obj):
    """A reader's result as {field: value}: enums by value, dtypes left out
    (jnp against torch), None as None."""
    if obj is None:
        return None
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "dtype":
            continue
        out[f.name] = v.value if hasattr(v, "value") else v
    return out


def test_every_config_file_has_a_reader():
    assert FILES and {Path(f).parts[0] for f in FILES} <= set(READERS)
    assert tconfig.CONFIGS_DIR.resolve() == rconfig.CONFIGS_DIR.resolve() == ROOT / "configs"


@pytest.mark.parametrize("name", FILES)
def test_config_file_reads_the_same(name):
    assert tconfig.load_yaml(name) == rconfig.load_yaml(name)
    reader = READERS[Path(name).parts[0]]
    got = fields(getattr(tconfig, reader)(name))
    want = fields(getattr(rconfig, reader)(name))
    if reader == "engine_config_from_yaml":
        # the port has no use_pallas field: "auto" means its kernels
        assert want.pop("use_pallas") is None  # auto: the reference picks per device
        # the reference's None is its environment default, off; the port's False
        assert want["flash_decode"] is None
        want["flash_decode"] = False
        want = {k: v for k, v in want.items() if k in got}
        got = {k: v for k, v in got.items() if k in want}
        assert got["kv_dtype"] == "bf16"  # kv_cache_dtype: bfloat16
        assert set(got) >= {"max_batch_slots", "page_size", "num_pages", "max_context",
                            "prefill_buckets", "kv_dtype", "enable_radix_cache"}
    assert got == want, (name, got, want)
    if reader == "model_config_from_yaml":
        assert got == fields(tconfig.BitNetConfig.bitnet_2b())


def test_sparsity_files_build_the_port_policies():
    from wrinklefree_tpu_torch.ops.activation_sparsity import ActivationSparsityConfig
    from wrinklefree_tpu_torch.ops.sparse_attention import (AttentionSparsityConfig,
                                                            AttentionSparsityMode)

    assert tconfig.activation_sparsity_from_yaml("sparsity/default.yaml") is None
    assert tconfig.attention_sparsity_from_yaml("attention/default.yaml") is None
    assert (tconfig.activation_sparsity_from_yaml("sparsity/inference_safe.yaml")
            == ActivationSparsityConfig.inference_safe())
    assert (tconfig.activation_sparsity_from_yaml("sparsity/qsparse.yaml")
            == ActivationSparsityConfig.qsparse())
    assert tconfig.attention_sparsity_from_yaml("attention/window.yaml") == \
        AttentionSparsityConfig(mode=AttentionSparsityMode.WINDOW, window_size=256,
                                global_tokens=1, stride=64)


@pytest.mark.parametrize("value,raises", [("auto", False), ("true", False), ("false", True)])
def test_use_pallas(tmp_path, value, raises):
    """``use_pallas``: auto and true read (the port's kernels), false raises
    NotImplementedError in the port and turns the kernels off in the
    reference."""
    p = tmp_path / "serving.yaml"
    p.write_text(f"engine:\n  page_size: 8\n  use_pallas: {value}\n  decode_burst: 4\n"
                 "  int8_logits: true\n  kv_cache_dtype: int8\n")
    if raises:
        with pytest.raises(NotImplementedError, match="use_pallas"):
            tconfig.engine_config_from_yaml(p)
        assert rconfig.engine_config_from_yaml(p).use_pallas is False
        return
    got = tconfig.engine_config_from_yaml(p)
    assert (got.page_size, got.decode_burst, got.int8_logits, got.kv_dtype) == (8, 4, True, "int8")


def test_config_imports_without_yaml():
    """The card's machine has no PyYAML: with ``yaml`` blocked the port's
    config (and its dataclasses) import, and only reading a file fails."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import wrinklefree_tpu_torch.config as c\n"
        "c.EngineConfig(); c.BitNetConfig.tiny()\n"
        "try:\n"
        "    c.load_yaml('serving/default.yaml')\n"
        "except ImportError:\n"
        "    print('read needs yaml')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "read needs yaml"
    code = "import sys, wrinklefree_tpu_torch.config; print('yaml' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr
