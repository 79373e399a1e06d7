"""The port's tools (ROADMAP item 13) against the JAX package's, on the CPU.

- ``bench/roofline.py``: the same traffic, roofline points and speed of
  light as the reference's for the same spec (the reference's ``"cpu"``
  figures, which both tables carry); the H100 figures every bound of the
  port reads.
- ``models/patcher.py``: ``ternarize_tree`` patches the leaves the
  reference's patches (paths, patterns, ``min_size``, ``shape[0] % 4``) with
  bitwise-equal packed weights and scales and the same count;
  ``ternary_apply`` equals the reference's bit for bit.
- ``utils/torchcache.py``: ``enable_persistent_cache`` moves the kernels'
  build cache; ``CompileWatcher`` counts kernel builds and CUDA-graph
  captures.
- ``kv/validator.py``: the KV-cache validator against the port's server on
  the tiny model, in process.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.bench import roofline as ref_roofline
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.models import patcher as ref_patcher
from wrinklefree_tpu_torch.bench import roofline
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.kv.validator import (
    KVCacheMetrics,
    KVCacheValidator,
    run_kv_cache_validation,
)
from wrinklefree_tpu_torch.models import patcher
from wrinklefree_tpu_torch.ops import cuda_lib
from wrinklefree_tpu_torch.utils import torchcache

# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def test_cpu_spec_is_the_reference_s():
    assert roofline.GPU_SPECS["cpu"] == ref_roofline.TPU_SPECS["cpu"]


def test_h100_figures():
    """The published dense peaks of one H100 SXM at 700 W, the table every
    bound of the port reads (chip_smoke.py, the kernel benches)."""
    assert roofline.GPU_SPECS["h100"] == {
        "bf16_flops": 989e12, "fp16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12,
        "int8_ops": 1979e12, "hbm_bw": 3.35e12, "hbm_gb": 80}
    assert roofline.peak_ops("h100") == {"int8": 1979e12, "bf16": 989e12, "fp16": 989e12,
                                         "tf32": 495e12, "f32": 67e12}
    assert roofline.peak_ops("cpu") == {"int8": 2e12, "bf16": 1e12}


@pytest.mark.parametrize("shape", [(1, 2560, 2560), (8, 2560, 6912), (4096, 4096, 4096)])
def test_traffic_matches_reference(shape):
    assert roofline.ternary_matmul_traffic(*shape) == ref_roofline.ternary_matmul_traffic(*shape)


@pytest.mark.parametrize("case", [("gemv", 50e-6, 1, 2560, 2560), ("gemm", 1e-3, 4096, 4096, 4096),
                                  ("mid", 2e-4, 64, 2560, 13824)])
@pytest.mark.parametrize("compute_key", ["int8_ops", "bf16_flops"])
def test_roofline_point_matches_reference(case, compute_key):
    name, t, b, k, n = case
    tr = ref_roofline.ternary_matmul_traffic(b, k, n)
    want = ref_roofline.roofline(name, t, tr["bytes"], tr["flops"], chip="cpu",
                                 compute_key=compute_key).as_dict()
    got = roofline.roofline(name, t, tr["bytes"], tr["flops"], chip="cpu",
                            compute_key=compute_key).as_dict()
    assert got == want


@pytest.mark.parametrize("batch,context", [(1, 128), (1, 512), (8, 2048)])
@pytest.mark.parametrize("model", ["bitnet_2b", "tiny"])
def test_decode_traffic_and_speed_of_light_match_reference(model, batch, context):
    ref_cfg, cfg = getattr(RefConfig, model)(), getattr(BitNetConfig, model)()
    assert (roofline.decode_step_traffic(cfg, batch, context)
            == ref_roofline.decode_step_traffic(ref_cfg, batch, context))
    assert (roofline.speed_of_light_toks(cfg, batch, context, chip="cpu")
            == ref_roofline.speed_of_light_toks(ref_cfg, batch, context, chip="cpu"))


def test_detect_chip_and_memory_stats_default_to_the_card():
    """Without a device both ask for CUDA, which this host lacks; on the CPU
    the chip is "cpu" and its memory statistics are zeros."""
    for fn in (roofline.detect_chip, roofline.device_memory_stats):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
    assert roofline.detect_chip("cpu") == "cpu"
    assert roofline.device_memory_stats("cpu") == {
        "bytes_in_use": 0.0, "bytes_limit": 0.0, "peak_bytes_in_use": 0.0}


# ---------------------------------------------------------------------------
# patcher
# ---------------------------------------------------------------------------


def _tree(seed=0):
    """A numpy tree of dicts, lists and tuples: leaves that match, leaves
    too small, with rows not a multiple of 4, 1-D, int and unmatched."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(0, 0.02, shape).astype(np.float32)

    return {
        "layer0": {"q_proj": w(64, 64), "o_proj": w(32, 16), "up_proj": w(66, 32)},
        "blocks": [{"w": w(64, 32)}, {"w": w(64, 32), "mlp": (w(128, 32), w(8, 8))}],
        "attention_out": {"dense": w(64, 64), "bias": w(64)},
        "ln": np.ones((64,), np.float32),
        "head": w(64, 64),
        "ids": np.arange(4096, dtype=np.int32).reshape(64, 64),
    }


PATTERNS = [patcher.DEFAULT_PATTERNS, (r".*q_proj.*",), (r"blocks/\[1\]/w",),
            (r".*mlp.*", r"head")]


@pytest.mark.parametrize("patterns", PATTERNS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ternarize_tree_matches_reference(patterns, dtype):
    """The same leaves patched (a list index is ``[i]`` in the path, as in
    JAX), bitwise-equal qweights and scales, the rest untouched."""
    tree = _tree()
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)

    def to_torch(x):
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to_torch(v) for v in x)
        t = torch.from_numpy(x)
        return t.to(tdt) if t.is_floating_point() else t

    def to_jax(x):
        return jnp.asarray(x, jdt if np.issubdtype(x.dtype, np.floating) else x.dtype)

    want, n_want = ref_patcher.ternarize_tree(jax.tree.map(to_jax, tree), patterns=patterns)
    got, n_got = patcher.ternarize_tree(to_torch(tree), patterns=patterns)
    assert n_got == n_want and n_want > 0

    def check(g, w):
        if isinstance(w, ref_patcher.TernaryParam):
            assert isinstance(g, patcher.TernaryParam)
            np.testing.assert_array_equal(g.qweight.numpy(), np.asarray(w.qweight))
            assert g.qweight.dtype == torch.uint8 and g.scale.dtype == torch.float32
            assert g.scale.item() == float(w.scale)
        elif isinstance(w, dict):
            assert isinstance(g, dict) and g.keys() == w.keys()
            for k in w:
                check(g[k], w[k])
        elif isinstance(w, (list, tuple)):
            assert type(g) is type(w) and len(g) == len(w)
            for a, b in zip(g, w):
                check(a, b)
        else:
            assert isinstance(g, torch.Tensor)
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))

    check(got, want)


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_ternary_apply_matches_reference(out_dtype):
    """``ternary_apply`` (K7's exact int32 dot, its plain version on the CPU,
    then ``ternary_linear``'s rescale) equals the reference's bit for bit."""
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.02, (64, 32)).astype(np.float32)
    x = rng.normal(0, 1, (4, 64)).astype(np.float32)
    ref_tree, _ = ref_patcher.ternarize_tree({"x_proj": jnp.asarray(w)}, patterns=(r".*x_proj",))
    tree, n = patcher.ternarize_tree({"x_proj": torch.from_numpy(w)}, patterns=(r".*x_proj",))
    assert n == 1
    want = ref_patcher.ternary_apply(jnp.asarray(x, jnp.bfloat16), ref_tree["x_proj"],
                                     out_dtype=getattr(jnp, out_dtype))
    got = patcher.ternary_apply(torch.from_numpy(x).to(torch.bfloat16), tree["x_proj"],
                                out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# the build cache and the compile watcher
# ---------------------------------------------------------------------------


def test_persistent_cache_moves_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", cuda_lib.BUILD_DIR)  # restored after
    before = cuda_lib.BUILD_DIR
    monkeypatch.delenv(torchcache.ENV_VAR, raising=False)
    assert torchcache.enable_persistent_cache() is None and cuda_lib.BUILD_DIR == before
    d = torchcache.enable_persistent_cache(str(tmp_path / "default"))
    assert d == str(tmp_path / "default") and cuda_lib.BUILD_DIR == tmp_path / "default"
    monkeypatch.setenv(torchcache.ENV_VAR, str(tmp_path / "env"))
    assert torchcache.enable_persistent_cache(str(tmp_path / "default")) == str(tmp_path / "env")
    assert (tmp_path / "env").is_dir() and cuda_lib._library_path().parent == tmp_path / "env"


def test_compile_watcher_counts_builds_and_captures(monkeypatch):
    """A kernel build, a library found on disk and a CUDA-graph capture
    (through the hooks it installs on ``torch.cuda.CUDAGraph``, here on a
    stand-in class) each show in the delta."""

    class FakeGraph:
        calls = []

        def capture_begin(self, *a, **kw):
            self.calls.append("begin")

        def capture_end(self):
            self.calls.append("end")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torchcache, "_installed", False)
    for key in ("count", "seconds", "cache_hits"):
        monkeypatch.setitem(cuda_lib.BUILDS, key, cuda_lib.BUILDS[key])
    w = torchcache.CompileWatcher()
    snap = w.snapshot()
    assert w.delta(snap) == {"compiles": 0, "compile_s": 0.0, "cache_hits": 0, "builds": 0,
                             "graph_captures": 0}
    cuda_lib.BUILDS["count"] += 1
    cuda_lib.BUILDS["seconds"] += 2.5
    cuda_lib.BUILDS["cache_hits"] += 1
    g = FakeGraph()
    g.capture_begin()
    g.capture_end()
    d = w.delta(snap)
    assert FakeGraph.calls == ["begin", "end"]
    assert (d["compiles"], d["builds"], d["graph_captures"], d["cache_hits"]) == (2, 1, 1, 1)
    assert 2.5 <= d["compile_s"] < 3.5
    torchcache.CompileWatcher()  # idempotent: the hooks wrap once
    g.capture_begin()
    g.capture_end()
    assert w.delta(snap)["graph_captures"] == 2 and FakeGraph.calls.count("end") == 2


# ---------------------------------------------------------------------------
# the KV-cache validator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def server_url():
    """The port's server on the tiny model (random weights, seed 0), with room
    for the prefix probe's 512-byte prompts."""
    from wrinklefree_tpu_torch.engine import Engine
    from wrinklefree_tpu_torch.models.bitnet import init_params
    from wrinklefree_tpu_torch.server._web import ServerThread
    from wrinklefree_tpu_torch.server.http import ByteTokenizer, InferenceServer, build_app

    cfg = BitNetConfig.tiny()
    eng = Engine(init_params(cfg, seed=0, device="cpu"), cfg,
                 EngineConfig(max_batch_slots=4, page_size=8, num_pages=512, max_context=1024,
                              prefill_buckets=(16, 64, 128)),
                 eos_token_id=0, device="cpu")
    server = InferenceServer(eng, ByteTokenizer(), "wrinklefree-tiny-test")
    st = ServerThread(build_app(server))
    yield st.url
    st.stop()
    server.async_engine.shutdown()


def test_validator_context_limit_graceful(server_url):
    assert KVCacheValidator(server_url).validate_context_limits() is True


def test_validator_concurrent_success(server_url):
    assert KVCacheValidator(server_url).validate_continuous_batching(n=6) == 1.0


def test_validator_prefix_caching_probe(server_url):
    # tiny model: the probe runs and returns a sane positive ratio (radix
    # speedups need real prompt lengths)
    assert KVCacheValidator(server_url).validate_prefix_caching(prefix_len=90, trials=2) > 0


def test_validator_metrics_pass_logic():
    assert KVCacheMetrics(1.5, True, 1.0).passed
    assert not KVCacheMetrics(0.2, True, 1.0).passed
    assert not KVCacheMetrics(1.5, False, 1.0).passed
    assert not KVCacheMetrics(1.5, True, 0.5).passed


def test_validator_dead_server_is_not_graceful():
    """No server at the address: no answer is no clean refusal."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    assert KVCacheValidator(f"http://127.0.0.1:{port}").validate_context_limits() is False


def test_run_kv_cache_validation_reports(server_url, capsys):
    ok = run_kv_cache_validation(server_url)
    out = capsys.readouterr().out
    assert "context-limit graceful: True" in out and "concurrent success: 100%" in out
    assert out.strip().endswith("PASS" if ok else "FAIL")
