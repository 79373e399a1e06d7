"""The port's serving bench, bench helpers and engine surface, on the CPU.

- ``bench/{metrics,cost,report}.py`` against the reference's on the same
  inputs (hypothesis);
- the engine surface the server and the bench use (``has_work``,
  ``prefix_match_len``, ``reset_prefix_cache``) against the reference
  ``Engine`` on the tiny model, with the same prompts and radix sharing;
  ``warmup`` leaves tokens, pools, allocator, radix cache and stats as they
  were;
- ``python -m wrinklefree_tpu_torch.bench.serving --tiny --device cpu``
  reports every key of ``scripts/serving_bench.py``'s report, with the same
  scheduling counts;
- no module of the port imports jax, ``wrinklefree_tpu``, aiohttp,
  requests, httpx, transformers or yaml.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.bench import cost as ref_cost
from wrinklefree_tpu.bench import metrics as ref_metrics
from wrinklefree_tpu.bench import report as ref_report
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
from wrinklefree_tpu.engine import Engine as RefEngine
from wrinklefree_tpu.engine import SamplingParams as RefSampling
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu_torch.bench import cost, metrics, report, serving
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.engine import Engine, SamplingParams
from wrinklefree_tpu_torch.weights import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
ECFG = dict(max_batch_slots=4, page_size=8, num_pages=64, max_context=64,
            prefill_buckets=(8, 16, 32))
SHARED = list(range(1, 17))  # two full pages

times = st.lists(st.floats(min_value=0.0, max_value=1e4, allow_nan=False), max_size=40)


# -- metrics, cost and report against the reference ------------------------


@settings(max_examples=60, deadline=None)
@given(xs=times, p=st.floats(min_value=0.0, max_value=100.0))
def test_pct_matches_reference(xs, p):
    assert metrics._pct(xs, p) == ref_metrics._pct(xs, p)


@settings(max_examples=60, deadline=None)
@given(lat=times, ttft=times, tokens=st.integers(0, 10**7),
       total=st.one_of(st.none(), st.floats(min_value=0.0, max_value=1e4)))
def test_benchmark_metrics_match_reference(lat, ttft, tokens, total):
    got = metrics.BenchmarkMetrics.from_latencies(lat, ttft, tokens, total).to_dict()
    want = ref_metrics.BenchmarkMetrics.from_latencies(lat, ttft, tokens, total).to_dict()
    assert got == want


@settings(max_examples=40, deadline=None)
@given(tps=st.floats(min_value=0.0, max_value=1e6), hourly=st.floats(0.0, 100.0),
       util=st.floats(min_value=0.01, max_value=1.0))
def test_cost_matches_reference(tps, hourly, util):
    assert cost.CostMetrics(tps, hourly).cost_per_million_tokens(util) == \
        ref_cost.CostMetrics(tps, hourly).cost_per_million_tokens(util)
    assert cost.CostTracker(hourly).report(tps) == ref_cost.CostTracker(hourly).report(tps)
    assert cost.HARDWARE_PRICING == ref_cost.HARDWARE_PRICING


def test_roofline_report_defaults_to_the_h100():
    got = metrics.roofline_report(3.35e9, 1e-3)
    assert got == {"achieved_gb_s": 3350.0, "theoretical_gb_s": 3350.0, "utilization": 1.0}
    assert metrics.roofline_report(5e8, 1.0, 819.0) == ref_metrics.roofline_report(5e8, 1.0)


point = st.fixed_dictionaries({
    "name": st.text(min_size=1, max_size=8), "time_ms": st.floats(0, 100),
    "gbytes_per_s": st.floats(0, 4000), "gflops": st.floats(0, 1e6),
    "bw_utilization": st.floats(0, 1), "bound": st.sampled_from(["memory", "compute"])})


@settings(max_examples=30, deadline=None)
@given(lat=times, ttft=times, tokens=st.integers(0, 10**6),
       tps=st.floats(min_value=0.0, max_value=1e5), points=st.lists(point, max_size=3),
       notes=st.dictionaries(st.text(min_size=1, max_size=6), st.integers(), max_size=3))
def test_render_markdown_matches_reference(lat, ttft, tokens, tps, points, notes):
    m = metrics.BenchmarkMetrics.from_latencies(lat, ttft, tokens)
    rm = ref_metrics.BenchmarkMetrics.from_latencies(lat, ttft, tokens)
    got = report.render_markdown("t", m, cost.CostMetrics(tps, 1.2), points, notes)
    want = ref_report.render_markdown("t", rm, ref_cost.CostMetrics(tps, 1.2), points, notes)

    def body(md):  # all but the generated-at line, the only one that reads the clock
        return [line for line in md.splitlines() if not line.startswith("_generated ")]

    assert body(got) == body(want) and len(got.splitlines()) == len(want.splitlines())


def test_write_report(tmp_path):
    m = metrics.BenchmarkMetrics.from_latencies([1.0, 2.0], [0.5], 30)
    out = report.write_report(tmp_path, "run", m, cost.CostMetrics(10.0, 1.2))
    payload = json.loads(out["json"].read_text())
    assert payload["metrics"] == m.to_dict() and payload["cost"]["tokens_per_second"] == 10.0
    assert out["markdown"].read_text().startswith("# run\n")


# -- the engine surface against the reference -----------------------------


@pytest.fixture(scope="module")
def engines():
    cfg = RefConfig.tiny()
    ref_params = ref_init(cfg, seed=0)
    ref = RefEngine(ref_params, cfg, RefEngineConfig(**ECFG))
    pcfg = BitNetConfig.tiny()
    port = Engine(params_from_numpy(jax.tree.map(np.asarray, ref_params), pcfg, device="cpu"),
                  pcfg, EngineConfig(**ECFG), device="cpu")
    return ref, port


def _surface(eng, sp_cls):
    """has_work / prefix_match_len / reset_prefix_cache along one script."""
    out = {"idle": eng.has_work()}
    req = eng.submit(SHARED + [20], sp_cls(max_new_tokens=8, temperature=0.0))
    out["queued"] = eng.has_work()
    with pytest.raises(RuntimeError, match="idle engine"):
        eng.reset_prefix_cache()
    while not req.finished:
        eng.step()
    out["done"] = eng.has_work()
    out["match"] = [eng.prefix_match_len(p) for p in
                    (SHARED + [21], SHARED[:8], SHARED[:7], [99] + SHARED, [])]
    b = eng.generate(SHARED + [21], sp_cls(max_new_tokens=8, temperature=0.0))
    out["hit"] = eng.stats["radix_hit_tokens"]
    out["b"] = b.finish_reason
    out["dropped"] = eng.reset_prefix_cache()
    out["after"] = (eng.reset_prefix_cache(), eng.prefix_match_len(SHARED + [21]),
                    eng.allocator.num_free)
    return out


def test_engine_surface_matches_reference(engines):
    ref, port = engines
    got, want = _surface(port, SamplingParams), _surface(ref, RefSampling)
    assert got == want
    assert got["match"][:3] == [16, 8, 0] and got["dropped"] > 0
    assert got["after"] == (0, 0, ECFG["num_pages"] - 1)


def test_warmup_leaves_the_engine_as_it_was(engines):
    _, eng = engines
    prompt = SHARED + [5, 6, 7]
    sp = SamplingParams(max_new_tokens=12, temperature=0.0)
    first = eng.generate(prompt, sp).output_ids
    state = (eng.pools.kv.clone(), eng.pools.staging.clone(), dict(eng.stats),
             eng.allocator.num_free, eng.radix.num_cached_pages, eng.prefix_match_len(prompt))
    timings = eng.warmup()
    assert torch.equal(state[0], eng.pools.kv) and torch.equal(state[1], eng.pools.staging)
    assert state[2:] == (dict(eng.stats), eng.allocator.num_free,
                         eng.radix.num_cached_pages, eng.prefix_match_len(prompt))
    # every prefill bucket and the decode burst ran once
    assert set(timings) == {"prefill[8]", "prefill[16]", "prefill[32]", "decode_burst[K=16]"}
    assert {n for kind, n, *_ in eng._programs if kind == "prefill"} == {8, 16, 32}
    assert ("decode", 16) in eng._programs
    eng.reset_prefix_cache()
    assert eng.generate(prompt, sp).output_ids == first


# -- the serving bench ----------------------------------------------------


SMALL = ["--tiny", "--streams", "4", "--prompt-len", "16", "--new-tokens", "4", "--slots",
         "2", "--num-pages", "64"]


@pytest.fixture(scope="module")
def ref_report_line():
    env = {**os.environ, "WF_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "scripts/serving_bench.py", *SMALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_serving_bench_reports_the_reference_keys(ref_report_line):
    got = serving.main([*SMALL, "--device", "cpu"])
    assert set(ref_report_line) <= set(got)
    assert set(got) - set(ref_report_line) == {"device"} and got["device"] == "cpu"
    # the same prompts through the same scheduler: the same counts
    same = ("metric", "model", "streams", "prompt_len", "new_tokens", "slots",
            "radix_hit_tokens", "kv_dtype", "spec_k", "spec_accept_rate", "decode_steps",
            "in_window_compiles", "in_window_compile_s")
    assert {k: got[k] for k in same} == {k: ref_report_line[k] for k in same}
    # the native host runtime runs where it builds; the port's auto layout is
    # the dual one for bf16 KV on every device
    from wrinklefree_tpu_torch.native import native_available

    assert got["native_runtime"] is native_available()
    assert got["kv_layout"] == "layer"
    assert got["decode_tok_s"] > 0 and got["total_tok_s"] > got["decode_tok_s"]


def test_serving_bench_shared_prefix_hits_the_radix():
    got = serving.main(["--tiny", "--device", "cpu", "--streams", "4", "--prompt-len", "24",
                        "--new-tokens", "4", "--slots", "2", "--num-pages", "64",
                        "--shared-prefix", "16"])
    assert got["radix_hit_tokens"] > 0 and got["in_window_compiles"] == 0


def test_serving_bench_counts_new_programs_in_the_window(monkeypatch):
    """A program variant first made inside the measured window is counted."""
    calls = []
    state = serving.compile_state

    def spy(eng):
        calls.append(eng)
        if len(calls) == 2:  # the window's end: pretend a bucket appeared
            eng._programs[("prefill", -1)] = None
        return state(eng)

    monkeypatch.setattr(serving, "compile_state", spy)
    assert serving.main([*SMALL, "--device", "cpu"])["in_window_compiles"] == 1


@pytest.mark.parametrize("flags", [
    ["--kv-dtype", "int8"], ["--kv-layout", "token"], ["--spec", "2"], ["--window", "64"],
    ["--exact-head", "64"], ["--use-pallas", "0"], ["--prefill-linear", "xla"],
])
def test_serving_bench_flags_not_ported_raise(flags, monkeypatch):
    """Of these flags, once all refused, the kernels' plain twins as a
    serving path still raise; quantized KV, the token layout, the window, the
    exact head and speculative decoding serve, and the report names the
    layout the engine resolved (int8 on the auto layout: token-major; the
    window: the dual layout). ``--spec 2`` reports ``spec_k`` 2 and the
    engine's own acceptance, accepted over drafted (on looping prompts,
    above 0)."""
    if flags[0] in ("--use-pallas", "--prefill-linear"):
        with pytest.raises(NotImplementedError, match="not ported"):
            serving.main([*SMALL, "--device", "cpu", *flags])
        return
    engines = []
    state = serving.compile_state

    def spy(eng):
        engines.append(eng)
        return state(eng)

    monkeypatch.setattr(serving, "compile_state", spy)
    if flags[0] == "--spec":
        flags = [*flags, "--repetitive", "4"]
    got = serving.main([*SMALL, "--device", "cpu", *flags])
    if flags[0] == "--spec":
        st_ = engines[-1].stats
        assert got["spec_k"] == 2 and st_["spec_drafted"] > 0
        assert got["spec_accept_rate"] == round(st_["spec_accepted"] / st_["spec_drafted"], 3)
        assert got["spec_accept_rate"] > 0
    want_layout = "token" if flags[0] in ("--kv-dtype", "--kv-layout") else "layer"
    assert got["kv_layout"] == want_layout and got["decode_tok_s"] > 0
    assert got["kv_dtype"] == (flags[1] if flags[0] == "--kv-dtype" else "bf16")


def test_serving_bench_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.main(SMALL)


# -- the port imports none of the reference's stack -------------------------


def test_port_imports_no_reference_stack():
    code = """
import importlib, pkgutil, sys
import wrinklefree_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "wrinklefree_tpu", "aiohttp", "requests", "httpx", "transformers",
    "yaml", "safetensors", "huggingface_hub", "ml_dtypes"))
print(len(names), bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 40 and out[1].strip() == "[]", out
