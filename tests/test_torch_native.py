"""The port's native host runtime (``wrinklefree_tpu_torch/native``, its own
copy of ``csrc/wf_runtime.cpp``) against its Python classes and the JAX
package's native classes, on the CPU.

``tests/test_native_runtime.py``'s scenarios run on three implementations
at once (the port's ``PageAllocator``/``RadixCache``, the port's
``NativePageAllocator``/``NativeRadixCache`` and the reference's native
pair): allocation order, LIFO reuse, refcounts, the errors, radix insert and
match, locks against eviction, LRU eviction order, reset and a randomized op
sequence. Then the build (content-hashed under ``build/wf_runtime``), the
engine's fallback to the Python classes, and the engine: native and Python
runtimes give the same tokens, radix hits and retractions."""

import numpy as np
import pytest

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.native import NativePageAllocator as RefNativeAllocator
from wrinklefree_tpu.native import NativeRadixCache as RefNativeRadix
from wrinklefree_tpu.native import native_available as ref_native_available
from wrinklefree_tpu_torch import native
from wrinklefree_tpu_torch.engine.page_allocator import PageAllocator
from wrinklefree_tpu_torch.engine.radix_cache import RadixCache
from wrinklefree_tpu_torch.native import NativePageAllocator, NativeRadixCache

IMPLS = [(PageAllocator, RadixCache), (NativePageAllocator, NativeRadixCache),
         (RefNativeAllocator, RefNativeRadix)]


def test_builds_into_the_build_tree():
    """g++ builds the port's own source into build/wf_runtime, named by its
    content hash; the reference's native runtime builds too (it is compared
    below)."""
    assert native.native_available() and ref_native_available()
    path = native.build.build()
    assert path == native.build.library_path() and path.exists()
    assert path.parent.name == "wf_runtime" and path.parent.parent.name == "build"
    assert native.build.CSRC.parent.parent.name == "wrinklefree_tpu_torch"
    built = path.stat().st_mtime_ns
    assert native.build.build() == path and path.stat().st_mtime_ns == built  # no rebuild


def _all(num_pages):
    return [a(num_pages) for a, _ in IMPLS]


def test_allocator_matches_python():
    allocs = _all(16)
    assert len({tuple(a.alloc(5)) for a in allocs}) == 1
    for a in allocs:
        pages = a.alloc(3)
        a.release(pages[1])
        assert a.alloc(1) == [pages[1]]  # LIFO reuse
        (p,) = a.alloc(1)
        a.retain(p)
        assert a.refcount(p) == 2
        a.release(p)
        assert a.refcount(p) == 1
        free = a.num_free
        a.release(p)
        assert a.num_free == free + 1
        a.release(0)  # the trash page: a no-op
        assert a.num_free == free + 1
        with pytest.raises(AssertionError):
            a.release(p)  # double free
        with pytest.raises(MemoryError):
            a.alloc(a.num_free + 1)
    assert len({a.num_free for a in allocs}) == 1


def _pairs(num_pages=64, ps=4):
    out = []
    for a_cls, r_cls in IMPLS:
        a = a_cls(num_pages)
        out.append((a, r_cls(a, ps)))
    return out


def test_radix_insert_match_and_partial_match():
    got = []
    for a, r in _pairs():
        toks = list(range(12))
        pages = a.alloc(3)
        adopted = r.insert(toks, pages)
        full = r.match(toks + [99])
        partial = r.match(toks[:4] + [7, 7, 7, 7])
        p2 = a.alloc(3)
        again = r.insert(toks, p2)  # existing chunks are not adopted
        got.append((pages, adopted, full[:2], len(full[2]), partial[:2], again,
                    a.refcount(p2[0])))
    assert got[0] == got[1] == got[2]
    assert got[0][1] == 3 and got[0][2] == (12, got[0][0]) and got[0][4][0] == 4
    assert got[0][5] == 0 and got[0][6] == 1


def test_lock_prevents_eviction_and_reset():
    for a, r in _pairs():
        toks = list(range(8))
        pages = a.alloc(2)
        r.insert(toks, pages)
        a.release_all(pages)  # only the tree's references remain
        _, _, nodes = r.match(toks)
        r.lock(nodes)
        assert r.evict(10) == 0
        r.unlock(nodes)
        assert r.evict(10) == 2 and r.num_cached_pages == 0
        assert a.num_free == a.num_pages - 1
        more = a.alloc(4)
        r.insert(list(range(16)), more)
        a.release_all(more)
        r.reset()
        assert r.num_cached_pages == 0 and a.num_free == a.num_pages - 1


def test_evict_lru_order_matches_python():
    hits = []
    for a, r in _pairs(ps=2):
        pa, pb = a.alloc(1), a.alloc(1)
        r.insert([1, 2], pa)
        r.insert([3, 4], pb)
        a.release_all(pa + pb)
        r.match([1, 2])  # touch [1, 2]: [3, 4] is the least recently used
        r.evict(1)
        hits.append((r.match([3, 4])[0], r.match([1, 2])[0]))
    assert hits == [(0, 2)] * 3


def test_randomized_equivalence():
    """One random op sequence on all three: the same pages, matches,
    evictions, free counts and cached pages throughout."""
    rng = np.random.default_rng(0)
    pairs = _pairs(num_pages=128, ps=2)
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(2, 4))
            toks = [int(t) for t in rng.integers(0, 5, n * 2)]
            if pairs[0][0].num_free < n:
                continue
            outs = []
            for a, r in pairs:
                pages = a.alloc(n)
                outs.append((pages, r.insert(toks, pages)))
                a.release_all(pages)
        elif op == 1:
            toks = [int(t) for t in rng.integers(0, 5, int(rng.integers(1, 8)))]
            outs = [r.match(toks)[:2] for _, r in pairs]
        else:
            k = int(rng.integers(1, 4))
            outs = [r.evict(k) for _, r in pairs]
        assert outs[0] == outs[1] == outs[2]
        assert len({(a.num_free, r.num_cached_pages) for a, r in pairs}) == 1


def _engine(weights, **over):
    from tests.test_torch_engine import ECFG
    from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
    from wrinklefree_tpu_torch.engine import Engine
    from wrinklefree_tpu_torch.weights import params_from_numpy

    cfg = BitNetConfig.tiny()
    return Engine(params_from_numpy(weights, cfg, device="cpu"), cfg,
                  EngineConfig(**dict(ECFG, **over)), device="cpu")


@pytest.fixture(scope="module")
def weights():
    import jax

    from wrinklefree_tpu.config import BitNetConfig as RefConfig
    from wrinklefree_tpu.models.bitnet import init_params as ref_init

    return jax.tree.map(np.asarray, ref_init(RefConfig.tiny(), seed=0))


def test_engine_falls_back_to_python(weights, monkeypatch, caplog):
    """When the library cannot be built, the engine warns and runs the
    Python classes (the reference's behaviour)."""
    monkeypatch.setattr(native.build, "_lib", None)
    monkeypatch.setattr(native.build, "_tried", False)

    def no_compiler():
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native.build, "build", no_compiler)
    eng = _engine(weights)
    assert not eng.native_runtime and isinstance(eng.allocator, PageAllocator)
    assert isinstance(eng.radix, RadixCache)
    assert "using the Python" in caplog.text
    assert _engine(weights, use_native_runtime=False).native_runtime is False


@pytest.mark.parametrize("kind", ["radix_and_slots", "retraction"])
def test_native_and_python_engines_agree(weights, kind):
    """The default engine runs the native runtime; its greedy and seeded
    tokens, radix hits and retractions equal a ``use_native_runtime=False``
    engine's: 8 requests over 4 slots sharing a two-page prefix (radix
    sharing, in-queue re-match, eviction on a small pool), and a dry pool
    that retracts requests."""
    from tests.test_torch_engine import SHARED, _run_jobs
    from wrinklefree_tpu_torch.engine import SamplingParams

    if kind == "retraction":
        over = dict(num_pages=18, decode_burst=8)
        jobs = [([1 + i, 2, 3, 4, 5, 6], dict(max_new_tokens=26, ignore_eos=True,
                                              temperature=0.8 * (i % 2), seed=i))
                for i in range(8)]
    else:
        over = dict(num_pages=24)
        jobs = [(SHARED + list(range(i + 1, i + 4 + 3 * i)),
                 dict(max_new_tokens=6 + i, ignore_eos=True, temperature=0.9 * (i % 2),
                      seed=i)) for i in range(8)]
    runs = []
    for use in (True, False):
        eng = _engine(weights, use_native_runtime=use, **over)
        assert eng.native_runtime is use
        out = _run_jobs(eng, SamplingParams, jobs)
        out += _run_jobs(eng, SamplingParams, jobs[:2])  # again, from the radix cache
        runs.append((out, {k: eng.stats.get(k, 0) for k in ("radix_hit_tokens", "preemptions",
                                                             "prefill_tokens")},
                     eng.allocator.num_free, eng.radix.num_cached_pages))
    assert runs[0] == runs[1]
    stats = runs[0][1]
    assert stats["radix_hit_tokens"] > 0
    if kind == "retraction":
        assert stats["preemptions"] > 0
