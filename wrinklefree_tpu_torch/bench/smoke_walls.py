"""Where ``chip_smoke.py``'s time goes: its ``main()`` with the phases and
chosen helpers timed from outside.

Imports ``chip_smoke`` from ``--root`` (default: this checkout; another
checkout, such as a ``git archive`` of the parent unpacked under
``build/``, times that tree's script), wraps every ``phase_*`` function and
``in_fresh_process`` (a ``WALL <name>: <s> s`` line when each returns) and
the helpers in ``HELPERS`` plus ``Engine.step``, ``__init__`` and
``generate`` (their calls and seconds, summed and printed as one ``SUB``
line at the end of each phase and of each tp rank's job), then runs
``main()``. The tp phase's ranks re-import this module when they start
(``spawn``), so they are timed too; run it as a module or a script, not
inside another program. Needs the card, as ``chip_smoke.py`` does:

    python -m wrinklefree_tpu_torch.bench.smoke_walls [--root DIR]
"""

from __future__ import annotations

import argparse
import collections
import functools
import importlib
import os
import sys
import time
from pathlib import Path

HELPERS = ("cuda_ms", "graph_ms", "start_profiler", "captured_window", "tp_k7_shapes",
           "_tp_engine_run", "_tp_control_run", "_tp_http", "_tp_int_gates",
           "_tp_layer0_inputs", "pp_ep_job", "pp_greedy", "forward_greedy", "ep_run",
           "tp_world", "paged_run", "kernels_vs_plain", "moe_kernels_vs_plain", "routed_run",
           "write_hf_dir", "_tp_ring", "longctx_f32_gate", "text_parts")
ROOT_ENV = "WF_SMOKE_WALLS_ROOT"  # the tp ranks read --root from here
ACC = collections.defaultdict(lambda: [0, 0.0])


def report(tag: str) -> None:
    """Print and clear the sums: ``SUB <tag>: name Nx Ts, ...``."""
    items = sorted(ACC.items(), key=lambda kv: -kv[1][1])
    print(f"SUB {tag}: " + ", ".join(f"{k} {n}x {s:.1f}s" for k, (n, s) in items if s > 0.3),
          flush=True)
    ACC.clear()


def _summed(owner, name: str, tag: str) -> None:
    f = getattr(owner, name)

    @functools.wraps(f)
    def g(*a, **k):
        t = time.perf_counter()
        try:
            return f(*a, **k)
        finally:
            ACC[tag][0] += 1
            ACC[tag][1] += time.perf_counter() - t

    setattr(owner, name, g)


def _walled(cs, name: str) -> None:
    f = getattr(cs, name)

    @functools.wraps(f)
    def g(*a, **k):
        what = f"{name}({a[0]})" if name == "in_fresh_process" else name
        ACC.clear()
        t = time.perf_counter()
        try:
            return f(*a, **k)
        finally:
            print(f"WALL {what}: {time.perf_counter() - t} s", flush=True)
            report(what)

    setattr(cs, name, g)


def _rank_job(cs, name: str) -> None:
    f = getattr(cs, name)

    @functools.wraps(f)
    def g(job):
        import torch.distributed as dist

        ACC.clear()
        try:
            return f(job)
        finally:
            report(f"tp rank {dist.get_rank()} {job.get('model')}")

    setattr(cs, name, g)


def instrument(root) -> object:
    """Import ``chip_smoke`` from ``root`` and wrap it; returns the module."""
    root = str(Path(root).resolve())
    os.environ[ROOT_ENV] = root
    sys.path.insert(0, root)
    cs = importlib.import_module("chip_smoke")
    if getattr(cs, "_smoke_walls", False):
        return cs
    from wrinklefree_tpu_torch.engine.engine import Engine

    nested = {"phase_engine"}  # called inside other phases too: summed, not walled
    for name in dir(cs):
        if name.startswith("phase_") and name not in nested:
            _walled(cs, name)
    for name in (*HELPERS, *nested):
        if hasattr(cs, name):
            _summed(cs, name, name)
    if hasattr(cs, "in_fresh_process"):
        _walled(cs, "in_fresh_process")
    for name in ("tp_job", "dp_tp_job"):
        if hasattr(cs, name):
            _rank_job(cs, name)
    for name in ("step", "__init__", "generate"):
        if not getattr(getattr(Engine, name), "__wrapped__", None):
            _summed(Engine, name, f"Engine.{name}")
    cs._smoke_walls = True
    return cs


if __name__ != "__main__" and os.environ.get(ROOT_ENV):
    # a spawned tp rank re-importing this module: wrap its chip_smoke too
    instrument(os.environ[ROOT_ENV])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose chip_smoke.py runs (default: this one)")
    args = ap.parse_args(argv)
    cs = instrument(args.root)
    t0 = time.perf_counter()
    rc = cs.main()
    print(f"WALL main: {time.perf_counter() - t0} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
