"""``wrinklefree_tpu_torch/bench/smoke_walls.py``, which times
``chip_smoke.py``'s phases from outside on the card: here (no CUDA) it wraps
the script's phases and helpers and returns ``main()``'s refusal, code 2.
Each case runs in a subprocess, as the tool does (it wraps ``Engine``'s
methods for the life of its process)."""

import subprocess
import sys
from pathlib import Path

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)

ROOT = Path(__file__).resolve().parents[1]
TOOL = ROOT / "wrinklefree_tpu_torch" / "bench" / "smoke_walls.py"


def _run(*args):
    return subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=240)


def test_refuses_without_cuda_after_wrapping():
    """Run as a script on this checkout: chip_smoke's refusal, then the
    tool's own wall line."""
    r = _run(str(TOOL), "--root", str(ROOT))
    assert r.returncode == 2, r.stderr
    assert "CUDA is not available" in r.stderr
    assert r.stdout.strip().splitlines()[-1].startswith("WALL main: ")


def test_instrument_wraps_phases_helpers_and_engine():
    code = ("from wrinklefree_tpu_torch.bench import smoke_walls as s;"
            "from wrinklefree_tpu_torch.engine.engine import Engine;"
            f"cs = s.instrument({str(ROOT)!r}); again = s.instrument({str(ROOT)!r});"
            "names = ['phase_kernels', 'phase_tp', 'phase_pp_ep', 'in_fresh_process',"
            " 'tp_job', 'cuda_ms', 'pp_greedy', 'phase_engine'];"
            "print(again is cs, all(hasattr(getattr(cs, n), '__wrapped__') for n in names),"
            " hasattr(Engine.step, '__wrapped__'),"
            " hasattr(Engine.step.__wrapped__, '__wrapped__'))")
    r = _run("-c", code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True", "True", "True", "False"]
