"""The JAX package's capslint tests (``tests/test_analysis.py``) on the
port's copy of capslint (``caps_tpu_torch/analysis``).

The 45 cases are loaded from their source with ``caps_tpu`` rewritten to
``caps_tpu_torch`` (``caps_tpu_torch/testing/suites.py``): each pass
fires on its fixture tree with the right path and line, the CLI keeps
its contract, and the whole of this package lints clean with its
metrics document current.  capslint is pure AST, so it also runs with
torch and numpy blocked.
"""
import os
import subprocess
import sys

from caps_tpu_torch.testing.suites import REPO_DIR, collect_tests, load_module

_TESTS = collect_tests(load_module("test_analysis.py"))
globals().update(_TESTS)


def test_every_reference_case_is_collected():
    assert len(_TESTS) == 45


_BLOCKED = """
import sys, runpy
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "numpy", "jax", "jaxlib",
                                  "caps_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.argv = ["capslint", "--check-metrics-doc"]
runpy.run_module("caps_tpu_torch.analysis", run_name="__main__")
"""


def test_capslint_runs_clean_with_torch_and_numpy_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO_DIR,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO_DIR))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "capslint: clean (6 passes" in out.stdout
