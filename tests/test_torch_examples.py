"""The port's example twins (examples/*_torch.py) run on the CPU at a small
size, each with its own assertions, in a process where `jax` and `repro`
cannot be imported (so the twins import neither)."""

import os
import subprocess
import sys

import pytest

from torch_parity import ROOT

# each twin's command line and a line its output must hold
TWINS = {
    "quickstart_torch.py": ([], "three 12-step walks:"),
    "serve_lm_torch.py": ([], "engine == oracle"),
    "generate_graph500_torch.py": (["--scale", "10", "--nb", "4"], "[external shuffle]"),
}
_BLOCKED = ("import runpy, sys\n"
            "sys.modules['jax'] = sys.modules['repro'] = None\n"
            "path = sys.argv[1]\n"
            "sys.argv = sys.argv[1:]\n"
            "runpy.run_path(path, run_name='__main__')\n")


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_example_twin_runs_on_the_cpu(twin):
    argv, want = TWINS[twin]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _BLOCKED, os.path.join(ROOT, "examples", twin),
                        *argv, "--device", "cpu"], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
    assert want in r.stdout


def test_example_twin_defaults_to_cuda():
    """Without --device the twins ask for cuda, which raises where there is
    none (and runs where there is)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "quickstart_torch.py")],
                       env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "torch.cuda.is_available() is False" in r.stderr
