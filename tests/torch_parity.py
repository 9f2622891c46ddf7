"""Helpers of the port's parity tests.

`run_reference` runs reference (JAX) code in a subprocess: the reference
needs up to 8 fake CPU devices for nb > 1, and XLA fixes the device count
when jax first starts, so the reference runs in a fresh interpreter with
XLA_FLAGS set, as tests/test_distributed.py does.  The body fills a dict
`OUT` of numpy arrays; the helper saves it as an .npz and returns it loaded.

The disk tier's parity is file bytes: `npy_shas` hashes the result files a
generator leaves at the top of its workdir (CSR bucket files, pv.npy), and
`report_rows` drops the timing keys of `orchestrator.report()`.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Hypothesis writes its caches (local constants, unicode tables) where this
# variable points, or else into the tracked .hypothesis/ of the checkout.
# Every test file of the port imports this module, so each pytest process sets
# it at collection, before any hypothesis test of the suite runs; the reference
# subprocesses below inherit it.
os.environ.setdefault("HYPOTHESIS_STORAGE_DIRECTORY",
                      os.path.join(ROOT, "build", "hypothesis"))
ENV = dict(os.environ,
           XLA_FLAGS="--xla_force_host_platform_device_count=8",
           JAX_PLATFORMS="cpu",
           PYTHONPATH="src")

_PRELUDE = "import sys\nimport numpy as np\nOUT = {}\n"
_EPILOGUE = "\nnp.savez(sys.argv[1], **{k: np.asarray(v) for k, v in OUT.items()})\n"


def run_reference(body: str, timeout: float = 600) -> dict:
    """Run `body` (which fills OUT) under the reference and return OUT's arrays."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "out.npz")
        r = subprocess.run([sys.executable, "-c", _PRELUDE + body + _EPILOGUE, path],
                           env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def npy_shas(workdir: str) -> dict:
    """{file name: sha256} of the .npy files at the top of `workdir`."""
    out = {}
    for name in sorted(os.listdir(workdir)):
        if name.endswith(".npy"):
            with open(os.path.join(workdir, name), "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def report_rows(orchestrator) -> list:
    """`orchestrator.report()` without its timing keys (seconds, *_s)."""
    return [{k: v for k, v in row.items() if k != "seconds" and not k.endswith("_s")}
            for row in orchestrator.report()]


@pytest.fixture
def one_torch_thread():
    """One PyTorch intra-op thread for the test.  The suite runs in several
    processes at once, and PyTorch's default pool of one thread per core
    oversubscribes them: a small train step then waits on its threads
    (launch/train.py at scale 9: 18 s under load against 0.6 s with one
    thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
