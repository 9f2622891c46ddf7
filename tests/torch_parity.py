"""Helper of the port's parity tests: run reference (JAX) code in a subprocess.

The reference needs up to 8 fake CPU devices for nb > 1, and XLA fixes the
device count when jax first starts, so the reference runs in a fresh
interpreter with XLA_FLAGS set, as tests/test_distributed.py does.  The body
fills a dict `OUT` of numpy arrays; the helper saves it as an .npz and
returns it loaded.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
