"""Build, load and launch bookkeeping of the hand-written CUDA kernels.

`csrc/graph_kernels.cu` is compiled with `nvcc` for `sm_90a` at first use
into `build/kernels/` at the root of the checkout (git-ignored), named by the
source's hash so an edited source is rebuilt, and loaded with `ctypes`.  Every
C entry point returns `cudaGetLastError()`; `check` raises on a nonzero code.

`LAUNCHES` counts the launches of each kernel: a wrapper adds one exactly
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "graph_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("rmat_edges", "feistel_perm", "relabel_gather", "bucket_hist")
LAUNCHES = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint
_SIGNATURES = {
    "rmat_edges_launch": [_P, _P, _LL, _U, _U, _I, _U, _U, _U, _P],
    "feistel_perm_launch": [_P, _P, _LL, _I, _I, ctypes.POINTER(_U), _P],
    "relabel_gather_launch": [_P, _P, _P, _LL, _LL, _LL, _P],
    "bucket_hist_launch": [_P, _LL, _I, _P, _I, _P],
}

_lib = None


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (`nvcc`, `cuobjdump`)."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", name)


def build() -> Path:
    """Compile the kernels' shared library unless this source was built already."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libgraph_kernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n{r.stdout}{r.stderr}")
    out.with_suffix(".log").write_text(r.stdout + r.stderr)   # ptxas -v: registers, spills
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        lib.graph_kernels_error_string.argtypes = [_I]
        lib.graph_kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().graph_kernels_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
