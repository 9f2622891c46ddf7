"""Build, load and launch bookkeeping of the hand-written CUDA kernels.

Each source in `csrc/` is compiled with `nvcc` for `sm_90a` at first use into
its own shared library in `build/kernels/` at the root of the checkout
(git-ignored), named by the source's hash so an edited source is rebuilt;
the `nvcc` of every source that needs it are started together.  The
libraries are loaded with `ctypes`.  Every C entry point returns
`cudaGetLastError()`; `check` raises on a nonzero code.

`LAUNCHES` counts the launches of each kernel: a wrapper adds one exactly
where it launches its kernel, and nowhere else (`flash_attention` adds one
to its own count and one to that of the kernel it launched).  The disk
tier's worker processes count their own; `PartitionedGenerator` adds them
to this process's at each barrier (`add_worker_launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "graph_kernels.cu", CSRC / "attention_kernels.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("rmat_edges", "feistel_perm", "relabel_gather", "bucket_hist", "flash_attention")
# the two kernels behind the flash_attention wrapper, each also counted on its own
FLASH_KERNELS = ("flash_attention_decode", "flash_attention_prefill")
LAUNCHES = {name: 0 for name in KERNELS + FLASH_KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint
_SIGNATURES = {
    "rmat_edges_launch": [_P, _P, _LL, _U, _U, _I, _U, _U, _U, _P],
    "feistel_perm_launch": [_P, _P, _LL, _I, _I, ctypes.POINTER(_U), _P],
    "relabel_gather_launch": [_P, _P, _P, _LL, _LL, _LL, _LL, _P],
    "bucket_hist_launch": [_P, _LL, _I, _I, _I, _I, _P, _P, _P, _P],
    "flash_attention_launch": [_P] * 8 + [_I] * 14 + [ctypes.c_float, _P],
}

_lib = None
_COUNTERS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def add_worker_launches(counts: dict) -> None:
    """Add the launches a worker process counted (its `LAUNCHES` delta)."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """int32 counters on `device` for kernels launched on `stream` whose last
    block is chosen by an atomic counter (the decode kernel's chunk merge,
    `bucket_hist`'s sum): zero, and left zero by every launch (that block
    resets its counter).  Launches on one stream run in turn, so they share."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (`nvcc`, `cuobjdump`)."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", name)


def build() -> list[Path]:
    """The shared library of each source, in `SOURCES` order, compiling those
    not built already: one `nvcc` per source, all started together."""
    outs = [BUILD_DIR / f"lib{src.stem}_{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
            for src in SOURCES]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src, out in zip(SOURCES, outs):
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        with tmp.with_suffix(".log").open("w") as log:   # ptxas -v: registers, spills
            jobs.append((cmd, tmp, out, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    try:
        for cmd, tmp, out, proc in jobs:
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{tmp.with_suffix('.log').read_text()}")
            os.replace(tmp.with_suffix(".log"), out.with_suffix(".log"))
            os.replace(tmp, out)
    finally:
        for *_, proc in jobs:     # after a failure, stop the other nvcc
            if proc.poll() is None:
                proc.kill()
    return outs


def library() -> SimpleNamespace:
    """The kernels' C entry points, from the libraries built on first use."""
    global _lib
    if _lib is None:
        libs = [ctypes.CDLL(str(path)) for path in build()]
        fns = {}
        for name, argtypes in _SIGNATURES.items():
            fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
            fn.argtypes = argtypes
            fn.restype = _I
            fns[name] = fn
        fns["error_string"] = libs[0].graph_kernels_error_string
        fns["error_string"].argtypes = [_I]
        fns["error_string"].restype = ctypes.c_char_p
        _lib = SimpleNamespace(**fns)
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
