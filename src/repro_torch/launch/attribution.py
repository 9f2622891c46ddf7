"""The heaviest contributors of a profiled run on the card (counterpart of
`repro/launch/attribution.py`).

The reference ranks the HLO instructions of a compiled step by the bytes
they move, trip counts applied, as its stand-in for a wall-clock profile.
On the card there is a profile: `torch.profiler` records every kernel and
copy with its device time.  So `top_bytes` ranks the profiler's CUDA events
by device time, kernel by kernel, and `by_op` sums them by kind of work
(matrix products, elementwise, reductions, copies, ...); the names stay the
reference's.  `profiled_kernels` picks the port's own kernels out of a
profile, for checking launches against the wrappers' counts.

Each function takes a finished `torch.profiler.profile` (or anything whose
`key_averages()` yields events with `device_type`, `key`,
`self_device_time_total` in microseconds and `count`).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Tuple

# (kind, substrings of a kernel name), first match wins; names are lowered
_KINDS = (
    ("port_kernel", ("bucket_hist_kernel", "rmat_edges_kernel", "feistel_perm_kernel",
                     "relabel_gather_kernel", "flash_attention")),
    ("matmul", ("gemm", "gemv", "xmma", "cutlass", "cublas", "matmul", "dot_kernel")),
    ("copy", ("memcpy", "memset", "copy_kernel", "cat_", "catarray")),
    ("sort", ("sort", "radix", "scan_kernel", "cub::")),
    ("index", ("index", "scatter", "gather", "embedding")),
    ("reduce", ("reduce", "norm", "softmax", "logsumexp")),
    ("elementwise", ("elementwise", "foreach")),
)


def _cuda_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_rows(prof) -> List[Tuple[float, str, int]]:
    """(device ms, kernel or copy name, launches) of every CUDA event with
    device time."""
    return [(e.self_device_time_total / 1e3, e.key, e.count) for e in _cuda_events(prof)
            if e.self_device_time_total > 0]


def top_bytes(prof, n: int = 15) -> List[Tuple[float, str, int]]:
    """The n events with the most device time, most first."""
    return sorted(device_rows(prof), key=lambda r: -r[0])[:n]


def op_kind(name: str) -> str:
    low = name.lower()
    return next((kind for kind, subs in _KINDS if any(s in low for s in subs)), "other")


def by_op(prof) -> List[Tuple[str, float]]:
    """Device ms summed by kind of work (`op_kind`), most first."""
    agg: Counter = Counter()
    for ms, name, _ in device_rows(prof):
        agg[op_kind(name)] += ms
    return agg.most_common()


def profiled_kernels(prof, names: Iterable[str]) -> Dict[str, Dict[str, float]]:
    """Per kernel of the port (`names`, e.g. "bucket_hist"), the launches and
    device ms the profiler recorded for CUDA kernels named `<name>_kernel...`."""
    out = {k: {"launches": 0, "ms": 0.0} for k in names}
    for e in _cuda_events(prof):
        for k in out:
            if f"{k}_kernel" in e.key:
                out[k]["launches"] += e.count
                out[k]["ms"] += e.self_device_time_total / 1e3
    return out
