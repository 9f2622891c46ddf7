"""The profiler's trace of a window, reduced: the device's busy time, the
device time of each kernel, and where the device sat idle.

`start` opens a `torch.profiler` session (CPU and CUDA activity) and marks
the window with a `record_function` range; `stop` closes both and reads the
raw events once.  Busy time is the union of the intervals in which a kernel,
copy or set ran on the device, inside the window's range (annotations that
span kernels are not work and are left out).  An idle gap is charged to the
host operation that was running in its middle: the innermost CPU event of
the main thread that covers that instant, or "host" where none does.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
TOP = 10
NAME_CHARS = 160          # of a kernel's name in the breakdown (template arguments go)


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float
    window_s: float
    kernels: Dict[str, Tuple[float, int]]   # name -> (device seconds, launches)
    breakdown: dict

    def seconds(self, substring: str) -> float:
        """Device seconds of the kernels whose name contains `substring`."""
        return sum(s for name, (s, _) in self.kernels.items() if substring in name)


def start():
    """Open the profiler and the window's range; `stop` closes both."""
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    window = record_function(WINDOW)
    window.__enter__()
    return prof, window


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def attribute_gaps(gaps: List[Tuple[int, int]],
                   host: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of idle gaps by the innermost host event covering each gap's
    middle.  `host` holds (start, end, name) of one thread's events, which
    nest; a parent chain is built once by a sweep."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    parent, stack = [-1] * len(host), []
    for i, (s, e, _) in enumerate(host):
        while stack and host[stack[-1]][1] <= s:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and host[i][1] < mid:
            i = parent[i]
        name = host[i][2] if i >= 0 else "host"
        out[name] = out.get(name, 0.0) + (ge - gs) / 1e9
    return out


def stop(session) -> DeviceTrace:
    """Close what `start` opened and reduce the profiler's events."""
    from torch.autograd import DeviceType

    prof, window = session
    window.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    events = prof.profiler.kineto_results.events()
    lo = hi = None
    device, host_by_thread = [], {}
    kernels: Dict[str, List[float]] = {}
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name == WINDOW:
                continue
            s = e.start_ns()
            d = e.duration_ns()
            device.append((s, s + d))
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += d / 1e9
            k[1] += 1
        elif e.device_type() == DeviceType.CPU:
            s = e.start_ns()
            if name == WINDOW:
                lo, hi = s, s + e.duration_ns()
            thread = host_by_thread.setdefault(e.start_thread_id(), [])
            thread.append((s, s + e.duration_ns(), name))
    if lo is None:
        raise RuntimeError("the profiler recorded no window range")
    busy = [(max(s, lo), min(e, hi)) for s, e in union(device) if e > lo and s < hi]
    busy_ns = sum(e - s for s, e in busy)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    main = max(host_by_thread.values(), key=len) if host_by_thread else []
    main = [h for h in main if h[2] != WINDOW]
    idle = attribute_gaps(gaps, main)
    top_ops = sorted(((n, s) for n, (s, _) in kernels.items()), key=lambda x: -x[1])[:TOP]
    top_gaps = sorted(idle.items(), key=lambda x: -x[1])[:TOP]
    return DeviceTrace(
        busy_s=busy_ns / 1e9, window_s=(hi - lo) / 1e9,
        kernels={n: (s, c) for n, (s, c) in kernels.items()},
        breakdown={"device_ops": [[n[:NAME_CHARS], s] for n, s in top_ops],
                   "idle_gaps": [[n, s] for n, s in top_gaps]})
