"""The program's device spans and counters of a traced window
(`repro_torch.core.trace`): the spans open and close inside the program,
each timed by CUDA events on the card, and a profiled window records them
without an install.  They are taken from the program once, by the first reader that
asks, and kept on the window for the others.  Where the program records
none (a checkout without device spans), every reader of them reads None."""

from __future__ import annotations

from typing import Dict, Optional

KEPT = "program_spans"           # the window's attribute that keeps what was taken


def taken(w) -> Optional[Dict]:
    """{"spans": [(name, parent, ms), ...], "counters": {name: int}} of the
    window, or None where the program recorded nothing."""
    if KEPT not in vars(w):
        from repro_torch.core import trace

        take = getattr(trace, "take_device_spans", None)
        got = take() if take is not None else None
        setattr(w, KEPT, got if got and (got["spans"] or got["counters"]) else None)
    return getattr(w, KEPT)


def ms_a_call(w, name: str) -> Optional[float]:
    """The window's total device time of the spans named `name` over its calls."""
    got = taken(w)
    times = [ms for n, _, ms in got["spans"] if n == name] if got else []
    return sum(times) / w.calls if times and w.calls > 0 else None


def share(w, part: str, whole: str) -> Optional[float]:
    """Per cent of counter `whole` that counter `part` holds."""
    got = taken(w)
    counters = got["counters"] if got else {}
    if not counters.get(whole) or part not in counters:
        return None
    return 100.0 * counters[part] / counters[whole]
