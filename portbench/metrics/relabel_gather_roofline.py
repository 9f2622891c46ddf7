"""relabel_gather_roofline: the least time of `relabel_gather`'s work in the
window (both fields of each call's ring relabel) over the profiler's
device time of the kernels named `relabel_gather_kernel`."""

from portbench.metrics import _counts as C


def read(w):
    if w.device is None:
        return None
    return C.share(C.relabel_gather(w.sizes), w.calls,
                   w.device.seconds("relabel_gather_kernel"), w.peaks)
