"""feistel_perm_roofline: the least time of `feistel_perm`'s work in the
window (pv and both fields of each call) over the profiler's device time
of the kernels named `feistel_perm_kernel`."""

from portbench.metrics import _counts as C


def read(w):
    if w.device is None:
        return None
    return C.share(C.feistel_perm(w.sizes), w.calls,
                   w.device.seconds("feistel_perm_kernel"), w.peaks)
