"""rmat_edges_roofline: the least time of `rmat_edges`'s work in the window
(all m edges of each call) over the profiler's device time of the kernels
named `rmat_edges_kernel`."""

from portbench.metrics import _counts as C


def read(w):
    if w.device is None:
        return None
    return C.share(C.rmat_edges(w.sizes), w.calls,
                   w.device.seconds("rmat_edges_kernel"), w.peaks)
