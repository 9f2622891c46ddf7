"""bucket_hist_roofline.generate: the least time of `bucket_hist`'s work in
the window (the owners of each call's m edges) over the profiler's device
time of the kernels named `bucket_hist_kernel`."""

from portbench.metrics import _counts as C


def read(w):
    if w.device is None:
        return None
    return C.share(C.bucket_hist_generate(w.sizes), w.calls,
                   w.device.seconds("bucket_hist_kernel"), w.peaks)
