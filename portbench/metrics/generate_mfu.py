"""generate_mfu: the least time of a whole `generate` call, every byte it
returns written once at the card's memory bandwidth, over the call's
CUDA-event time, as a share of that peak."""

from portbench.metrics import _counts as C


def read(w):
    return C.share(C.generate_returned(w.sizes), len(w.call_ms), sum(w.call_ms) / 1e3, w.peaks)
