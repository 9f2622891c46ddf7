"""walks_mfu: the least time of a whole `distributed_walks` call, each
returned row written once and each hop's offsets and adjacency entry read
once at the card's memory bandwidth, over the call's CUDA-event time, as a
share of that peak."""

from portbench.metrics import _counts as C


def read(w):
    return C.share(C.walks_least(w.sizes), len(w.call_ms), sum(w.call_ms) / 1e3, w.peaks)
