"""redistribute_merge_kernel_share: the share of the live records merged
under the span "redistribute.merge" that the hand-written merge kernel
merged: the program's counters "kernel" over "live" there (100 on the
card; a program without the counters reads None)."""

from portbench.metrics import _spans as S


def read(w):
    return S.share(w, "redistribute.merge/kernel", "redistribute.merge/live")
