"""redistribute_merge_ms: the mean device time a call of the span
"redistribute.merge" (each receiver's k-way `merge_sorted_runs`), from the
program's CUDA events."""

from portbench.metrics import _spans as S


def read(w):
    return S.ms_a_call(w, "redistribute.merge")
