"""redistribute_sort_ms: the mean device time a call of the span
"redistribute.sort" (`redistribute_sorted`'s send-side stable sort, its
gather and stack), from the program's CUDA events."""

from portbench.metrics import _spans as S


def read(w):
    return S.ms_a_call(w, "redistribute.sort")
