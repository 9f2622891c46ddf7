"""walks_advance_ms: the mean device time a call of the spans
"walks.advance", summed over its hops (the local CSR gathers, `walk_rand`
and the three payload writes), from the program's CUDA events."""

from portbench.metrics import _spans as S


def read(w):
    return S.ms_a_call(w, "walks.advance")
