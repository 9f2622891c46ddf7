"""walks_exchange_ms: the mean device time a call of the spans
"walks.exchange", summed over its hops (`capacity_all_to_all` of every
walker row to the owner of its vertex), from the program's CUDA events."""

from portbench.metrics import _spans as S


def read(w):
    return S.ms_a_call(w, "walks.exchange")
