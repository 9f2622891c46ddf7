"""redistribute_exchange_ms: the mean device time a call of the span
"redistribute.exchange" (`redistribute_sorted`'s `capacity_all_to_all`: per
sender the argsort, `bucket_hist`, rank scatters and the slot scatter),
from the program's CUDA events."""

from portbench.metrics import _spans as S


def read(w):
    return S.ms_a_call(w, "redistribute.exchange")
