"""redistribute_slot_fill: the share of the exchange's slots (nb x nb x
capacity, all of which the merge sorts) that hold an edge: the program's
counters "kept" over "slots" under the span "redistribute.exchange"."""

from portbench.metrics import _spans as S


def read(w):
    return S.share(w, "redistribute.exchange/kept", "redistribute.exchange/slots")
