"""cards_wait_ms: one card's device time a call in the span "cards.wait"
(its stream held until the other cards' receive buffers are free before it
sends, and until their copies into it have landed), the mean over the
cards, from the program's CUDA events: the stalls that the copies'
own time in cards_exchange_ms leaves out."""

from portbench.metrics import _spans as S


def read(w):
    total = S.ms_a_call(w, "cards.wait")
    cards = w.sizes.get("cards")
    return total / cards if total is not None and cards else None
