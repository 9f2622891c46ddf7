"""cards_exchange_ms: one card's device time a call in the span
"cards.exchange" (the program's copies between cards: the shuffle's
slices, the ring relabel's pv chunks, redistribute's buckets; the waits
for other cards are spans of their own), the mean over the cards, from
the program's CUDA events."""

from portbench.metrics import _spans as S


def read(w):
    total = S.ms_a_call(w, "cards.exchange")
    cards = w.sizes.get("cards")
    return total / cards if total is not None and cards else None
