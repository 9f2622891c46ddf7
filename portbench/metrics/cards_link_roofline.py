"""cards_link_roofline: the least bytes that crossed between cards (the
program's counter "cards.exchange/bytes": the live records copied to
another card times their width), over the device time of the spans
"cards.exchange" that hold those copies and nothing else (each card's
waits for the others are spans "cards.wait"), against one card's NVLink
peak in one direction, as a share of it.  Summed over the cards, bytes and
time alike: a card sends at most its peak while its spans run.

The peak: 450 GB/s, half of the 900 GB/s of NVLink that NVIDIA's H100 SXM5
data sheet gives one card, both directions together."""

from portbench.metrics import _spans as S

NVLINK_BYTES_PER_S = 450e9


def read(w):
    got = S.taken(w)
    if not got or not got["counters"].get("cards.exchange/bytes"):
        return None
    ms = sum(t for name, _, t in got["spans"] if name == "cards.exchange")
    if ms <= 0:
        return None
    return 100.0 * got["counters"]["cards.exchange/bytes"] / (ms / 1e3) / NVLINK_BYTES_PER_S
