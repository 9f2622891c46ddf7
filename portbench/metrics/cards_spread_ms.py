"""cards_spread_ms: the slowest card's device time in the span
"generate.card" (each card's whole `generate`, one span a card and call)
less the fastest card's, the mean over the calls: how long the other cards
wait for a straggler.  The spans of a call are its `cards` first ones in
entry order."""

from portbench.metrics import _spans as S


def read(w):
    got = S.taken(w)
    cards = w.sizes.get("cards")
    times = [ms for name, _, ms in got["spans"] if name == "generate.card"] if got else []
    if not times or not cards or len(times) % cards:
        return None
    calls = [times[i:i + cards] for i in range(0, len(times), cards)]
    return sum(max(c) - min(c) for c in calls) / len(calls)
