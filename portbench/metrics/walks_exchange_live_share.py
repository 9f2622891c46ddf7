"""walks_exchange_live_share: the share of the walk exchange's rows that
carry a live walker, the useful records among those bucketed: the
program's counters "live" over "rows" under the span "walks.exchange"."""

from portbench.metrics import _spans as S


def read(w):
    return S.share(w, "walks.exchange/live", "walks.exchange/rows")
