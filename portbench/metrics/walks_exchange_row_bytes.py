"""walks_exchange_row_bytes: the bytes of one row that the walk exchange is
offered, what each walker moves between shards each hop: the program's
counters "row_bytes" over "rows" under the span "walks.exchange" (a program
without the "row_bytes" counter reads None)."""

from portbench.metrics import _spans as S


def read(w):
    share = S.share(w, "walks.exchange/row_bytes", "walks.exchange/rows")
    return None if share is None else share / 100.0
