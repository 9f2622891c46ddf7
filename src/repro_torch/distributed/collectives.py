"""The k:1 scatter-gather collective over nb shards placed on 1 or D cards
(twin of `repro.distributed.collectives`).

The reference runs these inside `shard_map` over nb devices.  Here the nb
shards are placed on the devices of a `Cards`: shard i on card i // (nb /
D), each card's shards the leading dimension of its arrays (its block).
With one card every shard is resident:

    lax.all_to_all  ->  swap of dims 0 and 1 of [sender, dest, cap, ...]
    lax.ppermute    ->  torch.roll over dim 0   (ring_shift)
    lax.psum        ->  .sum()

Across D cards the same collectives also copy between the cards
(`CardExchange`): the [sender, dest] -> [dest, sender] swap sends each
bucket to its receiver's card, the shuffle's slices cross as whole rows
(`slice_exchange`), pv is gathered on every card once a call
(`all_gather`: the ring relabel then finds every chunk resident, so no
ring passes between cards), and a sum over shards adds the cards' sums on
card 0.  One process drives every card, each on its current stream; a
copy between two cards runs on the sender's stream (peer to peer where
the cards can reach each other's memory), ordered by CUDA events, with no
host synchronisation.

`bucket_by_destination`, `unbucket`, `merge_two_sorted` and
`merge_sorted_runs` are per-shard functions with the reference's signatures.
The per-destination counts that place each bucket come from the
`bucket_hist` kernel.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.trace import count, counting, device_span
from ..kernels import build
from ..kernels.bucket import bucket_hist

JUNK_ROWS = 1 << 16   # rows past the buckets that take dead records (a power of two)
EXCHANGE_SPAN = "cards.exchange"     # the device span of every copy between cards
WAIT_SPAN = "cards.wait"             # the device span of every wait for another card


class Cards(NamedTuple):
    """The placement of nb shards over cards: shard i on
    devices[i // per_card], so each card holds per_card consecutive shards
    as the leading dimension of its arrays (its block).  A device may
    repeat: its blocks are then held apart on it, as on separate cards."""

    devices: Tuple[torch.device, ...]
    nb: int

    @property
    def count(self) -> int:
        return len(self.devices)

    @property
    def per_card(self) -> int:
        return self.nb // len(self.devices)

    def first(self, card: int) -> int:
        """The first shard of `card`."""
        return card * self.per_card


def _normal(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


_PEERS: set = set()     # (from, to) card indices whose peer access this process asked for


def place(nb: int, devices: Sequence) -> Cards:
    """The placement of nb shards over `devices` (1 or more, nb a multiple
    of their count).  Where two of them are distinct CUDA devices, peer
    access between them is asked for once a process: torch enables it on
    the first copy between two cards that can reach each other's memory."""
    devs = tuple(torch.device(d) for d in devices)
    if len(devs) > 1:
        devs = tuple(_normal(d) for d in devs)
    if not devs or nb < len(devs) or nb % len(devs):
        raise ValueError(f"nb={nb} shards do not split evenly over {len(devs)} devices")
    for a in devs:
        for b in devs:
            if a.type == b.type == "cuda" and a != b and (a.index, b.index) not in _PEERS:
                torch.zeros(1, device=b).copy_(torch.zeros(1, device=a))
                _PEERS.add((a.index, b.index))
    return Cards(devs, nb)


def first_block(x):
    """The one-card form of a per-card result: each list of blocks (in a
    NamedTuple too) replaced by its one block."""
    if isinstance(x, list):
        if len(x) != 1:
            raise ValueError(f"{len(x)} blocks where one card was asked for")
        return x[0]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(first_block(f) for f in x))
    return x


@contextlib.contextmanager
def card_spans(name: str, cards: Cards):
    """One device span `name` on each card, all open over the block (one
    span on one card)."""
    with contextlib.ExitStack() as stack:
        for dev in cards.devices:
            stack.enter_context(device_span(name, dev))
        yield


_STREAMS: dict = {}     # CUDA device -> the stream its work over several cards runs on


@contextlib.contextmanager
def card_streams(cards: Cards):
    """Over several cards, each card's work on a stream of its own in place
    of its default stream, whose implicit ordering queues one card's work
    behind the copies other cards send it.  A card keeps its stream from
    call to call, so that the caching allocator reuses the blocks of
    earlier calls; work that should reuse the blocks a call leaves cached
    (its results' neighbours) runs inside it too.  On entry each stream
    waits for its card's current stream, and the current device stays; on
    exit the current stream waits for it.  One card: nothing."""
    devs = [d for d in dict.fromkeys(cards.devices) if d.type == "cuda"]
    if cards.count == 1 or not devs:
        yield
        return
    here = torch.cuda.current_device()
    before = [torch.cuda.current_stream(d) for d in devs]
    mine = [_STREAMS.setdefault(d, torch.cuda.Stream(device=d)) for d in devs]
    for stream, prev in zip(mine, before):
        stream.wait_stream(prev)
        torch.cuda.set_stream(stream)       # which also makes its card current
    torch.cuda.set_device(here)
    try:
        yield
    finally:
        for stream, prev in zip(mine, before):
            torch.cuda.set_stream(prev)
            prev.wait_stream(stream)
        torch.cuda.set_device(here)


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev)


class CardExchange:
    """The copies between cards of one exchange.

    Make it once every card's receive buffers exist: it records on each
    card's stream that they do.  `send(c)` makes card c's stream wait for
    every other card's record (once an exchange), then wraps c's copies in
    a span "cards.exchange" on c and records that they are issued; `copy`
    runs on the sender's stream.  `arrive()` makes each card's stream wait
    for every card that sent to it.  Both waits are spans "cards.wait", so
    that "cards.exchange" times the copies alone.  Between blocks on one
    device, and on the CPU, a copy is a plain copy on that device's stream,
    and no event is needed; such copies are spanned and counted as well.

    Under the span, copies count "copies" and "bytes": the least bytes that
    crossed, the live records times their width (given by the caller where
    a copy carries empty slots)."""

    def __init__(self, cards: Cards):
        self.cards = cards
        devs = cards.devices
        self.peer = len(set(devs)) > 1 and all(d.type == "cuda" for d in devs)
        self.ready = [self._record(d) for d in devs] if self.peer else None
        self.waited: set = set()          # senders whose streams waited for the receivers
        self.sent: dict = {}              # sender -> its newest "issued" event (or None)
        self.to: dict = {}                # receiver -> senders

    @staticmethod
    def _record(dev: torch.device):
        event = torch.cuda.Event()
        event.record(_stream(dev))
        return event

    @contextlib.contextmanager
    def send(self, c: int):
        dev = self.cards.devices[c]
        if self.peer and c not in self.waited:
            self.waited.add(c)
            with device_span(WAIT_SPAN, dev):
                for d, event in enumerate(self.ready):
                    if d != c:
                        _stream(dev).wait_event(event)
        with device_span(EXCHANGE_SPAN, dev):
            yield
            self.sent[c] = self._record(dev) if self.peer else None

    def copy(self, dst: torch.Tensor, src: torch.Tensor, c: int, d: int,
             live_bytes=None) -> None:
        """dst (on card d) = src (on card c), inside `send(c)`."""
        self.to.setdefault(d, set()).add(c)
        if src.device == dst.device:
            dst.copy_(src)
        else:
            if not (src.is_contiguous() and dst.is_contiguous()) or src.dtype != dst.dtype \
                    or src.shape != dst.shape:
                raise ValueError("a copy between cards takes contiguous tensors of one shape "
                                 "and dtype")
            with torch.cuda.device(src.device):
                err = build.library().copy_peer_launch(
                    dst.data_ptr(), dst.device.index, src.data_ptr(), src.device.index,
                    src.numel() * src.element_size(), _stream(src.device).cuda_stream)
            build.check(err, "copy_peer")
        if counting():
            count("copies", 1)
            count("bytes", src.numel() * src.element_size() if live_bytes is None else live_bytes)

    def arrive(self) -> None:
        """Each card's stream waits for the copies sent to it."""
        for d, senders in sorted(self.to.items()):
            senders = sorted(s for s in senders if s != d)
            if not senders:
                continue
            with device_span(WAIT_SPAN, self.cards.devices[d]):
                for c in senders:
                    if self.sent.get(c) is not None:
                        _stream(self.cards.devices[d]).wait_event(self.sent[c])


def cards_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of one tensor a card, on the first card (psum over shards
    when each part is its card's sum)."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return total


def all_gather(blocks: Sequence[torch.Tensor], cards: Cards) -> List[torch.Tensor]:
    """Each card's copy of the whole flat array whose card c holds block c
    (all_gather over the shards); one card's block itself."""
    if cards.count == 1:
        return [blocks[0].reshape(-1)]
    flat = [b.reshape(-1) for b in blocks]
    size = flat[0].numel()
    out = [torch.empty(size * cards.count, dtype=flat[0].dtype, device=dev)
           for dev in cards.devices]
    ex = CardExchange(cards)
    for c in range(cards.count):
        out[c][c * size:(c + 1) * size].copy_(flat[c])
    for c in range(cards.count):
        with ex.send(c):
            for d in range(cards.count):
                if d != c:
                    ex.copy(out[d][c * size:(c + 1) * size], flat[c], c, d)
    ex.arrive()
    return out


def slice_exchange(blocks: Sequence[torch.Tensor], cards: Cards) -> List[torch.Tensor]:
    """The shuffle's 1:1 exchange: slice j of shard i's row goes to shard j,
    as slice i of its row.  blocks: per card [per_card, B] with B a multiple
    of nb; [sender, dest, blk] -> [dest, sender, blk]."""
    nb, S, D = cards.nb, cards.per_card, cards.count
    B = blocks[0].shape[1]
    blk = B // nb
    old = [b.reshape(S, nb, blk) for b in blocks]
    new = [torch.empty((S, nb, blk), dtype=b.dtype, device=b.device) for b in blocks]
    ex = CardExchange(cards)
    for c in range(D):                      # each card's own slices, before any copy
        lo = cards.first(c)
        new[c][:, lo:lo + S] = old[c][:, lo:lo + S].transpose(0, 1)
    for c in range(D if D > 1 else 0):
        lo = cards.first(c)
        with ex.send(c):
            for d in range(D):
                if d == c:
                    continue
                for sl in range(S):
                    for dl in range(S):
                        ex.copy(new[d][dl, lo + sl], old[c][sl, cards.first(d) + dl], c, d)
    ex.arrive()
    return [n.reshape(S, B) for n in new]



class Buckets(NamedTuple):
    data: torch.Tensor      # [k, capacity, ...] bucketed payload
    valid: torch.Tensor     # [k, capacity] bool
    position: torch.Tensor  # [N] int64 dest*capacity + slot (k*capacity if dropped)
    dropped: torch.Tensor   # [] int32 records beyond capacity
    counts: torch.Tensor    # [k] int32 records per destination (valid ones), from bucket_hist


def bucket_by_destination(data: torch.Tensor, dest: torch.Tensor, k: int, capacity: int,
                          valid: Optional[torch.Tensor] = None) -> Buckets:
    """Stable bucketing of `data` rows by `dest` in [0, k) with fixed capacity.

    Records keep their relative order within a destination; those past
    `capacity` are counted in `dropped`; rows with valid=False take no slot.
    """
    n = dest.shape[0]
    dev = dest.device
    dest = dest.to(torch.int32)
    if valid is not None:
        dest = torch.where(valid, dest, k)                     # sentinel group
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    # Start of each destination group: exclusive prefix sum of the counts
    # (records with the sentinel k are not counted, so this equals the
    # reference's searchsorted over the sorted destinations).
    hist = bucket_hist(dest, k)
    counts = hist.to(torch.int64)
    group_start = torch.cumsum(counts, 0) - counts
    rank_sorted = (torch.arange(n, dtype=torch.int64, device=dev)
                   - group_start[sorted_dest.clamp(max=k - 1).to(torch.int64)])
    del sorted_dest
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    del order, rank_sorted
    real = dest < k
    keep = (rank < capacity) & real
    slot = torch.where(keep, dest.to(torch.int64) * capacity + rank, k * capacity)
    dropped = ((rank >= capacity) & real).sum().to(torch.int32)
    # Records that take no slot are written past the k*capacity slots and
    # cut off below.  A caller that marks dead records (`valid`: 7 in 8 of a
    # walk's rows) gets them spread over JUNK_ROWS rows by rank, since the
    # card serialises writes to one row.  The others drop nothing when sized
    # right, and the spread's three int64 passes would cost the scale-26
    # graph path's redistribute 21 ms on an H100 (scripts/time_generate.py).
    junk, write = 1, slot
    if valid is not None:
        junk, write = JUNK_ROWS, torch.where(keep, slot, slot + (rank & (JUNK_ROWS - 1)))
    del rank, keep, real
    tail = tuple(data.shape[1:])
    flat = torch.zeros((k * capacity + junk,) + tail, dtype=data.dtype, device=dev)
    flat[write] = data
    occupied = torch.zeros(k * capacity + junk, dtype=torch.bool, device=dev)
    occupied.index_fill_(0, write, True)      # a scalar fill: no copy from the host
    return Buckets(
        data=flat[:k * capacity].reshape((k, capacity) + tail),
        valid=occupied[:k * capacity].reshape(k, capacity),
        position=slot,
        dropped=dropped,
        counts=hist,
    )


def unbucket(buckets_data: torch.Tensor, position: torch.Tensor, fill=0) -> torch.Tensor:
    """Inverse of bucket_by_destination for the return trip; dropped records get `fill`."""
    k, capacity = buckets_data.shape[:2]
    flat = buckets_data.reshape((k * capacity,) + tuple(buckets_data.shape[2:]))
    pad = torch.full((1,) + tuple(flat.shape[1:]), fill, dtype=flat.dtype, device=flat.device)
    return torch.cat([flat, pad])[position]


class ExchangeResult(NamedTuple):
    """One card: tensors; over cards (`cards` given): a list of one block a
    card, each card's shards as receivers (data, valid), `position` None
    (no return trip crosses cards), and `dropped` summed on the first card."""

    data: torch.Tensor      # [nb, nb, capacity, ...] [receiver, sender] records
    valid: torch.Tensor     # [nb, nb, capacity] bool
    position: torch.Tensor  # [nb, N] each sender's bucketing positions
    dropped: torch.Tensor   # [] int32 dropped over all shards


def capacity_all_to_all(data, dest, *, capacity: int, valid=None,
                        cards: Optional[Cards] = None) -> ExchangeResult:
    """Bucket each shard's records by destination shard and exchange them.

    `data` is [nb, N, ...], `dest` [nb, N] in [0, nb); with `cards`, each is
    a list of one block a card ([per_card, N, ...]), and no sender keeps
    the positions of its records (8 bytes a record).  Each sender's buckets
    are written straight into the receivers' rows: the all_to_all is the
    [sender, dest] -> [dest, sender] transpose, done while bucketing; the
    buckets of a receiver on another card are copied there whole (slots
    and all: their live lengths stay on the device).  Rows with `valid`
    False are discarded without taking a slot.

    Where a device span records (`core/trace.py`), the exchange counts under
    it the records offered ("rows", dead ones included), those valid
    ("live", from each sender's bucket counts), those given a slot ("kept",
    live less dropped) and the slots ("slots"); the copies between cards
    count theirs under "cards.exchange" (`CardExchange`).
    """
    if cards is None:
        return first_block(_all_to_all([data], [dest], capacity,
                                       None if valid is None else [valid],
                                       Cards((data.device,), data.shape[0]), positions=True))
    return _all_to_all(data, dest, capacity, valid, cards, positions=False)


def _all_to_all(data, dest, capacity: int, valid, cards: Cards, positions: bool) -> ExchangeResult:
    nb, S, D = cards.nb, cards.per_card, cards.count
    tail = tuple(data[0].shape[2:])
    width = data[0].element_size() * int(torch.Size(tail).numel())
    recv = [torch.empty((S, nb, capacity) + tail, dtype=x.dtype, device=x.device) for x in data]
    recv_valid = [torch.empty((S, nb, capacity), dtype=torch.bool, device=x.device) for x in data]
    position = [torch.empty(d.shape, dtype=torch.int64, device=d.device) for d in dest] \
        if positions else None
    dropped = [torch.zeros((), dtype=torch.int32, device=x.device) for x in data]
    ex = CardExchange(cards)
    live = [[] for _ in range(D)] if counting() else None
    for s in range(S):
        # every card's s-th sender is bucketed before any copy is issued, so
        # that no card's bucketing is queued behind another's copies into it
        sent = []
        for c in range(D):
            lo = cards.first(c)
            b = bucket_by_destination(data[c][s], dest[c][s], nb, capacity,
                                      valid=None if valid is None else valid[c][s])
            recv[c][:, lo + s] = b.data[lo:lo + S]
            recv_valid[c][:, lo + s] = b.valid[lo:lo + S]
            if positions:
                position[c][s] = b.position
            dropped[c] += b.dropped
            if live is not None:
                live[c].append(b.counts)
            sent.append((b.data, b.valid, b.counts.clamp(max=capacity) * width
                         if D > 1 and counting() else None))
            del b
        for c in range(D if D > 1 else 0):
            _send_buckets(ex, c, cards.first(c) + s, *sent[c], recv, recv_valid)
        del sent
    for c in range(D) if live is not None else ():
        counts = torch.stack(live[c]).sum()
        count("rows", dest[c].numel())
        count("live", counts)
        count("kept", counts - dropped[c])
        count("slots", S * nb * capacity)
    ex.arrive()
    return ExchangeResult(recv, recv_valid, position, cards_sum(dropped))


def _send_buckets(ex: CardExchange, c: int, g: int, data: torch.Tensor, valid: torch.Tensor,
                  kept, recv: List[torch.Tensor], recv_valid: List[torch.Tensor]) -> None:
    """Sender g's buckets (on card c) for the receivers on other cards, each
    copied into its slot range there; `kept`: each bucket's live bytes."""
    S = ex.cards.per_card
    with ex.send(c):
        for r in range(ex.cards.nb):
            d = r // S
            if d != c:
                ex.copy(recv[d][r - d * S, g], data[r], c, d, None if kept is None else kept[r])
                ex.copy(recv_valid[d][r - d * S, g], valid[r], c, d, 0)


def return_all_to_all(results: torch.Tensor, position: torch.Tensor, *, fill=0) -> torch.Tensor:
    """Return trip: `results` [receiver, sender, cap, ...] go back to their
    senders and are scattered to the original record order ([nb, N, ...])."""
    back = results.transpose(0, 1)
    return torch.stack([unbucket(back[s], position[s], fill=fill)
                        for s in range(results.shape[0])])


def ring_shift(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Shard i receives the block of shard (i + shift) mod nb."""
    return torch.roll(x, -shift, dims=0)


def merge_two_sorted(a: torch.Tensor, b: torch.Tensor, a_payload=None, b_payload=None):
    """Merge two sorted arrays by searchsorted ranks (ties: a before b)."""
    na, nb_ = a.shape[0], b.shape[0]
    dev = a.device
    pos_a = torch.arange(na, device=dev) + torch.searchsorted(b, a, side="left")
    pos_b = torch.arange(nb_, device=dev) + torch.searchsorted(a, b, side="right")
    out = torch.empty(na + nb_, dtype=a.dtype, device=dev)
    out[pos_a] = a
    out[pos_b] = b
    if a_payload is None:
        return out
    pay = torch.empty((na + nb_,) + tuple(a_payload.shape[1:]), dtype=a_payload.dtype, device=dev)
    pay[pos_a] = a_payload
    pay[pos_b] = b_payload
    return out, pay


def merge_sorted_runs(keys: torch.Tensor, payload: Optional[torch.Tensor] = None):
    """K-way merge of k sorted runs [k, run] in log2(k) pairwise rounds."""
    k = keys.shape[0]
    if k & (k - 1):
        raise ValueError(f"k={k} must be a power of two")
    while k > 1:
        pairs = [merge_two_sorted(keys[2 * i], keys[2 * i + 1],
                                  None if payload is None else payload[2 * i],
                                  None if payload is None else payload[2 * i + 1])
                 for i in range(k // 2)]
        if payload is None:
            keys = torch.stack(pairs)
        else:
            keys = torch.stack([p[0] for p in pairs])
            payload = torch.stack([p[1] for p in pairs])
        del pairs
        k //= 2
    if payload is None:
        return keys[0]
    return keys[0], payload[0]
