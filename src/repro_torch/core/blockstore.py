"""BlockStore — the storage layer of the disk tier (paper §III-A's external
edgelist ADT, generalized; twin of `repro.core.blockstore`, with
partition_runs' per-run counts and order and MonotoneLookup's pv gather on a
device through `core/chunks.py`).

Every phase of the out-of-core pipeline (external.py) used to hand-roll its
own run management; this module centralizes the four primitives they all
reduce to, each with *bounded* main memory and ledger-accounted I/O:

  BlockStore           a directory of immutable, typed, multi-column runs
                       (append / stream / manifest / destroy).  A "run" is
                       one .npy file of shape [rows, ncols]; rows per run are
                       capped by the writer (cfg.chunk_edges), which is what
                       bounds memory everywhere downstream.
  sort_runs            pass 1 of external merge sort: sort each run in RAM
                       (<= chunk rows at a time), rewrite (paper Alg. 7 l.1-5).
  merge_runs           pass 2: streaming k-way merge over *block-buffered*
                       cursors — resident memory is fan-in x merge block,
                       never a whole store (the paper's bounded-buffer merge).
                       With max_fanin set, stores with more runs than the
                       fan-in budget cascade through log-depth intermediate
                       merge passes (STXXL-style multiway merge), so open
                       files and heap size are bounded at ANY store size.
  partition_runs       bounded-memory bucket partition: stream runs, stable
                       sort each chunk by destination bucket, append slices
                       to per-bucket stores (paper Alg. 8's "append to elp_d,
                       ship when full" — the bucket exchange used by both the
                       external shuffle and redistribute).

  PrefetchReader /     the asynchronous I/O layer (GraphConfig.io_overlap):
  WriteBehindWriter    the paper's dedicated-I/O-thread model.  All four
                       primitives above accept `overlap=True`, which
                       double-buffers reads (next block fetched on an I/O
                       thread while the current one is consumed) and
                       completes appends/Transport sends off-thread with at
                       most one chunk in flight — a pass then costs
                       ~max(read, compute, write) instead of their sum.
                       Timing-only by construction: merges are stable and
                       the single FIFO writer preserves append order, so
                       output bytes are identical with overlap on or off;
                       I/O-thread errors rethrow at the consuming call
                       site; residency at most DOUBLES (gauge-tracked).

IOLedger counts block-granular sequential vs random transfers (the paper's
cost unit, C_e edges per block) plus the overlap stall counters
read_wait_s / write_wait_s / overlap_s; MemoryGauge records the largest
buffer the disk tier ever materializes — including in-flight prefetch and
write-behind buffers — so tests can *assert* the bounded-memory claim
instead of trusting it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import json
import os
import queue
import re
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .chunks import gather_chunk, partition_chunk, table_block
from .trace import STALL_MIN_S, get_tracer

KeySpec = Union[int, Callable[..., np.ndarray]]


def clean_store(workdir: str, name: str) -> None:
    """Remove a store directory (pre-barrier cleanup of multi-writer
    exchange stores; see BlockStore `fresh`)."""
    shutil.rmtree(os.path.join(workdir, name), ignore_errors=True)


def stack_columns(cols: Sequence[np.ndarray], columns: Sequence[str],
                  dtype) -> np.ndarray:
    """THE place record columns become a run array — shared by
    BlockStore.append_run and the socket transport's frame encoder
    (transport._SocketChannel), so both exchange backends stack and coerce
    identically: any future change here changes both, preserving the
    bit-identity contract between them."""
    assert len(cols) == len(columns), (len(cols), columns)
    return np.stack([np.asarray(c, np.dtype(dtype)) for c in cols], axis=1)


def auto_run_tag(seq: int) -> str:
    """Default (single-writer) run naming, shared for the same reason."""
    return f"{seq:06d}"


# Flattened-counter key format: dict-valued ledger fields serialize as
# "field[index]" so every ledger ever becomes (and merges from) a flat
# {str: int} — reports, checkpoints, and BENCH json stay schema-free.
_COUNTER_KEY_RE = re.compile(r"^([a-z_]+)\[(\d+)\]$")


def split_counter_key(key: str) -> Tuple[str, Optional[int]]:
    """Parse a flattened ledger key: "bucket_bytes[3]" -> ("bucket_bytes", 3),
    plain "bytes_read" -> ("bytes_read", None)."""
    m = _COUNTER_KEY_RE.match(key)
    if m:
        return m.group(1), int(m.group(2))
    return key, None


@dataclasses.dataclass
class IOLedger:
    """Counts block-granular I/O, the paper's unit of cost (C_e edges/block)."""

    seq_reads: int = 0
    seq_writes: int = 0
    rand_reads: int = 0
    rand_writes: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    # Per-element hash evaluations (the recompute-shuffle cost unit: what the
    # communication-free relabel pays INSTEAD of exchange bytes — Funke et
    # al.'s trade, made visible next to the byte counters it displaces).
    hash_evals: int = 0
    # Rows appended to stores (writer-side: BlockStore.append_run;
    # receiver-side: the exchange server's durable frame writes).  The row
    # twin of bytes_written — the skew signal in row units.
    rows_written: int = 0
    # Per-bucket skew signal: bytes/rows attributable to a specific bucket,
    # from kernel attribution (phases._run_kernel) and receive-side store
    # naming (transport.ExchangeServer).  The rebalancer's load input and the
    # BENCH_*.json skew surface share these counters.
    bucket_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    bucket_rows: Dict[int, int] = dataclasses.field(default_factory=dict)
    # Overlap stall counters (seconds), fed by the async I/O layer
    # (PrefetchReader / WriteBehindWriter): read_wait_s is consumer time
    # blocked on a prefetched block (the read side failed to hide behind
    # compute), write_wait_s is producer time blocked on the in-flight
    # write slot, and overlap_s is I/O-thread time that DID hide behind
    # compute — the measured win.  Serial paths leave all three at 0.
    read_wait_s: float = 0.0
    write_wait_s: float = 0.0
    overlap_s: float = 0.0

    # Counter updates arrive from the consuming thread AND the async I/O
    # threads concurrently (`+=` is not atomic), so every mutator below
    # takes a lock.  The lock is deliberately NOT a dataclass field:
    # as_dict()/fields() never see it, and pickling drops/rebuilds it.
    def __post_init__(self):
        self._lock = threading.Lock()

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def hashes(self, count: int):
        with self._lock:
            self.hash_evals += count

    def read(self, nbytes: int, sequential: bool = True):
        with self._lock:
            self.bytes_read += nbytes
            if sequential:
                self.seq_reads += 1
            else:
                self.rand_reads += 1

    def write(self, nbytes: int, sequential: bool = True):
        with self._lock:
            self.bytes_written += nbytes
            if sequential:
                self.seq_writes += 1
            else:
                self.rand_writes += 1

    def wrote_rows(self, rows: int) -> None:
        """Writer-side row accounting (append_run + the exchange server's
        durable frame writes) — locked because write-behind appends land on
        the I/O thread while the consumer charges reads."""
        with self._lock:
            self.rows_written += int(rows)

    def stall(self, read_wait_s: float = 0.0, write_wait_s: float = 0.0,
              overlap_s: float = 0.0) -> None:
        """Charge overlap stall/win time (seconds; see the field comments)."""
        with self._lock:
            self.read_wait_s += read_wait_s
            self.write_wait_s += write_wait_s
            self.overlap_s += overlap_s

    def bucket(self, bucket: int, nbytes: int, rows: int = 0) -> None:
        """Attribute I/O to a bucket (the per-bucket skew counters)."""
        b = int(bucket)
        with self._lock:
            if nbytes:
                self.bucket_bytes[b] = self.bucket_bytes.get(b, 0) + int(nbytes)
            if rows:
                self.bucket_rows[b] = self.bucket_rows.get(b, 0) + int(rows)

    def as_dict(self) -> Dict[str, float]:
        """Flat {str: number}: dict-valued fields flatten to "field[index]"
        keys (see split_counter_key), so snapshot/delta/merge/JSON all keep
        working on one flat namespace.  Integer counters stay ints; the
        stall counters are float seconds.  Taken under the lock so a
        snapshot read concurrently with I/O-thread charges is consistent."""
        out: Dict[str, float] = {}
        with self._lock:
            for f in dataclasses.fields(self):
                v = getattr(self, f.name)
                if isinstance(v, dict):
                    for idx in sorted(v):
                        out[f"{f.name}[{int(idx)}]"] = int(v[idx])
                else:
                    out[f.name] = v
        return out

    def merge(self, counters: Dict[str, int]) -> None:
        """Add a flat counter dict (another ledger's as_dict / a report's
        delta) into this ledger — the one sanctioned way to combine
        ledgers, replacing ad-hoc per-field setattr loops.  Unknown keys
        are ignored so old reports merge into newer ledgers.  Float-valued
        counters (the stall seconds) add exactly like the int ones."""
        with self._lock:
            for k, v in counters.items():
                name, idx = split_counter_key(k)
                if idx is not None:
                    d = getattr(self, name, None)
                    if isinstance(d, dict):
                        d[idx] = d.get(idx, 0) + int(v)
                elif hasattr(self, name) and not isinstance(getattr(self, name), dict):
                    setattr(self, name, getattr(self, name) + v)

    def snapshot(self) -> Dict[str, int]:
        return self.as_dict()

    def delta_since(self, snap: Dict[str, int]) -> Dict[str, int]:
        """Per-phase accounting: ledger counters accumulated since `snap`."""
        return {k: v - snap.get(k, 0) for k, v in self.as_dict().items()}


@dataclasses.dataclass
class MemoryGauge:
    """High-water mark of rows materialized in RAM by the disk tier.

    Every point where store code turns disk bytes into a resident ndarray
    reports its row count here; `peak_rows` is the largest single working set
    observed.  Tests cap `chunk_edges` far below n and assert
    peak_rows = O(chunk_edges) — the measurable form of the paper's "main
    memory usage is independent of graph size".

    `budget_rows` is the disk tier's row budget (the writer chunk bound,
    cfg.chunk_edges) where the driver knows it; 0 = unknown.  Merge cursors
    derive their refill block size from budget / fan-in (`cursor_rows`), so
    deep cascades cannot exceed the budget even when prefetch doubles
    residency — overlapped working sets stay <= 2x the serial chunk bound,
    never more.
    """

    peak_rows: int = 0
    budget_rows: int = 0

    # Overlap means the I/O thread and the consumer report buffers
    # concurrently; the max update is read-modify-write, so it is locked.
    # Like IOLedger's, the lock is not a field and never pickles.
    def __post_init__(self):
        self._lock = threading.Lock()

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def track(self, rows: int) -> None:
        with self._lock:
            if rows > self.peak_rows:
                self.peak_rows = int(rows)

    def cursor_rows(self, fan: int, max_run: int, overlap: bool = False) -> int:
        """Refill block size for a fan-in-`fan` merge cursor: an even split
        of the largest run across the cursors, capped by budget_rows / fan
        so the TOTAL cursor residency never exceeds the budget — halved
        again under overlap, where each cursor holds its current block plus
        one prefetched block in flight.  Block size is timing-only: merges
        are stable, so any positive value yields identical output bytes."""
        brows = max(1, int(max_run) // max(1, int(fan)))
        if self.budget_rows > 0:
            cap = self.budget_rows // max(1, int(fan))
            if overlap:
                cap //= 2
            brows = min(brows, max(1, cap))
        return brows


class BlockStore:
    """A directory of immutable typed runs of column-oriented records.

    Append-only (the paper's edgelist ADT never deletes individual records);
    each run is one .npy of shape [rows, ncols].  Reading a run charges the
    ledger; writers bound run size, so every read is a bounded buffer.
    """

    def __init__(
        self,
        workdir: str,
        name: str,
        ledger: IOLedger,
        columns: Sequence[str] = ("src", "dst"),
        dtype=np.int64,
        gauge: Optional[MemoryGauge] = None,
        fresh: bool = False,
    ):
        # `fresh=True` wipes leftovers from a previous (crashed/invalidated)
        # run — required for single-writer stores because attach() recovers
        # runs from the filesystem and stale files would be indistinguishable
        # from real ones.  Multi-writer exchange stores must NOT use it (the
        # writers would wipe each other); their driver calls clean_store()
        # once before the barrier instead.
        self.dir = os.path.join(workdir, name)
        if fresh:
            shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir, exist_ok=True)
        self.name = name
        self.columns = tuple(columns)
        self.dtype = np.dtype(dtype)
        self.ledger = ledger
        self.gauge = gauge if gauge is not None else MemoryGauge()
        self._runs: List[str] = []
        self._rows: List[int] = []

    # -- write side ---------------------------------------------------------
    def append_run(self, *cols: np.ndarray, tag: Optional[str] = None) -> int:
        """Append one immutable run.  `tag` overrides the default sequence
        name — the multi-process mode uses `{sender}_{seq}` tags so that
        runs written concurrently by different workers never collide and
        `attach()` recovers them in sender order (lexicographic)."""
        arr = stack_columns(cols, self.columns, self.dtype)
        name = tag if tag is not None else auto_run_tag(len(self._runs))
        path = os.path.join(self.dir, f"run_{name}.npy")
        np.save(path, arr)
        self.ledger.write(arr.nbytes)
        self.ledger.wrote_rows(arr.shape[0])
        self.gauge.track(arr.shape[0])
        self._runs.append(path)
        self._rows.append(int(arr.shape[0]))
        return len(self._runs) - 1

    @classmethod
    def attach(
        cls,
        workdir: str,
        name: str,
        ledger: IOLedger,
        columns: Sequence[str] = ("src", "dst"),
        dtype=np.int64,
        gauge: Optional[MemoryGauge] = None,
    ) -> "BlockStore":
        """Open a store directory written by another process: run files are
        recovered in lexicographic (== append/tag) order.  The filesystem IS
        the manifest — this is the barrier-free handoff the partitioned mode
        uses between phases."""
        store = cls(workdir, name, ledger, columns=columns, dtype=dtype, gauge=gauge)
        names = sorted(f for f in os.listdir(store.dir) if f.startswith("run_") and f.endswith(".npy"))
        store._runs = [os.path.join(store.dir, f) for f in names]
        store._rows = [int(np.load(p, mmap_mode="r").shape[0]) for p in store._runs]
        return store

    # -- read side ------------------------------------------------------------
    @property
    def ncols(self) -> int:
        return len(self.columns)

    @property
    def num_runs(self) -> int:
        return len(self._runs)

    def run_rows(self, i: int) -> int:
        return self._rows[i]

    def total_rows(self) -> int:
        return sum(self._rows)

    def read_run(self, i: int, sequential: bool = True) -> Tuple[np.ndarray, ...]:
        """Load one WHOLE run resident (mmap_mode=None) — ledger-charged and
        gauge-tracked like any other materialization.  Only for consumers
        that genuinely need the full run at once (per-run stable sorts:
        sort_runs, partition_runs); block-sized consumers must stream
        through iter_blocks instead of paying a whole-run buffer."""
        arr = np.load(self._runs[i], mmap_mode=None)
        self.ledger.read(arr.nbytes, sequential)
        self.gauge.track(arr.shape[0])
        return tuple(arr[:, c] for c in range(arr.shape[1]))

    def open_run(self, i: int) -> np.ndarray:
        """Memmap a run WITHOUT charging the ledger — callers that stream
        blocks out of it charge per block (merge_runs)."""
        return np.load(self._runs[i], mmap_mode="r")

    def iter_runs(self) -> Iterator[Tuple[np.ndarray, ...]]:
        for i in range(self.num_runs):
            yield self.read_run(i)

    def iter_blocks(self, block_rows: int,
                    sequential: bool = True) -> Iterator[Tuple[np.ndarray, ...]]:
        """Stream the whole store in buffers of <= block_rows (run order).
        `sequential` classifies the reads in the ledger — a consumer that
        probes the stream non-contiguously (see MonotoneLookup) can account
        its loads honestly instead of defaulting everything to sequential."""
        for i in range(self.num_runs):
            mm = self.open_run(i)
            for lo in range(0, mm.shape[0], block_rows):
                blk = np.asarray(mm[lo : lo + block_rows])
                self.ledger.read(blk.nbytes, sequential)
                self.gauge.track(blk.shape[0])
                yield tuple(blk[:, c] for c in range(blk.shape[1]))

    def missing_runs(self) -> List[str]:
        """Run files this store's manifest names but the filesystem lacks —
        nonempty after checkpoint GC reclaimed them (drivers check this
        before rerunning a non-checkpointable phase against old outputs)."""
        return [p for p in self._runs if not os.path.exists(p)]

    # -- lifecycle --------------------------------------------------------------
    def destroy(self):
        shutil.rmtree(self.dir, ignore_errors=True)
        self._runs, self._rows = [], []

    # -- checkpoint manifests ----------------------------------------------------
    def manifest(self) -> Dict:
        """Workdir-relative description of this store (no absolute paths, so
        a checkpointed workdir can be moved/re-mounted and still resume)."""
        return {
            "name": self.name,
            "columns": list(self.columns),
            "dtype": self.dtype.str,
            "runs": [os.path.basename(p) for p in self._runs],
            "rows": list(self._rows),
        }

    @classmethod
    def from_manifest(
        cls, m: Dict, workdir: str, ledger: IOLedger,
        gauge: Optional[MemoryGauge] = None,
    ) -> "BlockStore":
        store = cls.__new__(cls)
        BlockStore.__init__(
            store,
            workdir,
            m["name"],
            ledger,
            columns=m["columns"],
            dtype=np.dtype(m["dtype"]),
            gauge=gauge,
        )
        store._runs = [os.path.join(store.dir, r) for r in m["runs"]]
        store._rows = list(m["rows"])
        return store

    def save_manifest(self, path: str):
        with open(path, "w") as f:
            json.dump(self.manifest(), f)


def _keys_of(key: KeySpec, cols: Tuple[np.ndarray, ...]) -> np.ndarray:
    """Resolve a key spec: column index, or callable over the columns.

    Callable keys are *recomputed* from record values instead of stored —
    that is what lets the external shuffle sort by hash(value, salt) without
    a key column on disk (the paper's counter-based determinism, applied to
    the sort key itself)."""
    if callable(key):
        return np.asarray(key(*cols))
    return np.asarray(cols[key])


def sort_runs(store: BlockStore, out: BlockStore, key: KeySpec = 0,
              overlap: bool = False) -> BlockStore:
    """External-sort pass 1: each run sorted in RAM by `key`, rewritten.

    Runs are writer-bounded (<= chunk rows), so resident memory is one run
    — with `overlap`, run i+1 is prefetched and run i-1's sorted output
    written behind while run i sorts, so resident memory is <= 2 runs and
    wall time tends to max(read, sort, write) instead of their sum.  Output
    is byte-identical either way: the single FIFO writer preserves append
    order, and sorting is per-run."""
    row_bytes = store.ncols * store.dtype.itemsize
    prefetch = overlap and store.num_runs > 0 and (
        max(store.run_rows(i) for i in range(store.num_runs)) * row_bytes
        >= _ASYNC_IO_MIN_BYTES)
    runs: Iterator[Tuple[np.ndarray, ...]] = store.iter_runs()
    if prefetch:
        runs = PrefetchReader(runs, ledger=store.ledger)
    tracer = get_tracer()
    t_wall, p0 = time.time(), time.perf_counter()
    try:
        with write_behind([out], store.ledger, store.gauge,
                          enabled=overlap) as sinks:
            for cols in runs:
                if prefetch:
                    store.gauge.track(2 * cols[0].shape[0])
                order = np.argsort(_keys_of(key, cols), kind="stable")
                sinks[0].append_run(*(c[order] for c in cols))
    finally:
        if isinstance(runs, PrefetchReader):
            runs.close()
        if tracer.enabled:
            tracer.event(f"sort:{store.name}", "io", t_wall,
                         time.perf_counter() - p0,
                         args={"runs": store.num_runs})
    return out


# ---------------------------------------------------------------------------
# Asynchronous I/O layer (io_overlap): double-buffered prefetch + write-behind
# ---------------------------------------------------------------------------

_DONE = object()  # PrefetchReader's end-of-stream sentinel


class PrefetchReader:
    """Double-buffered background reader — the paper's dedicated I/O thread
    (read half): disk transfers overlap compute instead of alternating with
    it, so a pass costs max(read, compute) instead of read + compute.

    Wraps any block iterator so the NEXT item is produced on an I/O thread
    while the consumer works on the current one.  Exactly ONE item is ever
    in flight (the consumer's current block + one prefetched block = the
    depth-2 double buffer), so resident memory is at most 2x the serial
    bound, never more — callers report the doubled aggregate to their gauge.

    Stall accounting (`ledger`): consumer time blocked on the pending item
    is charged to `read_wait_s`; producer time hidden behind compute to
    `overlap_s`.  Exceptions raised by the wrapped iterator ON THE I/O
    THREAD are captured by the future and rethrown HERE, at the consuming
    call site (`__next__`), so error propagation, checkpoint/resume and
    mid-phase-kill semantics are identical to the serial path.

    `executor` shares one single-worker executor across several readers —
    a k-way merge's cursors all refill through ONE I/O thread (the paper's
    one-I/O-thread-per-node model), each keeping one outstanding refill.
    Without it the reader owns a private single-worker executor.  Exhaust
    the iterator or call close(); abandoning a reader mid-stream without
    close() leaks its in-flight future until the executor drains it.
    """

    def __init__(self, it: Iterator, ledger: Optional[IOLedger] = None,
                 executor: Optional[ThreadPoolExecutor] = None):
        self._it = iter(it)
        self._ledger = ledger
        self._own = executor is None
        self._ex = executor if executor is not None else ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="io_prefetch")
        self._fut = self._ex.submit(self._pull)

    def _pull(self):
        t0 = time.perf_counter()
        item = next(self._it, _DONE)
        return item, time.perf_counter() - t0

    def __iter__(self):
        return self

    def __next__(self):
        if self._fut is None:
            raise StopIteration
        t0 = time.perf_counter()
        item, produce_s = self._fut.result()  # I/O-thread errors rethrow here
        wait_s = time.perf_counter() - t0
        if self._ledger is not None:
            self._ledger.stall(read_wait_s=wait_s,
                               overlap_s=max(0.0, produce_s - wait_s))
        if wait_s > STALL_MIN_S:
            # A span only for stalls worth seeing on a timeline; sub-ms
            # waits stay counter-only (the ledger above never misses them).
            tracer = get_tracer()
            if tracer.enabled:
                tracer.event("read_stall", "stall", time.time() - wait_s,
                             wait_s)
        if item is _DONE:
            self._fut = None
            if self._own:
                self._ex.shutdown(wait=False)
            raise StopIteration
        self._fut = self._ex.submit(self._pull)
        return item

    def close(self) -> None:
        """Stop prefetching (early-exit consumers): cancel or drain the
        in-flight pull, swallowing its result/error — the stream is being
        abandoned, there is no consuming call site left to rethrow at."""
        fut, self._fut = self._fut, None
        if fut is not None and not fut.cancel():
            try:
                fut.result()
            except BaseException:
                pass
        if self._own:
            self._ex.shutdown(wait=True)


class WriteBehindWriter:
    """Write-behind sink multiplexer — the paper's dedicated I/O thread
    (write half): `append_run` emission and Transport channel sends complete
    off-thread with AT MOST ONE chunk in flight, so emitters pay
    max(compute, write) per chunk instead of compute + write.

    Wraps an ordered list of run sinks (BlockStores, or Transport channels —
    anything with BlockStore's `append_run(*cols, tag=)` signature); `sink(d)`
    returns a proxy whose `append_run` enqueues (d, cols, tag) on a bounded
    queue (maxsize=1) drained by ONE writer thread.  A single FIFO queue and
    a single thread preserve the exact serial append order across ALL sinks
    — and therefore run tags and receivers' lexicographic recovery order —
    which is why write-behind can never change result bytes.  In-flight
    residency is <= 1 queued + 1 being-written chunk; the doubled aggregate
    is reported to `gauge` per enqueue.  Enqueued column arrays must not be
    mutated afterwards (every call site emits fresh arrays).

    Producer time blocked on the full queue is charged to `write_wait_s`;
    writer-thread time hidden behind compute to `overlap_s` (on close).
    Errors raised by a sink ON THE WRITER THREAD are captured and rethrown
    at the producer's next append_run/flush/close — the consuming call
    site — and once one append fails no later chunk is written (fail-stop,
    so a checkpointed phase can never be marked complete past a lost write).
    Call flush()/close() (or use the context manager / `write_behind`)
    before relying on the sinks' contents.
    """

    def __init__(self, sinks: Sequence, ledger: Optional[IOLedger] = None,
                 gauge: Optional[MemoryGauge] = None):
        self._sinks = list(sinks)
        self._ledger = ledger
        self._gauge = gauge
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._write_s = 0.0   # writer-thread time (accumulated there)
        self._wait_s = 0.0    # producer time blocked on the queue
        self._thread: Optional[threading.Thread] = threading.Thread(
            target=self._drain, name="io_writebehind", daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                d, cols, tag = item
                if self._err is None:
                    t0 = time.perf_counter()
                    try:
                        self._sinks[d].append_run(*cols, tag=tag)
                    except BaseException as e:  # rethrown at the producer
                        self._err = e
                    self._write_s += time.perf_counter() - t0
            finally:
                self._q.task_done()

    def sink(self, d: int) -> "_WriteBehindSink":
        """The async proxy for `sinks[d]` (same append_run signature)."""
        return _WriteBehindSink(self, d)

    def _put(self, d: int, cols: Tuple[np.ndarray, ...],
             tag: Optional[str]) -> None:
        if self._err is not None:
            self.abort()
            raise self._err
        if sum(int(np.asarray(c).nbytes) for c in cols) < _ASYNC_IO_MIN_BYTES:
            # Tiny chunk: the queue wake + GIL ping-pong costs more than
            # the write itself.  Drain anything in flight first (FIFO
            # order, hence bit-identity, is preserved), then append inline
            # on the producer — errors surface here, the consuming site.
            self._q.join()
            if self._err is not None:
                self.abort()
                raise self._err
            self._sinks[d].append_run(*cols, tag=tag)
            return
        if self._gauge is not None and cols:
            # current chunk + one in flight: the <= 2x residency bound.
            self._gauge.track(2 * int(np.asarray(cols[0]).shape[0]))
        t0 = time.perf_counter()
        self._q.put((d, cols, tag))
        self._wait_s += time.perf_counter() - t0

    def flush(self) -> None:
        """Barrier: every enqueued chunk is durably appended on return;
        rethrows any writer-thread error at this (consuming) call site."""
        self._q.join()
        if self._err is not None:
            self.abort()
            raise self._err

    def close(self) -> None:
        """flush() + stop the writer thread + charge the stall counters."""
        if self._thread is None:
            return
        self._q.put(None)
        self._thread.join()
        self._thread = None
        if self._ledger is not None:
            self._ledger.stall(write_wait_s=self._wait_s,
                               overlap_s=max(0.0, self._write_s - self._wait_s))
        if self._wait_s > STALL_MIN_S:
            tracer = get_tracer()
            if tracer.enabled:
                # One aggregate span per writer lifetime (per-put spans
                # would swamp the buffer); anchored so it ENDS at close.
                tracer.event("write_stall", "stall",
                             time.time() - self._wait_s, self._wait_s)
        if self._err is not None:
            raise self._err

    def abort(self) -> None:
        """Stop the writer WITHOUT rethrowing (error-path teardown: the
        producer is already unwinding and must not be masked)."""
        if self._thread is None:
            return
        self._q.put(None)
        self._thread.join()
        self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()


class _WriteBehindSink:
    """Per-destination proxy view: the same `append_run(*cols, tag=)` shape
    call sites already use, so partition/merge emit loops are overlap-
    agnostic.  Returns None (run indices are writer-thread state; no current
    emitter consumes append_run's return value)."""

    __slots__ = ("_w", "_d")

    def __init__(self, w: WriteBehindWriter, d: int):
        self._w, self._d = w, d

    def append_run(self, *cols: np.ndarray, tag: Optional[str] = None) -> None:
        self._w._put(self._d, cols, tag)


@contextlib.contextmanager
def write_behind(sinks: Sequence, ledger: Optional[IOLedger],
                 gauge: Optional[MemoryGauge], enabled: bool = True):
    """Scoped write-behind over `sinks`: yields proxy sinks (or the
    originals when disabled — one code path for overlap on/off), and on
    clean exit flushes the writer, rethrowing any I/O-thread error inside
    the caller's scope.  On an exception the writer is torn down without
    masking the original error."""
    if not enabled:
        yield list(sinks)
        return
    wb = WriteBehindWriter(sinks, ledger=ledger, gauge=gauge)
    try:
        yield [wb.sink(d) for d in range(len(sinks))]
    except BaseException:
        wb.abort()
        raise
    else:
        wb.close()


# Routing one buffer through an I/O thread costs tens of µs of
# queue/future handoff plus GIL ping-pong with the consumer.  Async I/O
# only pays once a buffer's transfer time dwarfs that, so transfers below
# this byte floor (fine-grained budgets, huge fan-ins, toy scales) run
# synchronously even under io_overlap: merge cursors refill inline
# (_cursor_plan), sort_runs skips run prefetch, and WriteBehindWriter
# appends tiny chunks on the producer (after draining anything in flight,
# so FIFO order — and therefore bit-identity — is preserved).  Timing-only
# either way; output bytes never depend on the floor, and the
# halved-budget block size only applies when a second block is actually
# in flight.
_ASYNC_IO_MIN_BYTES = 1 << 16


def _cursor_plan(gauge: MemoryGauge, fan: int, max_run: int, row_bytes: int,
                 block_rows: int, overlap: bool) -> Tuple[int, bool]:
    """(refill block rows, prefetch on?) for one merge's cursors.  Explicit
    block_rows is respected unchanged; otherwise the gauge budget splits
    across the fan-in (MemoryGauge.cursor_rows), halved only when prefetch
    actually engages — which it does only above _PREFETCH_MIN_BYTES."""
    brows = (block_rows if block_rows > 0
             else gauge.cursor_rows(fan, max_run, overlap=False))
    prefetch = overlap and brows * row_bytes >= _ASYNC_IO_MIN_BYTES
    if prefetch and block_rows <= 0:
        brows = gauge.cursor_rows(fan, max_run, overlap=True)
    return brows, prefetch


@contextlib.contextmanager
def _merge_io(overlap: bool):
    """The shared I/O thread of ONE merge (None when overlap is off): a
    single-worker executor serves every cursor's refills — the paper's
    dedicated-I/O-thread-per-node model — with one outstanding prefetch per
    cursor, so in-flight blocks never exceed one extra block per cursor
    (the <= 2x residency bound the gauge records)."""
    if not overlap:
        yield None
        return
    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="io_merge")
    try:
        yield ex
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def _segment_blocks(store: BlockStore, runs: Sequence[int],
                    block_rows: int) -> Iterator[np.ndarray]:
    """Raw block producer of one sorted segment: run files streamed back to
    back in <= block_rows slices.  At most ONE memmap is held open at a time
    (the previous run's reference is dropped as soon as it drains — the
    open-file bound of the bounded-fan-in merge).  Ledger charges happen
    here, i.e. on the I/O thread when prefetched (IOLedger is locked)."""
    for ri in runs:
        mm = store.open_run(ri)
        for off in range(0, mm.shape[0], block_rows):
            blk = np.asarray(mm[off : off + block_rows])
            store.ledger.read(blk.nbytes)
            yield blk
        mm = None


class _MergeCursor:
    """Block-buffered read cursor over one sorted *segment*: an ordered list
    of run files of a single store that together form one globally sorted
    sequence — a plain run, or a cascade intermediate store's runs back to
    back (merge_runs helper).  Refills come from _segment_blocks, optionally
    prefetched on the merge's shared I/O thread (`prefetch`, io_overlap):
    the NEXT block reads from disk while the heap drains the current one.
    """

    __slots__ = ("store", "key", "block_rows", "runs", "_blocks",
                 "block_keys", "block_cols", "_rel", "_done")

    def __init__(self, store: BlockStore, runs: Sequence[int], key: KeySpec,
                 block_rows: int,
                 prefetch: Optional[ThreadPoolExecutor] = None):
        self.store = store
        self.key = key
        self.block_rows = max(1, int(block_rows))
        self.runs = [r for r in runs if store.run_rows(r) > 0]
        blocks = _segment_blocks(store, self.runs, self.block_rows)
        self._blocks: Iterator[np.ndarray] = (
            blocks if prefetch is None
            else PrefetchReader(blocks, ledger=store.ledger, executor=prefetch))
        self.block_keys: Optional[np.ndarray] = None
        self.block_cols: Optional[Tuple[np.ndarray, ...]] = None
        self._rel = 0
        self._done = False
        self._advance()

    def _advance(self):
        """Consume the next block (keys are computed HERE, on the consumer
        thread — the I/O thread only moves bytes).  A prefetch-thread read
        error rethrows out of next(), i.e. at this consuming call site."""
        blk = next(self._blocks, None)
        if blk is None:
            self._done = True
            self.block_keys = self.block_cols = None
            return
        self.block_cols = tuple(blk[:, c] for c in range(blk.shape[1]))
        self.block_keys = _keys_of(self.key, self.block_cols)
        self._rel = 0
        return

    def head_key(self) -> int:
        if self._rel >= self.block_keys.shape[0]:
            self._advance()
        # Python int: unbounded, so uint64 hash keys >= 2^63 survive the heap.
        return int(self.block_keys[self._rel])

    def take_below(self, bound: Optional[int],
                   inclusive: bool) -> Optional[Tuple[np.ndarray, ...]]:
        """Pop the maximal prefix of the current block with key <= bound
        (inclusive=True) or key < bound (False — this cursor ranks AFTER the
        bound's cursor, so keys equal to the bound are not yet its turn: the
        strict-stability rule that makes equal-key order independent of merge
        topology).  `bound=None` means "no bound at all" (the final-drain
        sentinel — a max-int bound would under-drain key dtypes with values
        above it, e.g. callable uint64 hash keys >= 2^63).  Returns None
        when the block head already reaches bound."""
        if self._done:
            return None
        if self._rel >= self.block_keys.shape[0]:
            self._advance()
            if self._done:
                return None
        if bound is None:
            end = self.block_keys.shape[0]
        else:
            end = int(np.searchsorted(self.block_keys[self._rel :], bound,
                                      side="right" if inclusive else "left")
                      ) + self._rel
        if end == self._rel:
            return None
        out = tuple(c[self._rel : end] for c in self.block_cols)
        self._rel = end
        return out

    @property
    def exhausted(self) -> bool:
        if self._done:
            return True
        if self._rel < self.block_keys.shape[0]:
            return False
        self._advance()
        return self._done


def _merge_cursors(cursors: List[_MergeCursor], ncols: int,
                   flush_rows: int) -> Iterator[Tuple[np.ndarray, ...]]:
    """STABLE heap merge of sorted segment cursors, ~flush_rows blocks out.

    The winning cursor drains up to the next heap head (key, index) in
    LEXICOGRAPHIC order — keys equal to the bound belong to this cursor only
    if its index ranks first — so equal keys are emitted strictly in cursor
    order.  That stability is what makes the cascaded merge bit-identical to
    the flat one: equal-key order depends only on run order, never on merge
    topology or block sizes.  With an empty heap the bound is None (no
    bound), NOT a max int — see take_below.  Output is flushed inside the
    drain loop so even a final cursor spanning a huge cascade segment never
    accumulates more than ~flush_rows resident rows.
    """
    heap = [(c.head_key(), i) for i, c in enumerate(cursors) if not c.exhausted]
    heapq.heapify(heap)
    out_parts: List[Tuple[np.ndarray, ...]] = []
    out_rows = 0
    while heap:
        _, ci = heapq.heappop(heap)
        cur = cursors[ci]
        bound, inclusive = (heap[0][0], ci < heap[0][1]) if heap else (None, True)
        while True:
            part = cur.take_below(bound, inclusive)
            if part is None:
                break
            out_parts.append(part)
            out_rows += part[0].shape[0]
            if out_rows >= flush_rows:
                yield tuple(np.concatenate([p[c] for p in out_parts])
                            for c in range(ncols))
                out_parts, out_rows = [], 0
            if cur.exhausted:
                break
        if not cur.exhausted:
            heapq.heappush(heap, (cur.head_key(), ci))
    if out_parts:
        yield tuple(np.concatenate([p[c] for p in out_parts]) for c in range(ncols))


def merge_segments(
    segments: Sequence[Tuple[BlockStore, Sequence[int]]], key: KeySpec = 0,
    block_rows: int = 0, overlap: bool = False,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """STABLE streaming merge over pre-built sorted segments.

    A segment is (store, ordered run indices) whose runs form ONE globally
    sorted sequence back to back — a single plain run, or a whole cascade
    intermediate store.  This is merge_runs' inner merge exposed for callers
    that build the segment list themselves: the pooled cascade
    (phases.cascade_merge_bucket) runs each *group* of segments as its own
    pool task, so intermediate merge levels parallelize across workers/hosts
    instead of running serially inside one consumer kernel.  Equal keys
    drain in segment order (see _merge_cursors), so any consecutive grouping
    of segments is bit-identical to the flat merge — the same stability
    contract merge_runs' inline cascade relies on.

    `overlap` refills every cursor through ONE shared I/O thread
    (_merge_io + PrefetchReader) while the heap drains current blocks —
    timing-only, bit-identical output, <= 2x cursor-buffer residency
    (recorded in the gauge; block sizes shrink under a gauge budget so the
    doubled set still fits — MemoryGauge.cursor_rows).
    """
    segs = [(s, [r for r in runs if s.run_rows(r) > 0]) for s, runs in segments]
    segs = [(s, runs) for s, runs in segs if runs]
    if not segs:
        return
    max_run = max(s.run_rows(r) for s, runs in segs for r in runs)
    flush_rows = max(block_rows, max_run)
    fan = len(segs)
    lead = segs[0][0]
    brows, prefetch = _cursor_plan(
        lead.gauge, fan, max_run, lead.ncols * lead.dtype.itemsize,
        block_rows, overlap)
    lead.gauge.track(brows * fan * (2 if prefetch else 1))
    tracer = get_tracer()
    t_wall, p0 = time.time(), time.perf_counter()
    try:
        with _merge_io(prefetch) as ex:
            cursors = [_MergeCursor(s, runs, key, brows, prefetch=ex)
                       for s, runs in segs]
            yield from _merge_cursors(cursors, lead.ncols, flush_rows)
    finally:
        # Generator span: covers first next() to close — what the consumer
        # actually spent inside this merge.  "io" is a leaf category (not
        # under the nesting law): interleaved generators close out of LIFO.
        if tracer.enabled:
            tracer.event(f"merge_seg:{lead.name}", "io", t_wall,
                         time.perf_counter() - p0, args={"segments": fan})


CASCADE_MARKER = "__cas_l"  # substring naming cascade intermediate store dirs


def clean_cascade_stores(workdir: str) -> None:
    """Remove leftover cascade intermediate stores from a crashed merge.
    merge_runs wipes (fresh=True) and destroys its own intermediates; ones
    that survive a crash are dead weight that must never be mistaken for
    phase outputs, so resume paths (PhaseOrchestrator) sweep them first."""
    if not os.path.isdir(workdir):
        return
    for d in os.listdir(workdir):
        if CASCADE_MARKER in d and os.path.isdir(os.path.join(workdir, d)):
            shutil.rmtree(os.path.join(workdir, d), ignore_errors=True)


def merge_runs(
    store: BlockStore, key: KeySpec = 0, block_rows: int = 0,
    max_fanin: int = 0, overlap: bool = False,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """External-sort pass 2: streaming k-way merge of sorted runs, with a
    bounded-fan-in cascade (the STXXL-style log-depth multiway merge).

    Flat path (num_runs <= max_fanin, or max_fanin=0): resident memory is
    fan-in x block_rows rows (cursor buffers) + one output block — never the
    whole store.  block_rows defaults to an even split of the largest run
    across the cursors, so total buffer memory stays ~one run at any fan-in.

    Cascade path (max_fanin >= 2 and num_runs > max_fanin): groups of
    <= max_fanin segments are merged into intermediate stores (sibling dirs
    named `{store.name}__cas_l{level}_g{group}`, ledger- and gauge-accounted
    like any other store), recursing until <= max_fanin segments remain for
    one final streaming merge.  Open run files and heap size are then
    bounded by max_fanin REGARDLESS of store size — per-cursor blocks stay
    max_run/max_fanin instead of shrinking to max_run/num_runs — at the cost
    of O(log_max_fanin(num_runs)) extra sequential read+write passes over
    the data.  A consumed cascade level is destroyed as soon as the next
    level is built (and on generator close), so scratch disk is bounded by
    ~2x the store; output is bit-identical to the flat merge because the
    merge is STABLE (equal keys emit in run order — see _merge_cursors) and
    groups are consecutive runs, so cascading never reorders anything.

    `overlap` runs every level's cursor refills on a shared I/O thread and
    the intermediate stores' appends through a write-behind thread (see
    merge_segments / WriteBehindWriter): each cascade pass costs
    ~max(read, merge, write) instead of their sum.  Timing-only — the
    single FIFO writer preserves run order and the merge is stable, so
    output is bit-identical to the serial path at every fan-in.

    Yields tuples of column arrays in globally sorted order; merge_runs over
    sort_runs output is therefore a stable external sort of the store.
    """
    if max_fanin == 1 or max_fanin < 0:
        raise ValueError(f"max_fanin must be 0 (flat) or >= 2, got {max_fanin}")
    nruns = store.num_runs
    if nruns == 0:
        return
    max_run = max(store.run_rows(i) for i in range(nruns))
    flush_rows = max(block_rows, max_run)
    workdir = os.path.dirname(store.dir)
    # A segment = (store, ordered run indices) forming one sorted sequence.
    segments: List[Tuple[BlockStore, List[int]]] = [
        (store, [i]) for i in range(nruns)]
    scratch: List[BlockStore] = []

    row_bytes = store.ncols * store.dtype.itemsize

    def cursors_of(segs, ex):
        fan = len(segs)
        brows, pf = _cursor_plan(store.gauge, fan, max_run, row_bytes,
                                 block_rows, overlap)
        store.gauge.track(brows * fan * (2 if pf else 1))
        return [_MergeCursor(s, runs, key, brows, prefetch=ex if pf else None)
                for s, runs in segs]

    tracer = get_tracer()
    t_wall, p0 = time.time(), time.perf_counter()
    try:
        level = 0
        while max_fanin >= 2 and len(segments) > max_fanin:
            nxt: List[Tuple[BlockStore, List[int]]] = []
            for g, lo in enumerate(range(0, len(segments), max_fanin)):
                grp = segments[lo : lo + max_fanin]
                out = BlockStore(
                    workdir, f"{store.name}{CASCADE_MARKER}{level}_g{g:04d}",
                    store.ledger, columns=store.columns, dtype=store.dtype,
                    gauge=store.gauge, fresh=True)
                scratch.append(out)
                with _merge_io(overlap) as ex, \
                        write_behind([out], store.ledger, store.gauge,
                                     enabled=overlap) as sinks:
                    for cols in _merge_cursors(cursors_of(grp, ex),
                                               store.ncols, flush_rows):
                        sinks[0].append_run(*cols)
                # This group's input segments are consumed; reclaim the ones
                # that are cascade intermediates (never the caller's store).
                for s, _ in grp:
                    if s is not store:
                        s.destroy()
                nxt.append((out, list(range(out.num_runs))))
            segments = nxt
            level += 1
        with _merge_io(overlap) as ex:
            yield from _merge_cursors(cursors_of(segments, ex), store.ncols,
                                      flush_rows)
    finally:
        for s in scratch:
            s.destroy()
        if tracer.enabled:
            tracer.event(f"merge:{store.name}", "io", t_wall,
                         time.perf_counter() - p0,
                         args={"runs": nruns, "levels": level})


def partition_runs(
    store: BlockStore,
    outs: Sequence,
    part_of: Callable[..., np.ndarray],
    tag_prefix: Optional[str] = None,
    transform: Optional[Callable[..., Tuple[np.ndarray, ...]]] = None,
    overlap: bool = False,
    device="cuda",
) -> Sequence:
    """Bounded-memory bucket partition (paper Alg. 8's bucket exchange).

    Streams `store` one run at a time; each run is stable-sorted by its
    destination bucket and the per-bucket slices appended to `outs[d]` —
    all access sequential, resident memory one run.  `outs` are run sinks
    with BlockStore's `append_run(*cols, tag=)` signature: destination
    stores on a shared filesystem, or transport channels
    (core/transport.py) that frame each emitted run to the destination
    bucket's host — the emit path is transport-agnostic.  `tag_prefix`
    names the written runs `{tag_prefix}_{seq}` so concurrent senders into
    a shared destination inbox never collide (multi-process mode), and so
    receivers recover sender order lexicographically on either backend.
    `transform` rewrites each run's columns before partitioning (same
    column count; `part_of` sees the TRANSFORMED values) — the inline-map
    hook of the recompute relabel: u -> perm(u) applied during the very
    scan that ships each edge to owner(perm(src)).

    `overlap` prefetches the next input run on an I/O thread while the
    current one is transformed/sorted/sliced, and completes every
    append_run — including Transport channel SENDS — through one
    write-behind thread with at most one chunk in flight.  The single FIFO
    writer preserves the exact serial append order across all destinations
    (and therefore the `{tag_prefix}_{seq}` tags), so the exchange bytes
    are bit-identical to the serial path; residency is <= 2 runs in flight
    (tracked in the gauge).

    Each run's destinations are counted and ordered on `device`
    (`chunks.partition_chunk`: the `bucket_hist` kernel and a stable
    argsort); `part_of` gets the columns there as int64 tensors.
    """
    nparts = len(outs)
    seq = [0] * nparts
    runs: Iterator[Tuple[np.ndarray, ...]] = store.iter_runs()
    if overlap:
        runs = PrefetchReader(runs, ledger=store.ledger)
    tracer = get_tracer()
    t_wall, p0 = time.time(), time.perf_counter()
    try:
        with write_behind(outs, store.ledger, store.gauge,
                          enabled=overlap) as sinks:
            for cols in runs:
                if overlap:
                    store.gauge.track(2 * cols[0].shape[0])
                if transform is not None:
                    cols = tuple(transform(*cols))
                cols, counts = partition_chunk(cols, part_of, nparts, device, store.name)
                ends = np.cumsum(counts)
                starts = ends - counts
                for d in range(nparts):
                    if ends[d] > starts[d]:
                        tag = None if tag_prefix is None else f"{tag_prefix}_{seq[d]:05d}"
                        sinks[d].append_run(*(c[starts[d] : ends[d]] for c in cols),
                                            tag=tag)
                        seq[d] += 1
    finally:
        if isinstance(runs, PrefetchReader):
            runs.close()
        if tracer.enabled:
            tracer.event(f"partition:{store.name}", "io", t_wall,
                         time.perf_counter() - p0, args={"parts": nparts})
    return outs


class NpyColumnStore:
    """Read-only, single-column BlockStore look-alike over one flat .npy
    vector (e.g. a bucket's CSR offv file), streamed in ledger-charged,
    gauge-tracked blocks.

    Exists so MonotoneLookup can sort-merge-join against plain array files
    with the SAME I/O accounting as real stores — before this adapter, flat
    .npy tables could only be memmapped directly, and those block loads never
    landed in the IOLedger (breaking the Fig.-2-style sequential-vs-random
    bookkeeping for any phase that joined against them).
    """

    def __init__(self, path: str, ledger: IOLedger,
                 gauge: Optional[MemoryGauge] = None):
        self.path = path
        self.ledger = ledger
        self.gauge = gauge if gauge is not None else MemoryGauge()

    def iter_blocks(self, block_rows: int,
                    sequential: bool = True) -> Iterator[Tuple[np.ndarray]]:
        mm = np.load(self.path, mmap_mode="r")
        for lo in range(0, mm.shape[0], block_rows):
            blk = np.asarray(mm[lo : lo + block_rows], np.int64)
            self.ledger.read(blk.nbytes, sequential)
            self.gauge.track(blk.shape[0])
            yield (blk,)


class MonotoneLookup:
    """Streaming table lookup for sort-merge-joins: `lookup(keys)` returns
    table[keys - base] for a globally NONDECREASING key stream, reading the
    table (a sequence of single-column stores laid out back to back) strictly
    forward, one bounded block at a time.

    This is the paper's Alg. 6-7 join half: both the probe stream (sorted
    edges) and the build stream (pv blocks) advance monotonically, so the
    join is two synchronized sequential scans — no random I/O, resident
    memory one block.  Block loads are charged to the stores' ledger through
    iter_blocks; the output buffer of every `lookup` call is reported to
    `gauge` so the join's working set is auditable too.

    With `device` set, each block also goes to that device as int32 and the
    gather runs there (`chunks.gather_chunk`: the `relabel_gather` kernel);
    the pv joins pass it.  Without, the gather is numpy's: the offv joins of
    the walk hop, whose int64 offsets exceed int32.
    """

    def __init__(self, stores: Sequence[BlockStore], block_rows: int, base: int = 0,
                 gauge: Optional[MemoryGauge] = None, device=None):
        def blocks():
            for s in stores:
                for (vals,) in s.iter_blocks(block_rows):
                    yield vals

        self._blocks = blocks()
        self._g0 = base
        self._vals = np.zeros(0, np.int64)
        self._gauge = gauge
        self._device = device
        self._dev_vals = None

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys)
        if keys.size and np.any(keys[1:] < keys[:-1]):
            i = int(np.argmax(keys[1:] < keys[:-1]))
            raise ValueError(
                f"MonotoneLookup probe stream regressed within a call: "
                f"keys[{i + 1}]={int(keys[i + 1])} < keys[{i}]={int(keys[i])}")
        out = np.empty(keys.shape[0], np.int64)
        if self._gauge is not None:
            self._gauge.track(out.shape[0])
        i = 0
        while i < keys.shape[0]:
            if keys[i] < self._g0:
                # A regressed probe would index _vals with a NEGATIVE offset,
                # wrapping to the wrong table entry instead of erroring.
                raise ValueError(
                    f"MonotoneLookup probe stream regressed: key "
                    f"{int(keys[i])} is below the already-consumed table "
                    f"prefix ending at {self._g0}")
            g1 = self._g0 + self._vals.shape[0]
            if keys[i] >= g1:
                try:
                    nxt = next(self._blocks)
                except StopIteration:
                    raise IndexError(
                        f"key {int(keys[i])} beyond end of lookup table at {g1}"
                    ) from None
                self._g0 = g1
                self._vals = nxt
                self._dev_vals = None
                continue
            hi = int(np.searchsorted(keys, g1, side="left"))
            if self._device is None:
                out[i:hi] = self._vals[keys[i:hi] - self._g0]
            else:
                if self._dev_vals is None:
                    self._dev_vals = table_block(self._vals, self._device)
                out[i:hi] = gather_chunk(keys[i:hi], self._dev_vals, self._g0)
            i = hi
        return out
