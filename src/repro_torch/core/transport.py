"""Transport — the bucket-exchange layer of the disk tier, made pluggable
(twin of `repro.core.transport`).

Every exchange in the pipeline (shuffle slice exchange, relabel scatter,
redistribute, per-hop walk-frontier exchange, history collect) has the same
shape: sender kernels append tagged runs into a *destination bucket's* inbox
store, a bulk-synchronous barrier passes, and the receiver kernel drains the
inbox in lexicographic `{sender}_{seq}` tag order.  Until this module, that
contract was welded to a shared filesystem (senders wrote directly into the
receiver's store directory).  `Transport` lifts it into an interface so the
same bucket kernels run over either backend:

  FilesystemTransport  the reference implementation: `channel()` IS the
                       destination BlockStore, so a send is a local append —
                       today's `{sender}_{seq}` convention, unchanged.  On a
                       shared filesystem every exchanged byte crosses the
                       interconnect twice (sender -> shared store, shared
                       store -> receiver), the cost the socket backend halves.
  SocketTransport      length-prefixed framed TCP with per-connection
                       sequence numbers: a send frames one run (header JSON +
                       raw column-major payload) to the ExchangeServer that
                       owns the destination bucket, which writes it as the
                       same `run_{sender}_{seq}.npy` file the filesystem
                       backend would have produced (`.part` staging + atomic
                       rename before the ack, so an acked run survives any
                       receiver process crash; fsync opt-in for host-crash
                       durability).  Receivers therefore
                       attach *identical* stores — outputs are bit-identical
                       across backends — while the bytes cross the wire once
                       and workers can live on different hosts.

Memory discipline: a frame carries exactly one run (writer-bounded at
cfg.chunk_edges rows), the sender transmits straight from the stacked column
array, and the receiver materializes one frame at a time — both ends report
their buffers to the MemoryGauge, so the O(chunk) bound of the disk tier
holds across the wire and is *asserted*, not assumed.

Failure discipline: a crashed exchange leaves (a) stale complete runs from
the dead attempt and (b) partially-received `.part` frames.  Both backends
expose the same sweep — `clean_inboxes()` removes a named inbox wholesale
(the "cleaned BEFORE the senders run" invariant of drive_shuffle/drive_walks)
and `sweep_partial_frames()` clears orphaned `.part` staging files — so the
PhaseOrchestrator's resume path replays a crashed exchange from the sender's
checkpointed runs no matter which backend carried the original attempt.
Frame sequence numbers must arrive contiguous per connection; a gap means a
lost or reordered frame and the server refuses it (corruption guard, same
spirit as MonotoneLookup's regression check).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import socket
import struct
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from .trace import get_tracer
from .blockstore import (
    BlockStore, IOLedger, MemoryGauge, auto_run_tag, clean_store,
    stack_columns)
from .shardmap import frame_version_ok

_MAGIC = b"EXG1"
_KIND_DATA = 0
_KIND_CLEAN = 1
# Raw-file shard migration (rebalancer traffic): chunked byte-exact copies
# of bucket files, riding the same framing/ack/.part discipline as DATA.
_KIND_MIGRATE = 3
_HDR = struct.Struct("!4sBI")     # magic, kind, header_len
_PLEN = struct.Struct("!Q")       # payload_len
_ACK = struct.Struct("!BI")       # status (0 ok), message_len
# A corrupt length prefix must fail fast, not allocate: no legal frame
# carries more than one writer-bounded run, so anything past 8 GiB is noise —
# and a legal header or ack message is a few hundred bytes, so those are
# bounded far tighter (the O(chunk) receive buffer must not be defeatable by
# a garbage length field).
_MAX_FRAME_BYTES = 1 << 33
_MAX_HEADER_BYTES = 1 << 20
_SOCKET_TIMEOUT = 180.0

PART_SUFFIX = ".part"


class TransportError(RuntimeError):
    """A peer refused or corrupted an exchange frame."""


@dataclasses.dataclass
class TransportStats:
    """Wire-level accounting (the network twin of IOLedger): one frame per
    exchanged run, bytes counted once — the single-traversal term in the
    external.py I/O-cost table."""

    frames_sent: int = 0
    bytes_sent: int = 0
    frames_recv: int = 0
    bytes_recv: int = 0
    # Rebalancer traffic (MIGRATE frames), kept apart from exchange bytes:
    # migration is a placement cost the rebalancer must amortize, not part
    # of the pipeline's single-traversal exchange term.
    migrate_frames: int = 0
    migrate_bytes: int = 0

    def add(self, other: "TransportStats") -> None:
        self.frames_sent += other.frames_sent
        self.bytes_sent += other.bytes_sent
        self.frames_recv += other.frames_recv
        self.bytes_recv += other.bytes_recv
        self.migrate_frames += other.migrate_frames
        self.migrate_bytes += other.migrate_bytes


def sweep_partial_frames(workdir: str) -> None:
    """Remove orphaned `.part` staging files (a receive killed mid-frame).

    Shared resume sweep: PhaseOrchestrator calls this next to
    clean_cascade_stores so a resumed run starts from complete runs only —
    the socket twin of sweeping stale `{sender}_{seq}` files.  The walk is
    fully recursive because namespaced exchanges (one `job...` subdir per
    queued job) nest store directories one level deeper than the flat
    layout; attach() already ignores non-`.npy` names, so this is hygiene
    plus disk reclamation, never correctness-by-luck.
    """
    if not os.path.isdir(workdir):
        return
    for root, _dirs, files in os.walk(workdir):
        for f in files:
            if f.endswith(PART_SUFFIX):
                os.unlink(os.path.join(root, f))


def _check_store_name(name: str) -> str:
    if not name or os.sep in name or (os.altsep and os.altsep in name) \
            or name in (".", "..") or name.startswith("."):
        raise TransportError(f"illegal store name in frame: {name!r}")
    return name


def _check_subdir(name: str) -> str:
    """Validate a frame's exchange-namespace component: one path segment,
    same character discipline as store names (a namespaced inbox lives at
    `<workdir>/<subdir>/<store>`, never deeper, never outside)."""
    if not name or os.sep in name or (os.altsep and os.altsep in name) \
            or name in (".", "..") or name.startswith("."):
        raise TransportError(f"illegal exchange namespace in frame: {name!r}")
    return name


def _check_rel_path(path: str) -> str:
    """Validate a MIGRATE frame's destination path: slash-separated, every
    segment store-name-disciplined, bounded depth (the deepest legal layout
    is `<namespace>/<store>/<run file>`)."""
    parts = str(path).split("/")
    if not 1 <= len(parts) <= 4:
        raise TransportError(f"illegal migration path depth: {path!r}")
    for seg in parts:
        _check_store_name(seg)
    return "/".join(parts)


# Store/file naming encodes the destination bucket (`..._b003`,
# `..._b003_sorted`, `walks_b003.npy`); this is the ONE parser of that
# convention, shared by the receive-side skew attribution below and the
# rebalancer's bucket-file discovery in core/cluster.py.
_STORE_BUCKET_RE = re.compile(r"_b(\d{3})(?=$|[._])")


def store_bucket(name: str) -> Optional[int]:
    """Bucket id encoded in a store/file name, or None."""
    m = _STORE_BUCKET_RE.search(name)
    return int(m.group(1)) if m else None


class Transport:
    """Sender/receiver pair over which bucket kernels exchange tagged runs.

    channel(dest, name)   sender side: a run sink with BlockStore's
                          `append_run(*cols, tag=)` signature, bound to the
                          inbox `name` of bucket `dest`.
    drain_inbox(name)     receiver side: the inbox as a BlockStore, runs in
                          lexicographic tag (== sender) order.  Callable only
                          after the phase barrier — both backends guarantee
                          every send is fully written at the receiver before
                          the sending kernel returns.
    clean_inboxes(names)  pre-barrier sweep of multi-writer inboxes (stale
                          complete runs AND partial frames from a crashed
                          attempt) — drivers call it BEFORE the senders run.
    flush()               drain in-flight sends (no-op for both current
                          backends: fs writes are synchronous, socket sends
                          are acked per frame).
    """

    kind = "?"

    def channel(self, dest_bucket: int, name: str,
                columns: Sequence[str] = ("src", "dst"), dtype=np.int64):
        raise NotImplementedError

    def channels(self, name_of, nparts: int,
                 columns: Sequence[str] = ("src", "dst"),
                 dtype=np.int64) -> List:
        """One channel per destination bucket (`name_of(d)` names d's inbox) —
        the partition_runs sink list."""
        return [self.channel(d, name_of(d), columns=columns, dtype=dtype)
                for d in range(nparts)]

    def drain_inbox(self, name: str, columns: Sequence[str] = ("src", "dst"),
                    dtype=np.int64) -> BlockStore:
        """Shared by both backends (one implementation, one receive path —
        the drain twin of stack_columns): the inbox always lives on the
        local filesystem, whether a local append or the colocated
        ExchangeServer put the runs there."""
        return BlockStore.attach(self.workdir, name, self.ledger,
                                 columns=columns, dtype=dtype, gauge=self.gauge)

    def clean_inboxes(self, names: Sequence[str]) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def rebind(self, ledger: IOLedger,
               gauge: Optional[MemoryGauge] = None) -> None:
        """Point accounting at a new ledger/gauge and reset per-task stats —
        pool workers reuse one transport (and its TCP connections) across
        kernel invocations, but each task accounts into its own objects."""
        self.ledger = ledger
        self.gauge = gauge if gauge is not None else MemoryGauge()
        self.stats = TransportStats()

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _CountingChannel:
    """FilesystemTransport's run sink: the destination BlockStore plus
    wire-equivalent stats, so `TransportStats` means the same thing on both
    backends — bytes handed to the exchange, counted once per run."""

    __slots__ = ("_store", "_stats")

    def __init__(self, store: BlockStore, stats: TransportStats):
        self._store = store
        self._stats = stats

    def append_run(self, *cols: np.ndarray, tag: Optional[str] = None) -> int:
        i = self._store.append_run(*cols, tag=tag)
        self._stats.frames_sent += 1
        self._stats.bytes_sent += (self._store.run_rows(i) * self._store.ncols
                                   * self._store.dtype.itemsize)
        return i


class FilesystemTransport(Transport):
    """The `{sender}_{seq}` shared-filesystem convention as a Transport: a
    channel is the destination store itself (send == local append), drain is
    BlockStore.attach, and the inbox sweep is clean_store + partial-frame
    removal.  This is the reference implementation the socket backend must be
    bit-identical to."""

    kind = "fs"

    def __init__(self, workdir: str, ledger: IOLedger,
                 gauge: Optional[MemoryGauge] = None):
        self.workdir = workdir
        self.ledger = ledger
        self.gauge = gauge if gauge is not None else MemoryGauge()
        self.stats = TransportStats()

    def channel(self, dest_bucket: int, name: str,
                columns: Sequence[str] = ("src", "dst"), dtype=np.int64):
        return _CountingChannel(
            BlockStore(self.workdir, name, self.ledger, columns=columns,
                       dtype=dtype, gauge=self.gauge),
            self.stats)

    def clean_inboxes(self, names: Sequence[str]) -> None:
        for name in names:
            clean_store(self.workdir, name)


# ---------------------------------------------------------------------------
# socket backend
# ---------------------------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    # Returned as the bytearray it was received into (no bytes() copy): a
    # frame payload is one writer-bounded run, and copying it would silently
    # double the receiver's resident bytes per frame.
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise TransportError("peer closed mid-frame")
        got += r
    return buf


def _send_frame(sock: socket.socket, kind: int, meta: Dict,
                payload=b"") -> None:
    header = json.dumps(meta).encode()
    sock.sendall(_HDR.pack(_MAGIC, kind, len(header)))
    sock.sendall(header)
    sock.sendall(_PLEN.pack(len(payload)))
    if len(payload):
        sock.sendall(payload)


def _recv_ack(sock: socket.socket) -> None:
    status, mlen = _ACK.unpack(_recv_exact(sock, _ACK.size))
    if mlen > _MAX_HEADER_BYTES:
        raise TransportError(f"oversized ack message ({mlen} bytes): torn ack")
    msg = _recv_exact(sock, mlen).decode() if mlen else ""
    if status != 0:
        raise TransportError(f"exchange peer refused frame: {msg}")


class _SocketChannel:
    """Sender-side run sink: frames each appended run and ships it to the
    ExchangeServer owning the destination bucket.  Mirrors
    BlockStore.append_run exactly (same stacking, dtype coercion, and
    auto-naming) so the receiver's files are bit-identical to the filesystem
    backend's."""

    def __init__(self, transport: "SocketTransport", addr: str, name: str,
                 columns: Sequence[str], dtype):
        self._tr = transport
        self._addr = addr
        self.name = name
        self.columns = tuple(columns)
        self.dtype = np.dtype(dtype)
        self._auto_seq = 0

    def append_run(self, *cols: np.ndarray, tag: Optional[str] = None) -> int:
        # stack_columns/auto_run_tag are the SAME code BlockStore.append_run
        # runs, so the receiver's files are bit-identical to a local append;
        # multi-writer exchanges always pass explicit {sender}_{seq} tags.
        arr = stack_columns(cols, self.columns, self.dtype)
        if tag is None:
            tag = auto_run_tag(self._auto_seq)
        self._auto_seq += 1
        self._tr.gauge.track(arr.shape[0])
        meta = {
            "store": self.name,
            "tag": tag,
            "dtype": self.dtype.str,
            "rows": int(arr.shape[0]),
            "ncols": int(arr.shape[1]),
        }
        if self._tr.namespace is not None:
            meta["subdir"] = self._tr.namespace
        # Flat byte view (len() of a 2-D memoryview counts ROWS, not bytes);
        # zero-copy when contiguous, which np.stack output always is.
        payload = (memoryview(arr).cast("B") if arr.flags.c_contiguous
                   else arr.tobytes())
        tracer = get_tracer()
        if tracer.enabled:
            # One "wire" span per frame: send + durable-receive ack — the
            # synchronous exchange cost a phase actually pays per run.
            with tracer.span(f"send:{self.name}", cat="wire",
                             bytes=int(arr.nbytes)):
                self._tr._rpc(self._addr, _KIND_DATA, meta, payload)
        else:
            self._tr._rpc(self._addr, _KIND_DATA, meta, payload)
        self._tr.stats.frames_sent += 1
        self._tr.stats.bytes_sent += arr.nbytes
        return self._auto_seq - 1


class SocketTransport(Transport):
    """Framed-TCP exchange: one lazy connection per peer server, one frame
    per run, synchronous ack after the receiver has written and atomically
    renamed the run file (its ExchangeServer's fsync flag upgrades that to
    host-crash durability).  Ack-per-frame means (a) the send buffer is exactly one in-flight
    run — the O(chunk) gauge bound holds on the wire — and (b) when a sending
    kernel returns, every run it shipped is attachable at the receiver, so
    the phase barrier needs no extra flush round.

    `peers[d]` is the "host:port" of the ExchangeServer owning bucket d.
    Inbox drains read the local filesystem (this process must be colocated
    with the server that owns its buckets — on one host, every process is).

    `namespace` scopes every frame to a per-job inbox subdirectory at the
    receiver (`<server workdir>/<namespace>/<store>`): concurrent jobs from
    the queue share one ExchangeServer per host without their same-named
    inboxes (edges, owned, walk frontiers) ever colliding.  The sender's
    own `workdir` is already the namespaced job directory, so drains stay
    symmetric with receives.
    """

    kind = "socket"

    def __init__(self, workdir: str, ledger: IOLedger,
                 gauge: Optional[MemoryGauge] = None,
                 peers: Sequence[str] = (),
                 namespace: Optional[str] = None,
                 map_version: Optional[int] = None):
        if not peers:
            raise ValueError("SocketTransport needs one peer address per bucket")
        self.workdir = workdir
        self.ledger = ledger
        self.gauge = gauge if gauge is not None else MemoryGauge()
        self.peers = tuple(str(p) for p in peers)
        self.namespace = _check_subdir(namespace) if namespace else None
        # Shard-map version this transport's routes were computed under.
        # Stamped into every frame as `mapv`; receivers ratchet a minimum at
        # rebalance barriers and refuse anything older (stale-route fence).
        # None = unversioned sender (standalone transports), never refused.
        self.map_version = None if map_version is None else int(map_version)
        self.stats = TransportStats()
        self._conns: Dict[str, List] = {}   # addr -> [socket, next_seq]

    # -- wire ---------------------------------------------------------------
    def _conn(self, addr: str) -> List:
        ent = self._conns.get(addr)
        if ent is None:
            host, port = addr.rsplit(":", 1)
            s = socket.create_connection((host, int(port)),
                                         timeout=_SOCKET_TIMEOUT)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            ent = self._conns[addr] = [s, 0]
        return ent

    def _rpc(self, addr: str, kind: int, meta: Dict, payload=b"") -> None:
        ent = self._conn(addr)
        meta = dict(meta)
        meta["seq"] = ent[1]
        if self.map_version is not None:
            meta["mapv"] = self.map_version
        try:
            _send_frame(ent[0], kind, meta, payload)
            _recv_ack(ent[0])
        except (OSError, TransportError):
            # A failed frame poisons the connection's seq contract — drop it
            # so a retry (resumed phase) starts a fresh, zero-based stream.
            try:
                ent[0].close()
            finally:
                self._conns.pop(addr, None)
            raise
        ent[1] += 1

    # -- Transport interface --------------------------------------------------
    def channel(self, dest_bucket: int, name: str,
                columns: Sequence[str] = ("src", "dst"), dtype=np.int64):
        return _SocketChannel(self, self.peers[dest_bucket], name, columns, dtype)

    # Names per CLEAN frame: keeps the JSON header far under the server's
    # _MAX_HEADER_BYTES bound at any nb/walk-length (walk_gc cleans
    # nb*(2L+3) names in one call).
    _CLEAN_BATCH = 2048

    def clean_inboxes(self, names: Sequence[str]) -> None:
        """CLEAN frames to every distinct peer server: each removes the
        named inbox directories (complete runs AND `.part` partial frames)
        on ITS workdir and acks — so the pre-senders invariant holds
        cluster-wide, not just on the driver's host.  When several loopback
        servers share one workdir the broadcast makes the later sweeps
        idempotent no-ops; the transport deliberately does not model which
        peers are colocated, because on distinct hosts every server
        genuinely needs the CLEAN."""
        names = list(names)
        if not names:
            return
        with get_tracer().span("clean_inboxes", cat="wire",
                               stores=len(names)):
            for addr in dict.fromkeys(self.peers):   # distinct, stable order
                for lo in range(0, len(names), self._CLEAN_BATCH):
                    meta = {"stores": names[lo : lo + self._CLEAN_BATCH]}
                    if self.namespace is not None:
                        meta["subdir"] = self.namespace
                    self._rpc(addr, _KIND_CLEAN, meta)

    def send_file(self, addr: str, src_path: str, rel_path: str,
                  chunk_bytes: int = 4 << 20) -> int:
        """MIGRATE a raw local file to the server at `addr`, chunked.

        The receiver stages bytes in `<rel_path>.part` and atomically
        renames + acks on the final chunk (ack-after-durable, the DATA
        discipline) — once this returns, the caller may unlink its local
        copy.  Bytes are copied verbatim, so a migrated bucket file is
        bit-identical by construction.  `rel_path` is relative to the
        receiver's workdir (slash separated; spans namespace subdirs, so
        migration moves every job's data for a bucket, which is why it does
        NOT take this transport's own `namespace`).  Returns bytes sent.
        """
        rel = _check_rel_path(rel_path)
        total = os.path.getsize(src_path)
        sent = 0
        with get_tracer().span(f"migrate:{rel}", cat="wire", bytes=total), \
                open(src_path, "rb") as f:
            while True:
                data = f.read(chunk_bytes)
                if not data and sent < total:
                    raise TransportError(
                        f"{src_path} shrank mid-migration ({sent}/{total})")
                self._rpc(addr, _KIND_MIGRATE,
                          {"path": rel, "offset": sent, "total": total}, data)
                if data:
                    self.ledger.read(len(data))
                self.stats.migrate_frames += 1
                self.stats.migrate_bytes += len(data)
                sent += len(data)
                if sent >= total:
                    return total

    def purge_namespace(self) -> None:
        """Remove THIS transport's entire namespace subdirectory on every
        peer server (and locally): the dead-letter GC — a job parked after
        exhausting its lease budget must not leave partial stores behind.
        Only meaningful on a namespaced transport; the wire op is refused by
        the server otherwise (an un-namespaced purge would be `rm -rf` of
        the host workdir)."""
        if self.namespace is None:
            raise TransportError("purge_namespace needs a namespaced transport")
        for addr in dict.fromkeys(self.peers):
            self._rpc(addr, _KIND_CLEAN,
                      {"stores": [], "subdir": self.namespace, "purge": True})

    def close(self) -> None:
        for ent in self._conns.values():
            try:
                ent[0].close()
            except OSError:
                pass
        self._conns.clear()


class ExchangeServer:
    """Receiver half of SocketTransport: accepts peer connections and writes
    each DATA frame as `run_{tag}.npy` in the named inbox store — staged as
    `.part` and atomically renamed, acked only after the rename, so a
    crashed receive can never surface a torn run (attach() ignores `.part`;
    sweep_partial_frames reclaims them).  CLEAN frames remove inbox
    directories wholesale (the pre-senders sweep, executed on the receiver's
    own filesystem).

    One bounded frame is resident per connection (payload = one
    writer-bounded run), tracked in `gauge`; file writes are charged to
    `ledger` exactly as a local append_run would be, so a partitioned
    driver's aggregate accounting stays comparable across backends.
    Per-connection sequence numbers must arrive contiguous from 0 — a gap is
    a lost/reordered frame and the frame is refused (corruption guard).
    """

    def __init__(self, workdir: str, host: str = "127.0.0.1", port: int = 0,
                 fsync: bool = False):
        # `fsync=True` upgrades the ack guarantee from process-crash
        # durability (written + atomically renamed; the page cache is the
        # OS's) to host-crash durability (file + directory fsync before the
        # ack) at a large per-frame cost.  The default matches the rest of
        # the disk tier — checkpoint state files are not fsynced either, so
        # power loss is out of scope repo-wide unless opted into.
        self.fsync = fsync
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.ledger = IOLedger()
        self.gauge = MemoryGauge()
        self.stats = TransportStats()
        # Stale-route fence: data-bearing frames stamped with a shard-map
        # version below this minimum are refused (a sender that missed a
        # rebalance barrier must not deliver bytes to the old owner).
        # Monotone ratchet — see set_min_map_version.
        self.min_map_version = 0
        self._lock = threading.Lock()
        self._sock = socket.create_server((host, port))
        bound = self._sock.getsockname()
        self.addr = f"{bound[0]}:{bound[1]}"
        self._live_conns: set = set()
        self._stopping = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"exchange-server-{bound[1]}",
            daemon=True)
        self._accept_thread.start()

    # -- receive loop ---------------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return   # listening socket closed by stop()
            conn.settimeout(_SOCKET_TIMEOUT)
            with self._lock:
                self._live_conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        expect_seq = 0
        try:
            with conn:
                while True:
                    # Idle between frames is NOT an error: peers hold their
                    # connection across phase barriers (the driver's CLEAN
                    # channel idles for a whole phase; a sender kernel may
                    # sort for minutes between appends), so wait unbounded
                    # for the next frame to START.  Once one starts, a stall
                    # mid-frame means a hung/dead peer — that times out.
                    conn.settimeout(None)
                    try:
                        first = conn.recv(1)
                    except OSError:
                        return
                    if not first:
                        return   # clean EOF between frames
                    conn.settimeout(_SOCKET_TIMEOUT)
                    try:
                        head = first + _recv_exact(conn, _HDR.size - 1)
                        magic, kind, hlen = _HDR.unpack(head)
                        if magic != _MAGIC:
                            raise TransportError("bad frame magic")
                        if hlen > _MAX_HEADER_BYTES:
                            raise TransportError(
                                f"frame header {hlen} bytes exceeds bound")
                        meta = json.loads(_recv_exact(conn, hlen).decode())
                        (plen,) = _PLEN.unpack(_recv_exact(conn, _PLEN.size))
                        if plen > _MAX_FRAME_BYTES:
                            raise TransportError(
                                f"frame payload {plen} exceeds bound")
                        # Cross-check the raw length prefix against the
                        # header BEFORE allocating: the receive buffer must
                        # be bounded by the writer-bounded run the header
                        # describes (O(chunk)), not by whatever a corrupt
                        # prefix claims.
                        if kind == _KIND_DATA:
                            expect = (int(meta["rows"]) * int(meta["ncols"])
                                      * np.dtype(meta["dtype"]).itemsize)
                            if plen != expect:
                                raise TransportError(
                                    f"payload length {plen} != header's "
                                    f"rows*ncols*itemsize ({expect}) — "
                                    "corrupt or truncated frame")
                        elif kind == _KIND_MIGRATE:
                            if int(meta["offset"]) + plen > int(meta["total"]):
                                raise TransportError(
                                    f"migration chunk overruns declared "
                                    f"total ({meta['offset']}+{plen} > "
                                    f"{meta['total']})")
                        elif plen:
                            raise TransportError(
                                f"unexpected {plen}-byte payload on "
                                f"control frame kind {kind}")
                        payload = _recv_exact(conn, plen) if plen else b""
                        if meta.get("seq") != expect_seq:
                            raise TransportError(
                                f"frame seq {meta.get('seq')} != expected "
                                f"{expect_seq}: lost or reordered frame")
                        self._handle(kind, meta, payload)
                        expect_seq += 1
                        conn.sendall(_ACK.pack(0, 0))
                    except (TransportError, TypeError, ValueError, KeyError,
                            json.JSONDecodeError, OSError) as e:
                        # OSError covers receiver-side disk failures (ENOSPC,
                        # EACCES in _handle_data) and mid-frame socket
                        # stalls alike: NACK with the real cause so the
                        # sender's TransportError names it instead of
                        # reporting a bare closed connection.
                        msg = str(e).encode()[:4096]
                        try:
                            conn.sendall(_ACK.pack(1, len(msg)) + msg)
                        except OSError:
                            pass
                        return
        except OSError:
            return
        finally:
            with self._lock:
                self._live_conns.discard(conn)

    def set_min_map_version(self, version: int) -> None:
        """Ratchet the stale-route fence (monotone: never lowers)."""
        with self._lock:
            if int(version) > self.min_map_version:
                self.min_map_version = int(version)

    def _handle(self, kind: int, meta: Dict, payload: bytes) -> None:
        if kind in (_KIND_DATA, _KIND_MIGRATE) and not frame_version_ok(
                meta.get("mapv"), self.min_map_version):
            raise TransportError(
                f"stale shard-map route: frame mapv={meta.get('mapv')} < "
                f"server minimum {self.min_map_version}")
        if kind == _KIND_DATA:
            self._handle_data(meta, payload)
        elif kind == _KIND_MIGRATE:
            self._handle_migrate(meta, payload)
        elif kind == _KIND_CLEAN:
            root = self.workdir
            if meta.get("subdir") is not None:
                root = os.path.join(root, _check_subdir(str(meta["subdir"])))
            if meta.get("purge"):
                # Whole-namespace removal (dead-letter GC).  Refused without
                # a subdir: an un-scoped purge would be the host workdir.
                if meta.get("subdir") is None:
                    raise TransportError("purge frame without a namespace")
                shutil.rmtree(root, ignore_errors=True)
                return
            for name in meta["stores"]:
                clean_store(root, _check_store_name(name))
        else:
            raise TransportError(f"unknown frame kind {kind}")

    def _handle_data(self, meta: Dict, payload: bytes) -> None:
        name = _check_store_name(meta["store"])
        tag = str(meta["tag"])
        if "/" in tag or ".." in tag:
            raise TransportError(f"illegal run tag: {tag!r}")
        dtype = np.dtype(meta["dtype"])
        rows, ncols = int(meta["rows"]), int(meta["ncols"])
        if rows * ncols * dtype.itemsize != len(payload):
            raise TransportError(
                f"payload length {len(payload)} != rows*ncols*itemsize "
                f"({rows}x{ncols}x{dtype.itemsize}) — truncated frame")
        arr = np.frombuffer(payload, dtype=dtype).reshape(rows, ncols)
        root = self.workdir
        if meta.get("subdir") is not None:
            root = os.path.join(root, _check_subdir(str(meta["subdir"])))
        store_dir = os.path.join(root, name)
        os.makedirs(store_dir, exist_ok=True)
        final = os.path.join(store_dir, f"run_{tag}.npy")
        part = final + PART_SUFFIX
        # Written and atomically renamed BEFORE the ack: the sender's phase
        # checkpoints (and GC frees its input stores) on the strength of
        # this ack, so a receiver PROCESS crash can never lose or tear an
        # acked run.  With fsync=True the same holds across a receiver HOST
        # crash (file + directory fsync first).
        with open(part, "wb") as f:
            np.save(f, arr)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(part, final)   # atomic: never a torn run file
        if self.fsync:
            dirfd = os.open(store_dir, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        with self._lock:
            self.gauge.track(rows)
            self.ledger.write(arr.nbytes)
            self.ledger.rows_written += rows
            b = store_bucket(name)
            if b is not None:
                # Receive-side skew attribution: the inbox name encodes the
                # destination bucket, so every exchanged byte lands in the
                # per-bucket counters the rebalancer reads.
                self.ledger.bucket(b, arr.nbytes, rows)
            self.stats.frames_recv += 1
            self.stats.bytes_recv += arr.nbytes
        tracer = get_tracer()
        if tracer.enabled:
            tracer.instant(f"recv:{name}", cat="wire", bytes=int(arr.nbytes),
                           rows=rows)

    def _handle_migrate(self, meta: Dict, payload: bytes) -> None:
        rel = _check_rel_path(str(meta["path"]))
        offset, total = int(meta["offset"]), int(meta["total"])
        if offset < 0 or total < 0 or offset + len(payload) > total:
            raise TransportError(
                f"bad migration chunk bounds: offset={offset} "
                f"len={len(payload)} total={total}")
        if not payload and total > 0:
            raise TransportError(f"empty migration chunk for {rel!r}")
        final = os.path.join(self.workdir, *rel.split("/"))
        part = final + PART_SUFFIX
        os.makedirs(os.path.dirname(final), exist_ok=True)
        if offset == 0:
            f = open(part, "wb")      # (re)start: truncate any stale staging
        elif os.path.exists(part):
            f = open(part, "r+b")
        else:
            raise TransportError(
                f"migration chunk at offset {offset} without staged prefix "
                f"for {rel!r} — sender must restart the file")
        with f:
            f.seek(offset)
            if payload:
                f.write(payload)
            if self.fsync and offset + len(payload) >= total:
                f.flush()
                os.fsync(f.fileno())
        if offset + len(payload) >= total:
            os.replace(part, final)   # atomic: never a torn shard file
            if self.fsync:
                dirfd = os.open(os.path.dirname(final), os.O_RDONLY)
                try:
                    os.fsync(dirfd)
                finally:
                    os.close(dirfd)
        with self._lock:
            # Deliberately NOT bucket-attributed: migration bytes are
            # rebalancing overhead, and folding them into bucket_bytes would
            # make a just-moved bucket look hot at its new owner.
            self.ledger.write(len(payload))
            self.stats.migrate_frames += 1
            self.stats.migrate_bytes += len(payload)

    # -- accounting / lifecycle ----------------------------------------------
    def drain_accounting(self, ledger: IOLedger,
                         gauge: Optional[MemoryGauge] = None) -> TransportStats:
        """Move accumulated ledger counters into `ledger` (so the driver's
        per-phase deltas include receiver-side writes), fold the gauge peak,
        and hand over (then reset) the wire stats accumulated since the last
        drain."""
        with self._lock:
            ledger.merge(self.ledger.as_dict())
            self.ledger = IOLedger()
            if gauge is not None:
                gauge.track(self.gauge.peak_rows)
            out = self.stats
            self.stats = TransportStats()
            return out

    def stop(self) -> None:
        if self._stopping:
            return
        self._stopping = True
        # Closing a listening socket does not wake an accept() blocked on it
        # (Linux); shutting it down first does, so the join returns at once.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=5.0)
        # Unblock handler threads idling between frames (daemon threads, but
        # each pins a socket fd until its peer goes away).
        with self._lock:
            live = list(self._live_conns)
        for conn in live:
            try:
                conn.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def make_transport(pcfg, workdir: str, ledger: IOLedger,
                   gauge: Optional[MemoryGauge] = None) -> Transport:
    """Build the transport a config asks for.  `pcfg` is duck-typed
    (GraphConfig or phases.PlainCfg): `transport` in {"fs", "socket"}, and for
    sockets `peer_addrs` must hold one live "host:port" per bucket — the
    partitioned driver starts loopback ExchangeServers and fills them in."""
    kind = getattr(pcfg, "transport", "fs")
    if kind in ("fs", "filesystem"):
        return FilesystemTransport(workdir, ledger, gauge)
    if kind == "socket":
        peers = getattr(pcfg, "peer_addrs", None)
        if not peers:
            raise ValueError(
                "transport='socket' needs peer_addrs (one ExchangeServer "
                "address per bucket) — use PartitionedGenerator, which "
                "starts loopback servers and plumbs their addresses through")
        return SocketTransport(workdir, ledger, gauge, peers=peers,
                               namespace=getattr(pcfg, "exchange_namespace",
                                                 None),
                               map_version=getattr(pcfg, "shard_map_version",
                                                   None))
    raise ValueError(f"unknown transport {kind!r} (expected 'fs' or 'socket')")
