"""Phase orchestration for the disk tier + the partitioned multi-process mode.

Three things live here (twin of `repro.core.phases`; the per-chunk hot
loops — edge generation, the Feistel relabel, the partition counts and the
pv join's gather — run on `PlainCfg.device` through `core/chunks.py`'s
hooks, the host's sorts and merges stay numpy):

  PhaseOrchestrator    declares the pipeline as named, resumable,
                       individually-measurable phases.  Each phase records a
                       per-phase I/O-ledger delta (the paper's Fig. 2/4 are
                       per-phase measurements — the orchestrator is what
                       makes the host tier measurable the same way) and,
                       with checkpointing on, persists a JSON manifest of its
                       output stores so a crashed/killed run resumes at the
                       first incomplete phase.

  bucket-level kernels the unit of distribution: every pipeline phase is a
                       function of (config, workdir, bucket_id) operating on
                       BlockStores addressed *by naming convention* —
                       `pv_r{round}_b{bucket}`, `edges_b{bucket}`, … — and
                       exchanging runs through a pluggable Transport
                       (core/transport.py) that plays the role of the
                       paper's MPI interconnect: the shared filesystem
                       (`{sender}_{seq}` run tags) or framed TCP to per-
                       bucket ExchangeServers.  A phase is the same code
                       whether one process runs all buckets
                       (StreamingGenerator) or nb workers run one each
                       (PartitionedGenerator), and whichever backend carries
                       the exchange — outputs are bit-identical.

  PartitionedGenerator the single-host stand-in for the paper's 64-node
                       cluster: nb `concurrent.futures` workers, each owning
                       the vertex range [i*B, (i+1)*B), with a barrier after
                       every phase (the paper's bulk-synchronous MPI
                       structure).  Workers account I/O into private ledgers
                       that the parent merges (receiver-side ExchangeServer
                       accounting folds in at the same barriers), so the
                       aggregate ledger is comparable with the sequential
                       driver's.  The execution strategy is a hook
                       (`_submit`): core/cluster.py's ClusterGenerator
                       subclasses it to dispatch the same kernels to
                       HostRunner daemons on N machines — the paper's actual
                       deployment shape.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .blockstore import (
    BlockStore,
    IOLedger,
    MemoryGauge,
    MonotoneLookup,
    NpyColumnStore,
    clean_cascade_stores,
    clean_store,
    merge_runs,
    merge_segments,
    partition_runs,
    sort_runs,
    write_behind,
)
from .corpus import (
    ShardedWalks,
    manifest_name as corpus_manifest_name,
    shard_name as corpus_shard_name,
    write_manifest,
)
from .trace import (
    GLOBAL as GLOBAL_METRICS,
    get_tracer,
    maybe_install_tracer,
    unified_snapshot,
)
from .transport import (
    ExchangeServer,
    Transport,
    TransportStats,
    make_transport,
    sweep_partial_frames,
)
from ..device import resolve_device
from ..kernels import build
from .chunks import graph_perm_chunk, rmat_chunk
from .hostgen import (
    round_salt,
    shuffle_keys,
    walk_rand_np,
    walk_start_np,
)

# ---------------------------------------------------------------------------
# Worker-safe config (GraphConfig carries a torch dtype; workers get this mirror)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlainCfg:
    """Picklable, numpy-only mirror of GraphConfig for phase kernels."""

    scale: int
    edge_factor: int
    seed: int
    a: float
    b: float
    c: float
    d: float
    nb: int
    chunk_edges: int
    rounds: int
    merge_block_rows: int = 0
    merge_fanin: int = 64
    # Overlap disk I/O with compute (blockstore PrefetchReader /
    # WriteBehindWriter) in every external kernel.  Timing-only — outputs
    # are bit-identical on vs. off — so result_config_key normalizes it
    # out; REPRO_IO_OVERLAP=0/false/off forces it off regardless of the
    # GraphConfig (the CI serial shard).
    io_overlap: bool = True
    # Emit timing spans (core/trace.py) from every instrumented layer into
    # per-process trace files under `<workdir>/trace/`.  Timing-only —
    # outputs are bit-identical on vs. off — so result_config_key
    # normalizes it out; REPRO_TRACE=1/0 overrides the GraphConfig.
    trace: bool = False
    # Exchange transport: "fs" (shared-filesystem {sender}_{seq} runs) or
    # "socket" (framed TCP to the ExchangeServer at peer_addrs[bucket]).
    transport: str = "fs"
    peer_addrs: Optional[Tuple[str, ...]] = None
    # Dispatch the CSR sort's cascade merge levels through the worker pool /
    # cluster (phase-level group merges) instead of cascading inline within
    # one consumer kernel.  Output is bit-identical either way (the merge is
    # stable and groups are consecutive), but the PHASE NAMES differ, so
    # this field is deliberately NOT normalized out of result_config_key: a
    # checkpoint taken in one mode must not be resumed in the other (its GC
    # may have freed the other mode's phase inputs).
    pooled_cascade: bool = False
    # Disk-tier shuffle variant: "device" | "external" | "recompute".  The
    # recompute variant (Funke et al.) materializes NO pv stores and fuses
    # relabel + redistribute into one hash-evaluating scan — a different
    # phase schedule AND different CSR sort key, so (like pooled_cascade)
    # it stays in result_config_key.
    shuffle_variant: str = "external"
    # Permutation family: "shuffle" (the materialized shuffle-exchange
    # permutation) or "feistel" (the keyed invertible family —
    # hostgen.graph_perm_np; recomputable on any host, forced by
    # shuffle_variant="recompute", also legal under "external" where the
    # same pv flows through the store machinery for parity testing).
    perm_family: str = "shuffle"
    # Feistel depth (perm_family="feistel"); even, >= 2.
    feistel_rounds: int = 4
    # Per-job exchange namespace (the multi-tenant job queue): when set,
    # every socket frame carries it as a subdir, so concurrent jobs share
    # one ExchangeServer per host without their same-named inboxes ever
    # colliding (`<host workdir>/<namespace>/<store>`).  Pure routing —
    # never affects result bytes — so result_config_key normalizes it out
    # exactly like transport/peer_addrs.
    exchange_namespace: Optional[str] = None
    # Shard-map version the routes in peer_addrs were computed under (the
    # controller's directory ShardMap; core/shardmap.py).  Stamped into
    # every socket frame as `mapv` so receivers can refuse stale routes
    # after a rebalance barrier.  Like peer_addrs this is pure routing —
    # the map changes where bytes live, never what they are — so
    # result_config_key normalizes it out.
    shard_map_version: int = 0
    # Where the per-chunk hooks (core/chunks.py) run: "cuda" launches the
    # kernels, "cpu" runs their plain versions.  Output bytes are identical,
    # so result_config_key normalizes it out.
    device: str = "cuda"

    @property
    def n(self) -> int:
        return 1 << self.scale

    @property
    def m(self) -> int:
        return self.n * self.edge_factor

    @property
    def bucket_size(self) -> int:
        return self.n // self.nb

    @property
    def edges_per_bucket(self) -> int:
        return self.m // self.nb


def _resolve_io_overlap(cfg) -> bool:
    """cfg.io_overlap, unless REPRO_IO_OVERLAP is set in the environment —
    the override keeps one CI tier-1 shard on the strictly serial path
    without threading a config change through every fixture."""
    env = os.environ.get("REPRO_IO_OVERLAP")
    if env is not None:
        return env.strip().lower() not in ("0", "false", "off", "no", "")
    return bool(getattr(cfg, "io_overlap", True))


def _resolve_trace(cfg) -> bool:
    """cfg.trace, unless REPRO_TRACE is set — the override turns tracing on
    for a whole CI job / ad-hoc run without threading a config change
    through every fixture (mirror of _resolve_io_overlap)."""
    env = os.environ.get("REPRO_TRACE")
    if env is not None:
        return env.strip().lower() not in ("0", "false", "off", "no", "")
    return bool(getattr(cfg, "trace", False))


def plain_config(cfg, device="cuda") -> PlainCfg:
    """Accepts GraphConfig (or anything duck-typed like it).  `device` goes
    through `resolve_device`: "cuda" raises without CUDA."""
    shuffle_variant = str(getattr(cfg, "shuffle_variant", "external"))
    perm_family = str(getattr(cfg, "perm_family", "shuffle"))
    if shuffle_variant == "recompute" and perm_family == "shuffle":
        # recompute REQUIRES a recomputable permutation; auto-select it so
        # cfg.with_(shuffle_variant="recompute") alone does the right thing.
        perm_family = "feistel"
    p = PlainCfg(
        scale=int(cfg.scale), edge_factor=int(cfg.edge_factor), seed=int(cfg.seed),
        a=float(cfg.a), b=float(cfg.b), c=float(cfg.c), d=float(cfg.d),
        nb=int(cfg.nb), chunk_edges=int(cfg.chunk_edges), rounds=int(cfg.rounds),
        merge_block_rows=int(getattr(cfg, "merge_block_rows", 0)),
        merge_fanin=int(getattr(cfg, "merge_fanin", 64)),
        io_overlap=_resolve_io_overlap(cfg),
        trace=_resolve_trace(cfg),
        # "filesystem" is accepted as an alias and canonicalized, so every
        # downstream comparison can test == "fs" alone.
        transport={"filesystem": "fs"}.get(
            str(getattr(cfg, "transport", "fs")),
            str(getattr(cfg, "transport", "fs"))),
        peer_addrs=(None if getattr(cfg, "peer_addrs", None) is None
                    else tuple(str(a) for a in cfg.peer_addrs)),
        pooled_cascade=bool(getattr(cfg, "pooled_cascade", False)),
        shuffle_variant=shuffle_variant,
        perm_family=perm_family,
        feistel_rounds=int(getattr(cfg, "feistel_rounds", 4)),
        exchange_namespace=(None
                            if getattr(cfg, "exchange_namespace", None) is None
                            else str(cfg.exchange_namespace)),
        shard_map_version=int(getattr(cfg, "shard_map_version", 0)),
        device=str(resolve_device(device)),
    )
    if p.n % p.nb != 0:
        raise ValueError(f"nb={p.nb} must divide n={p.n}")
    if not 1 <= p.scale <= 31:
        raise ValueError(
            f"the disk tier's kernels take int32 ids: need 1 <= scale <= 31, "
            f"got scale={p.scale}")
    if p.shuffle_variant not in ("device", "external", "recompute"):
        raise ValueError(
            f"shuffle_variant must be 'device', 'external' or 'recompute', "
            f"got {p.shuffle_variant!r}")
    if p.perm_family not in ("shuffle", "feistel"):
        raise ValueError(
            f"perm_family must be 'shuffle' or 'feistel', got "
            f"{p.perm_family!r}")
    if p.perm_family == "feistel":
        if p.shuffle_variant == "device":
            raise ValueError(
                "perm_family='feistel' is the disk tier's recomputable "
                "family; use shuffle_variant 'recompute' or 'external' "
                "(the device twin is shuffle.shuffle_recompute)")
        if p.scale > 31:
            raise ValueError(
                f"perm_family='feistel' needs scale <= 31 (ids in the "
                f"uint32 container; (src, dst) sort keys in int64), got "
                f"scale={p.scale}")
        if p.feistel_rounds < 2 or p.feistel_rounds % 2:
            raise ValueError(
                f"feistel_rounds must be even and >= 2, got "
                f"{p.feistel_rounds}")
    if p.merge_fanin == 1 or p.merge_fanin < 0:
        raise ValueError(
            f"merge_fanin must be 0 (flat) or >= 2, got {p.merge_fanin}")
    if p.transport not in ("fs", "socket"):
        raise ValueError(
            f"transport must be 'fs' or 'socket', got {p.transport!r}")
    if p.peer_addrs is not None and len(p.peer_addrs) != p.nb:
        raise ValueError(
            f"peer_addrs must hold one address per bucket: "
            f"got {len(p.peer_addrs)} for nb={p.nb}")
    return p


def result_config_key(pcfg: PlainCfg) -> PlainCfg:
    """The subset of a config that determines the RESULT bytes.  Transport
    choice and peer addresses move data differently but produce bit-identical
    stores, and socket ports are ephemeral — keying checkpoints on them would
    spuriously invalidate (or worse, a changed port would block resuming a
    crashed run).  Normalize them out.  The same normalization is what lets
    a run resume across CLUSTER shapes: host count, exec backend, and
    rendezvous addresses never reach PlainCfg at all, and the fields that do
    (transport, peer_addrs) are erased here — so a 2-host socket run and a
    single-host fs run of the same graph share one checkpoint key.

    `pooled_cascade` stays IN the key on purpose: its bytes are identical
    but its phase schedule is not, and a cross-mode resume could replay a
    phase whose inputs the other mode's checkpoint GC already freed."""
    return dataclasses.replace(pcfg, transport="fs", peer_addrs=None,
                               exchange_namespace=None, shard_map_version=0,
                               io_overlap=True, trace=False, device="cuda")


def validate_external_shape(p: PlainCfg) -> PlainCfg:
    """Shape requirements specific to the nb-way external shuffle/exchange
    (the device-spill path only needs nb | n).  Same constraints the device
    shuffle asserts inside jit; here they must fail before any store is
    written.  The feistel family never runs the positional slice exchange
    (its pv is computed, not shuffled), so it is exempt from the nb**2 <= n
    slice constraint."""
    if p.perm_family != "feistel" and p.bucket_size % p.nb != 0:
        raise ValueError(
            f"bucket size B={p.bucket_size} must split into nb={p.nb} "
            f"exchange slices (need nb**2 <= n)")
    if p.m % p.nb != 0:
        raise ValueError(f"nb={p.nb} must divide m={p.m}")
    return p


# ---------------------------------------------------------------------------
# Store naming convention (the "wire format" between phases)
# ---------------------------------------------------------------------------


def pv_store_name(r: int, i: int) -> str:
    return f"pv_r{r}_b{i:03d}"


def edges_store_name(i: int, pass_ix: Optional[int] = None) -> str:
    return f"edges_b{i:03d}" if pass_ix is None else f"edges_p{pass_ix}_b{i:03d}"


def relabel_inbox_name(pass_ix: int, j: int) -> str:
    return f"rl{pass_ix}_b{j:03d}"


def owned_store_name(j: int) -> str:
    return f"owned_b{j:03d}"


def sorted_owned_store_name(j: int) -> str:
    """Output of the pooled csr_sort phase (run-sorted, not yet merged)."""
    return owned_store_name(j) + "_sorted"


# Pooled-cascade intermediate stores are CHECKPOINTED phase outputs, unlike
# merge_runs' kernel-private `__cas_l` scratch — a distinct marker keeps
# clean_cascade_stores (the resume sweep) from reclaiming them.
POOLED_CASCADE_MARKER = "__pcas_l"


def pooled_cascade_store_name(base: str, level: int, g: int) -> str:
    return f"{base}{POOLED_CASCADE_MARKER}{level}_g{g:04d}"


def csr_offv_path(workdir: str, i: int) -> str:
    return os.path.join(workdir, f"csr_offv_{i:03d}.npy")


def csr_adjv_path(workdir: str, i: int) -> str:
    return os.path.join(workdir, f"csr_adjv_{i:03d}.npy")


def wfront_store_name(t: int, j: int, ns: str = "") -> str:
    """Walker frontier inbox of bucket j at walk step t (multi-writer).
    `ns` is WalkCfg.ns — the per-config prefix that keeps several walk
    configs' stores apart when they advance through one fused CSR scan."""
    return f"{ns}wfront_s{t:04d}_b{j:03d}"


def whist_store_name(s: int, j: int, ns: str = "") -> str:
    """History rows (wid, step=s, vertex) emitted by bucket j (single-writer:
    written fresh by the kernel that advances step s, so a crashed attempt's
    partial rows can never leak into a rerun)."""
    return f"{ns}whist_s{s:04d}_b{j:03d}"


def whist_inbox_name(j: int, ns: str = "") -> str:
    """Walker-block inbox of the history collect phase (multi-writer)."""
    return f"{ns}whout_b{j:03d}"


def load_bucket_csr(offv_path: str, adjv_path: str, ledger: IOLedger,
                    gauge: Optional[MemoryGauge] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Open one bucket's CSR result files: offsets resident (charged to the
    ledger — loading them back is I/O too), adjacency as a memmap (charged
    by whoever streams it)."""
    offv = np.load(offv_path)
    ledger.read(offv.nbytes)
    if gauge is not None:
        gauge.track(offv.shape[0])
    return offv, np.load(adjv_path, mmap_mode="r")


def attach_pv_buckets(pcfg: PlainCfg, workdir: str, ledger: IOLedger,
                      gauge: Optional[MemoryGauge] = None) -> List[BlockStore]:
    """Re-open the final-round pv bucket stores (they ARE the permutation)."""
    return [
        BlockStore.attach(workdir, pv_store_name(pcfg.rounds, i), ledger,
                          columns=("v",), gauge=gauge)
        for i in range(pcfg.nb)
    ]


class _SrcDstKey:
    """Composite (src, dst) merge key src * n + dst — picklable (module-level
    class, not a closure) so pool workers can receive it inside a KeySpec.
    Fits int64 because perm_family='feistel' enforces scale <= 31."""

    def __init__(self, n: int):
        self.n = n

    def __call__(self, s: np.ndarray, d: np.ndarray) -> np.ndarray:
        return s * np.int64(self.n) + d


def csr_merge_key(pcfg: PlainCfg):
    """Sort/merge KeySpec of the CSR build.  The shuffle family sorts by src
    only (column 0): redistribute arrival order is deterministic and the
    stable sort makes within-row adjacency encounter order — the historical
    contract.  The feistel family sorts by (src, dst): recompute and
    external deliver the same owned-edge MULTISET in different arrival
    orders, so only a total key makes their CSR files bit-identical."""
    if pcfg.perm_family == "feistel":
        return _SrcDstKey(pcfg.n)
    return 0


def resolve_merge_key(pcfg: PlainCfg, key):
    """Decode a wire-safe cascade key spec: an int column index, or the
    string "csr" for csr_merge_key (cluster task args travel as JSON, so a
    callable KeySpec cannot ride in them — the sentinel is resolved
    in-kernel from the config instead)."""
    if key == "csr":
        return csr_merge_key(pcfg)
    return int(key)


# ---------------------------------------------------------------------------
# Bucket-level phase kernels (shared by sequential + partitioned drivers)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _exchange(pcfg: PlainCfg, workdir: str, ledger: IOLedger,
              gauge: Optional[MemoryGauge], transport: Optional[Transport]):
    """The transport a kernel exchanges through: the caller's if provided
    (inline drivers reuse one), else one built from the config (worker
    processes — transports hold sockets and are not picklable, so workers
    reconstruct from PlainCfg and tear down with the kernel).  Flushed on
    clean exit either way; only owned transports are closed."""
    if transport is not None:
        yield transport
        transport.flush()
        return
    tr = make_transport(pcfg, workdir, ledger, gauge)
    try:
        yield tr
        tr.flush()
    finally:
        tr.close()


def init_pv_bucket(pcfg: PlainCfg, workdir: str, i: int, *,
                   ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                   transport: Optional[Transport] = None):
    """Round-0 shuffle buffer: bucket i holds its range partition of [0:n)
    (the paper's RP(n, nb)), written as chunk-bounded runs.  Local-only
    (no exchange): `transport` is accepted for the uniform kernel signature
    and unused."""
    B, chunk = pcfg.bucket_size, pcfg.chunk_edges
    store = BlockStore(workdir, pv_store_name(0, i), ledger, columns=("v",), gauge=gauge,
                       fresh=True)
    for lo in range(i * B, (i + 1) * B, chunk):
        hi = min(lo + chunk, (i + 1) * B)
        store.append_run(np.arange(lo, hi, dtype=np.int64))


def shuffle_bucket_round(pcfg: PlainCfg, workdir: str, i: int, r: int, *,
                         ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                         transport: Optional[Transport] = None):
    """One round of the external shuffle for bucket i (paper Alg. 2-4 on disk).

    (i)  local shuffle = external sort of the bucket by the counter-hash key
         mix32(value ^ salt_r) — sorting distinct values by a bijective hash
         is a uniform permutation, and exactly reproduces the device
         shuffle's argsort because the keys are unique;
    (ii) bucket exchange = the sorted stream is cut into nb equal positional
         slices, slice j shipped to next-round bucket j through the transport
         with a `{sender}_{seq}` run tag, so receivers recover sender order
         lexicographically — the disk twin of `lax.all_to_all`, over either
         the shared filesystem or framed TCP.

    Every access is a sequential scan: the shuffle phase does zero random I/O.
    """
    nb, B = pcfg.nb, pcfg.bucket_size
    blk = B // nb
    salt = round_salt(pcfg.seed, r)

    def key(v):
        return shuffle_keys(v, salt)

    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        src = tr.drain_inbox(pv_store_name(r, i), columns=("v",))
        tmp = BlockStore(workdir, pv_store_name(r, i) + "_sorted", ledger, columns=("v",),
                         gauge=gauge, fresh=True)
        sort_runs(src, tmp, key=key, overlap=pcfg.io_overlap)
        outs = tr.channels(lambda j: pv_store_name(r + 1, j), nb, columns=("v",))
        seq = [0] * nb
        pos = 0
        with write_behind(outs, ledger, gauge,
                          enabled=pcfg.io_overlap) as sinks:
            for (v,) in merge_runs(tmp, key=key,
                                   block_rows=pcfg.merge_block_rows,
                                   max_fanin=pcfg.merge_fanin,
                                   overlap=pcfg.io_overlap):
                o = 0
                while o < v.size:
                    j = pos // blk
                    take = min(v.size - o, (j + 1) * blk - pos)
                    sinks[j].append_run(v[o : o + take],
                                        tag=f"{i:03d}_{seq[j]:05d}")
                    seq[j] += 1
                    o += take
                    pos += take
        tmp.destroy()
        src.destroy()


def generate_bucket_edges(pcfg: PlainCfg, workdir: str, i: int, *,
                          ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                          transport: Optional[Transport] = None):
    """Paper Alg. 5: bucket i generates its bin of edges [i*eps, (i+1)*eps).
    Counter-based RNG => the stream is independent of nb and of which
    process generates it (regeneration-friendly).  Local-only (no exchange):
    `transport` is accepted for the uniform kernel signature and unused."""
    eps, chunk = pcfg.edges_per_bucket, pcfg.chunk_edges
    store = BlockStore(workdir, edges_store_name(i), ledger, gauge=gauge, fresh=True)
    start = i * eps
    for lo in range(start, start + eps, chunk):
        cnt = min(chunk, start + eps - lo)
        s, d = rmat_chunk(pcfg, lo, cnt, pcfg.device)
        store.append_run(s, d)


def materialize_pv_bucket(pcfg: PlainCfg, workdir: str, i: int, *,
                          ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                          transport: Optional[Transport] = None):
    """perm_family='feistel' under shuffle_variant='external': write bucket
    i's pv chunk pv[i*B:(i+1)*B] = graph_perm(ids) directly — ONE local phase
    replaces init + log_nb(n) shuffle-exchange rounds, because a recomputable
    permutation needs no shuffling to exist.  (Under 'recompute' even this
    store is skipped; this kernel serves the parity path that runs the
    feistel family through the full store machinery.)  Local-only:
    `transport` is accepted for the uniform kernel signature and unused."""
    B, chunk = pcfg.bucket_size, pcfg.chunk_edges
    store = BlockStore(workdir, pv_store_name(pcfg.rounds, i), ledger,
                       columns=("v",), gauge=gauge, fresh=True)
    for lo in range(i * B, (i + 1) * B, chunk):
        ids = np.arange(lo, min(lo + chunk, (i + 1) * B), dtype=np.int64)
        ledger.hashes(ids.size)
        store.append_run(graph_perm_chunk(pcfg.seed, ids, pcfg.n,
                                          rounds=pcfg.feistel_rounds,
                                          device=pcfg.device))


def relabel_recompute_bucket(pcfg: PlainCfg, workdir: str, i: int, *,
                             ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                             transport: Optional[Transport] = None):
    """The communication-free relabel (Funke et al.): ONE streaming scan of
    bucket i's raw edges applies u -> perm(u) to both endpoints (pure hash
    evaluations charged to ledger.hash_evals — no pv store, no scatter/join
    exchange, no external sort) and partitions each run straight to
    owner(perm(src))'s owned inbox.  The external pipeline's two relabel
    passes AND the redistribute phase collapse into this kernel: the only
    bytes on the wire are the one edge exchange every variant must pay to
    place edges with their owners."""
    B = pcfg.bucket_size

    def relabel(s, d):
        ledger.hashes(s.size + d.size)
        return (graph_perm_chunk(pcfg.seed, s, pcfg.n, rounds=pcfg.feistel_rounds,
                                 device=pcfg.device),
                graph_perm_chunk(pcfg.seed, d, pcfg.n, rounds=pcfg.feistel_rounds,
                                 device=pcfg.device))

    store = BlockStore.attach(workdir, edges_store_name(i), ledger, gauge=gauge)
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        outs = tr.channels(owned_store_name, pcfg.nb)
        partition_runs(store, outs, lambda a, b: a // B,
                       tag_prefix=f"{i:03d}", transform=relabel,
                       overlap=pcfg.io_overlap, device=pcfg.device)


class _RegenRuns:
    """A virtual, read-only BlockStore over bucket i's RAW edge stream that
    REGENERATES each run from the counter-based RNG instead of reading disk
    — run boundaries exactly match what generate_bucket_edges would have
    appended, so any consumer (partition_runs) sees a bit-identical store.
    Exists for gen_relabel_recompute_bucket: a task with no local inputs at
    all is freely migratable between hosts, which is what makes it stealable
    under the job-queue scheduler."""

    def __init__(self, pcfg: PlainCfg, i: int, ledger: IOLedger,
                 gauge: Optional[MemoryGauge]):
        self.pcfg, self.i = pcfg, i
        self.ledger = ledger
        self.gauge = gauge if gauge is not None else MemoryGauge()
        self.name = edges_store_name(i)

    def iter_runs(self):
        pcfg = self.pcfg
        eps, chunk = pcfg.edges_per_bucket, pcfg.chunk_edges
        start = self.i * eps
        for lo in range(start, start + eps, chunk):
            cnt = min(chunk, start + eps - lo)
            s, d = rmat_chunk(pcfg, lo, cnt, pcfg.device)
            self.gauge.track(s.size)
            yield s, d


def gen_relabel_recompute_bucket(pcfg: PlainCfg, workdir: str, i: int, *,
                                 ledger: IOLedger,
                                 gauge: Optional[MemoryGauge] = None,
                                 transport: Optional[Transport] = None):
    """Fused generate+relabel for shuffle_variant='recompute' (Funke et
    al. taken to its conclusion): regenerate bucket i's raw edges chunk by
    chunk from the counter-based RNG and pipe them straight through the
    hash-evaluating relabel into owner(perm(src))'s inbox — the raw-edge
    store is never written.  Wire bytes and inbox contents are bit-identical
    to generate_bucket_edges + relabel_recompute_bucket because _RegenRuns
    reproduces the exact run boundaries; what changes is the task's
    footprint: zero local reads, zero local writes, so the scheduler may
    hand it to ANY host (stealable) without migrating data."""
    if pcfg.shuffle_variant != "recompute":
        raise ValueError("gen_relabel_recompute_bucket requires "
                         f"shuffle_variant='recompute', got "
                         f"{pcfg.shuffle_variant!r}")
    B = pcfg.bucket_size

    def relabel(s, d):
        ledger.hashes(s.size + d.size)
        return (graph_perm_chunk(pcfg.seed, s, pcfg.n, rounds=pcfg.feistel_rounds,
                                 device=pcfg.device),
                graph_perm_chunk(pcfg.seed, d, pcfg.n, rounds=pcfg.feistel_rounds,
                                 device=pcfg.device))

    src = _RegenRuns(pcfg, i, ledger, gauge)
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        outs = tr.channels(owned_store_name, pcfg.nb)
        partition_runs(src, outs, lambda a, b: a // B,
                       tag_prefix=f"{i:03d}", transform=relabel,
                       overlap=pcfg.io_overlap, device=pcfg.device)


def relabel_scatter_bucket(pcfg: PlainCfg, workdir: str, i: int, pass_ix: int, *,
                           ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                           transport: Optional[Transport] = None):
    """Relabel pass `pass_ix`, scatter half (paper Alg. 6): ship each record
    through the transport to the owner of its key field (column 1) so the
    owner can join it against its pv bucket.  Bucket partition = sequential
    scan + stable chunk sort."""
    B = pcfg.bucket_size
    in_name = edges_store_name(i) if pass_ix == 0 else edges_store_name(i, pass_ix - 1)
    store = BlockStore.attach(workdir, in_name, ledger, gauge=gauge)
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        outs = tr.channels(lambda j: relabel_inbox_name(pass_ix, j), pcfg.nb)
        partition_runs(store, outs, lambda a, b: b // B, tag_prefix=f"{i:03d}",
                       overlap=pcfg.io_overlap, device=pcfg.device)


def relabel_apply_bucket(pcfg: PlainCfg, workdir: str, i: int, pass_ix: int, *,
                         ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                         transport: Optional[Transport] = None):
    """Relabel pass `pass_ix`, join half (paper Alg. 7): external-sort my
    inbox by the key field, stream pv blocks past it (sort-merge-join), emit
    (pv[key], other) — the column swap makes pass 1 relabel dst and pass 2
    relabel src with identical code."""
    B, chunk = pcfg.bucket_size, pcfg.chunk_edges
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        inbox = tr.drain_inbox(relabel_inbox_name(pass_ix, i))   # post-barrier
    tmp = BlockStore(workdir, relabel_inbox_name(pass_ix, i) + "_sorted", ledger,
                     gauge=gauge, fresh=True)
    sort_runs(inbox, tmp, key=1, overlap=pcfg.io_overlap)
    pv = BlockStore.attach(workdir, pv_store_name(pcfg.rounds, i), ledger,
                           columns=("v",), gauge=gauge)
    lookup = MonotoneLookup([pv], block_rows=chunk, base=i * B, gauge=gauge,
                            device=pcfg.device)
    out = BlockStore(workdir, edges_store_name(i, pass_ix), ledger, gauge=gauge, fresh=True)
    with write_behind([out], ledger, gauge, enabled=pcfg.io_overlap) as sinks:
        for a, b in merge_runs(tmp, key=1, block_rows=pcfg.merge_block_rows,
                               max_fanin=pcfg.merge_fanin,
                               overlap=pcfg.io_overlap):
            sinks[0].append_run(lookup.lookup(b), a)
    tmp.destroy()
    inbox.destroy()


def relabel_sort_bucket(pcfg: PlainCfg, workdir: str, i: int, pass_ix: int, *,
                        ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                        transport: Optional[Transport] = None) -> int:
    """Pooled-cascade relabel join, phase 1 of 3 (the csr_sort twin): sort
    pass 1 over the relabel inbox, each run sorted by the key field.
    Returns the run count for the driver's cascade plan; the inbox is freed
    by the PHASE's `frees` (after the checkpoint write), never in-kernel."""
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        inbox = tr.drain_inbox(relabel_inbox_name(pass_ix, i))
    out = BlockStore(workdir, relabel_inbox_name(pass_ix, i) + "_sorted",
                     ledger, gauge=gauge, fresh=True)
    sort_runs(inbox, out, key=1, overlap=pcfg.io_overlap)
    return out.num_runs


def relabel_join_bucket(pcfg: PlainCfg, workdir: str, i: int, pass_ix: int,
                        src_name: str, presorted: bool, *,
                        ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                        transport: Optional[Transport] = None):
    """Pooled-cascade relabel join, final phase: the sort-merge-join of
    relabel_apply_bucket, fed from `src_name` (the cascade's last level when
    `presorted`, else a flat bounded merge of the sorted runs)."""
    B, chunk = pcfg.bucket_size, pcfg.chunk_edges
    src = BlockStore.attach(workdir, src_name, ledger, gauge=gauge)
    if presorted:
        stream = merge_segments([(src, list(range(src.num_runs)))], key=1,
                                block_rows=pcfg.merge_block_rows,
                                overlap=pcfg.io_overlap)
    else:
        stream = merge_runs(src, key=1, block_rows=pcfg.merge_block_rows,
                            max_fanin=pcfg.merge_fanin,
                            overlap=pcfg.io_overlap)
    pv = BlockStore.attach(workdir, pv_store_name(pcfg.rounds, i), ledger,
                           columns=("v",), gauge=gauge)
    lookup = MonotoneLookup([pv], block_rows=chunk, base=i * B, gauge=gauge,
                            device=pcfg.device)
    out = BlockStore(workdir, edges_store_name(i, pass_ix), ledger, gauge=gauge,
                     fresh=True)
    with write_behind([out], ledger, gauge, enabled=pcfg.io_overlap) as sinks:
        for a, b in stream:
            sinks[0].append_run(lookup.lookup(b), a)


def redistribute_bucket(pcfg: PlainCfg, workdir: str, i: int, *,
                        ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                        transport: Optional[Transport] = None):
    """Paper Alg. 8-9: ship each relabeled edge to owner(new_src) through
    the transport."""
    B = pcfg.bucket_size
    store = BlockStore.attach(workdir, edges_store_name(i, 1), ledger, gauge=gauge)
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        outs = tr.channels(owned_store_name, pcfg.nb)
        partition_runs(store, outs, lambda a, b: a // B, tag_prefix=f"{i:03d}",
                       overlap=pcfg.io_overlap, device=pcfg.device)


def csr_bucket_sorted(pcfg: PlainCfg, workdir: str, i: int, *,
                      ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                      in_name: Optional[str] = None,
                      transport: Optional[Transport] = None) -> Tuple[str, str]:
    """§III-B7: external sort owned edges by src, then one sequential pass
    emits degrees + adjacency.  adjv streams straight into a memmap — the
    adjacency never materializes in RAM.  `in_name` overrides the input
    store (the sequential driver's owner stores are named differently)."""
    B, base = pcfg.bucket_size, i * pcfg.bucket_size
    if in_name is None:
        in_name = owned_store_name(i)
    key = csr_merge_key(pcfg)
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        owned = tr.drain_inbox(in_name)   # redistribute's multi-writer inbox
    tmp = BlockStore(workdir, in_name + "_sorted", ledger, gauge=gauge, fresh=True)
    sort_runs(owned, tmp, key=key, overlap=pcfg.io_overlap)
    degv = np.zeros(B, np.int64)
    if gauge is not None:
        gauge.track(B)
    adjv_path = csr_adjv_path(workdir, i)
    total = tmp.total_rows()
    adjv = np.lib.format.open_memmap(adjv_path, mode="w+", dtype=np.int64, shape=(total,))
    pos = 0
    for s, d in merge_runs(tmp, key=key, block_rows=pcfg.merge_block_rows,
                           max_fanin=pcfg.merge_fanin,
                           overlap=pcfg.io_overlap):
        np.add.at(degv, s - base, 1)
        adjv[pos : pos + d.size] = d
        ledger.write(d.nbytes)
        pos += d.size
    adjv.flush()
    del adjv
    offv = np.concatenate([[0], np.cumsum(degv)]).astype(np.int64)
    offv_path = csr_offv_path(workdir, i)
    np.save(offv_path, offv)
    ledger.write(offv.nbytes)
    tmp.destroy()
    return offv_path, adjv_path


def _emit_csr(pcfg: PlainCfg, workdir: str, i: int, stream, total: int, *,
              ledger: IOLedger, gauge: Optional[MemoryGauge]) -> Tuple[str, str]:
    """Shared CSR emit tail: one pass over a src-sorted (s, d) stream writes
    degrees + adjacency; adjv streams straight into a memmap (§III-B7)."""
    B, base = pcfg.bucket_size, i * pcfg.bucket_size
    degv = np.zeros(B, np.int64)
    if gauge is not None:
        gauge.track(B)
    adjv_path = csr_adjv_path(workdir, i)
    adjv = np.lib.format.open_memmap(adjv_path, mode="w+", dtype=np.int64,
                                     shape=(total,))
    pos = 0
    for s, d in stream:
        np.add.at(degv, s - base, 1)
        adjv[pos : pos + d.size] = d
        ledger.write(d.nbytes)
        pos += d.size
    adjv.flush()
    del adjv
    offv = np.concatenate([[0], np.cumsum(degv)]).astype(np.int64)
    offv_path = csr_offv_path(workdir, i)
    np.save(offv_path, offv)
    ledger.write(offv.nbytes)
    return offv_path, adjv_path


def csr_sort_bucket(pcfg: PlainCfg, workdir: str, i: int, *,
                    ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                    transport: Optional[Transport] = None) -> int:
    """Pooled-cascade CSR, phase 1 of 3: external-sort pass 1 over the owned
    inbox (each run sorted by src, rewritten).  Returns the run count — the
    driver plans the cascade levels from it, and the count rides the phase
    manifest so a resumed run plans identically."""
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        owned = tr.drain_inbox(owned_store_name(i))
    out = BlockStore(workdir, sorted_owned_store_name(i), ledger, gauge=gauge,
                     fresh=True)
    sort_runs(owned, out, key=csr_merge_key(pcfg), overlap=pcfg.io_overlap)
    return out.num_runs


def cascade_merge_bucket(pcfg: PlainCfg, workdir: str, i: int, base: str,
                         level: int, g: int, lo: int, hi: int, key=0, *,
                         ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                         transport: Optional[Transport] = None):
    """One GROUP of one cascade level, as a pool task (the "intermediate
    levels are embarrassingly parallel" upside): merge consecutive sorted
    segments [lo, hi) of `base`'s level-1 into the level-`level` group store.
    At level 0 a segment is one run of the `base` store; above that it is a
    whole previous-level group store (its runs back to back).  Stability +
    consecutive grouping keep the result bit-identical to merge_runs' inline
    cascade — and to the flat merge.  `key` is a wire-safe spec (an int
    column, or "csr" for the config-dependent CSR key) so the same task
    tuple serializes to JSON for cluster dispatch."""
    key = resolve_merge_key(pcfg, key)
    if level == 0:
        src = BlockStore.attach(workdir, base, ledger, gauge=gauge)
        segments = [(src, [k]) for k in range(lo, hi)]
    else:
        segments = []
        for k in range(lo, hi):
            s = BlockStore.attach(
                workdir, pooled_cascade_store_name(base, level - 1, k),
                ledger, gauge=gauge)
            segments.append((s, list(range(s.num_runs))))
    out = BlockStore(workdir, pooled_cascade_store_name(base, level, g),
                     ledger, gauge=gauge, fresh=True)
    with write_behind([out], ledger, gauge, enabled=pcfg.io_overlap) as sinks:
        for cols in merge_segments(segments, key=key,
                                   block_rows=pcfg.merge_block_rows,
                                   overlap=pcfg.io_overlap):
            sinks[0].append_run(*cols)


def csr_emit_bucket(pcfg: PlainCfg, workdir: str, i: int, src_name: str,
                    presorted: bool, *,
                    ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                    transport: Optional[Transport] = None) -> Tuple[str, str]:
    """Pooled-cascade CSR, final phase: emit offv/adjv from `src_name`.
    `presorted` means the store is one globally sorted segment (the cascade's
    last level) and is streamed; otherwise its runs are merged flat."""
    key = csr_merge_key(pcfg)
    src = BlockStore.attach(workdir, src_name, ledger, gauge=gauge)
    if presorted:
        stream = merge_segments([(src, list(range(src.num_runs)))], key=key,
                                block_rows=pcfg.merge_block_rows,
                                overlap=pcfg.io_overlap)
    else:
        stream = merge_runs(src, key=key, block_rows=pcfg.merge_block_rows,
                            max_fanin=pcfg.merge_fanin,
                            overlap=pcfg.io_overlap)
    return _emit_csr(pcfg, workdir, i, stream, src.total_rows(),
                     ledger=ledger, gauge=gauge)


def csr_bucket_scatter(pcfg: PlainCfg, workdir: str, i: int, *,
                       ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                       in_name: Optional[str] = None,
                       transport: Optional[Transport] = None) -> Tuple[str, str]:
    """Paper Alg. 10-11 under real process parallelism: unordered scan of the
    owned edges with a bounded associative map, flushed into a memmap'd adjv
    — every flush is a RANDOM write burst (the Fig. 2 blowup, now measurable
    per worker).  Emits the same csr_offv/csr_adjv files as the sorted
    variant; within-row adjacency is encounter order, which equals the
    sorted variant's stable order, so the FILES are bit-identical — only the
    I/O ledger (random vs sequential writes) differs."""
    if pcfg.perm_family == "feistel":
        # Under the feistel family the sorted variant orders adjacency by
        # (src, dst) — encounter order no longer matches it, so the
        # files-bit-identical contract between the CSR variants would break.
        raise ValueError(
            "csr 'scatter' emits adjacency in encounter order, which "
            "perm_family='feistel' does not preserve; use csr_variant="
            "'sorted'")
    B, base = pcfg.bucket_size, i * pcfg.bucket_size
    if in_name is None:
        in_name = owned_store_name(i)
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        owned = tr.drain_inbox(in_name)
    flush_at = max(16, pcfg.chunk_edges // 256)  # the paper's mmc analogue
    degv = np.zeros(B, np.int64)
    if gauge is not None:
        gauge.track(B)
    # Degree pass streams block-sized buffers, not whole runs: iter_runs
    # would load each run file entirely (read_run's documented whole-run
    # contract), spiking residency to the largest run instead of one chunk.
    for s, _ in owned.iter_blocks(pcfg.chunk_edges):
        np.add.at(degv, s - base, 1)
    offv = np.concatenate([[0], np.cumsum(degv)]).astype(np.int64)
    adjv_path = csr_adjv_path(workdir, i)
    adjv = np.lib.format.open_memmap(adjv_path, mode="w+", dtype=np.int64,
                                     shape=(int(offv[-1]),))
    cursor = np.zeros(B, np.int64)
    held_map: Dict[int, list] = {}
    held = 0

    def _flush():
        for v, lst in held_map.items():  # random write per vertex
            o = offv[v] + cursor[v]
            adjv[o : o + len(lst)] = lst
            cursor[v] += len(lst)
            ledger.write(8 * len(lst), sequential=False)

    for s, d in owned.iter_blocks(pcfg.chunk_edges):
        for sv, dv in zip((s - base).tolist(), d.tolist()):
            held_map.setdefault(sv, []).append(dv)
            held += 1
            if held >= flush_at:
                _flush()
                held_map, held = {}, 0
    _flush()
    adjv.flush()
    del adjv
    offv_path = csr_offv_path(workdir, i)
    np.save(offv_path, offv)
    ledger.write(offv.nbytes)
    return offv_path, adjv_path


# Checkpoint helpers shared by every driver-level phase whose manifest is
# just a completion mark (the filesystem is the real manifest).
_MARK = lambda _res: {"done": True}   # noqa: E731
_SKIP = lambda _m: None               # noqa: E731


def drive_shuffle(pcfg: PlainCfg, workdir: str, map_kernel,
                  orchestrator: Optional["PhaseOrchestrator"] = None,
                  transport: Optional[Transport] = None) -> None:
    """The shuffle round loop, shared by all drivers.  `map_kernel(name,
    argss)` runs one bucket kernel for every args tuple and acts as the
    barrier.  Receiver stores are multi-writer, so each round's outputs are
    cleaned BEFORE the senders run — a correctness invariant for BOTH
    transports (attach() would merge in stale runs from a previous attempt;
    a partial socket frame would linger as a `.part` stray).  The driver's
    `transport` carries the clean to whichever host owns each inbox.

    With `orchestrator` set (cluster mode), every clean and every round
    barrier is its OWN checkpointed phase.  The split matters for per-host
    resume: when a phase reruns because one host died mid-barrier, hosts
    that already completed it skip their kernels — so the clean must NOT
    rerun (it would delete the completed hosts' already-delivered runs),
    while the dead host's reruns are safe on the dirty inbox because run
    tags and contents are deterministic (idempotent overwrite)."""
    def step(name, fn):
        if orchestrator is None:
            return fn()
        return orchestrator.run_phase(name, fn, save=_MARK, load=_SKIP)

    if pcfg.perm_family == "feistel":
        # A recomputable permutation needs no shuffling to exist: one local
        # phase writes every pv bucket directly (zero exchange rounds, zero
        # wire bytes).  Kept under the "shuffle_init" phase name so ledger
        # reports line up across families.
        step("shuffle_init",
             lambda: map_kernel("pv_feistel", [(i,) for i in range(pcfg.nb)]))
        return

    with _exchange(pcfg, workdir, IOLedger(), None, transport) as tr:
        step("shuffle_init",
             lambda: map_kernel("init_pv", [(i,) for i in range(pcfg.nb)]))
        for r in range(pcfg.rounds):
            step(f"shuffle_clean_r{r}",
                 lambda r=r: tr.clean_inboxes(
                     [pv_store_name(r + 1, j) for j in range(pcfg.nb)]))
            step(f"shuffle_round_r{r}",
                 lambda r=r: map_kernel("shuffle_round",
                                        [(i, r) for i in range(pcfg.nb)]))


def pooled_cascade_levels(pcfg: PlainCfg, orch: "PhaseOrchestrator",
                          map_kernel, counts: Dict[int, int], base_of,
                          phase_prefix: str, key=0) -> Dict[int, Tuple[str, bool]]:
    """Dispatch a bounded-fan-in merge cascade's LEVELS through the worker
    pool / cluster — the shared core of the pooled CSR sort, the pooled
    relabel join, and the pooled walk hops (the "intermediate levels are
    embarrassingly parallel" upside, generalized).  `counts[i]` is the
    sorted-run count of `base_of(i)`; each level is one checkpointed barrier
    (`{phase_prefix}_cascade_l{level}`) whose tasks are that level's
    (bucket, group) merges, keyed by the wire-safe `key` spec.  Returns
    {i: (src_name, presorted)} for the consumer phase: the final cascade
    store (presorted) or the untouched base when it never cascaded.
    Stability + consecutive grouping keep the result bit-identical to the
    inline cascade and to the flat merge."""
    fanin = pcfg.merge_fanin
    seg = dict(counts)
    last_level: Dict[int, Optional[int]] = {i: None for i in seg}
    level = 0
    while fanin >= 2 and any(c > 1 for c in seg.values()):
        tasks, frees, plan = [], [], {}
        for i in sorted(seg):
            c = seg[i]
            if c <= 1:
                continue
            base = base_of(i)
            ng = -(-c // fanin)
            for g in range(ng):
                tasks.append((i, base, level, g, g * fanin,
                              min((g + 1) * fanin, c), key))
            plan[i] = ng
            # This level is the last consumer of its input segments.
            if level == 0:
                frees.append(base)
            else:
                frees += [pooled_cascade_store_name(base, level - 1, k)
                          for k in range(c)]
        orch.run_phase(
            f"{phase_prefix}_cascade_l{level}",
            lambda tasks=tasks: map_kernel("cascade_merge", tasks),
            save=_MARK, load=_SKIP, frees=frees)
        for i, ng in plan.items():
            seg[i] = ng
            last_level[i] = level
        level += 1
    out: Dict[int, Tuple[str, bool]] = {}
    for i in sorted(seg):
        if last_level[i] is None:
            # Never cascaded: <= 1 sorted run (stream) — or fanin == 0
            # (flat), where the consumer merges the runs inline.
            out[i] = (base_of(i), seg[i] <= 1)
        else:
            out[i] = (pooled_cascade_store_name(base_of(i), last_level[i], 0),
                      True)
    return out


# ---------------------------------------------------------------------------
# Out-of-core random walks (the redistribute phase re-run once per hop)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WalkCfg:
    """Picklable walk-corpus parameters (the walk twin of PlainCfg).

    Walk semantics are the data/walks.py contract: counter RNG keyed by
    (seed, walker_id, step), sink vertices teleport to rand % n, histories
    are int64.  `out_name` names the corpus: per-bucket shard files
    `{stem}_b{j}.npy` (each holding its walker block's rows of the logical
    [num_walkers, length + 1] corpus) plus the `{stem}_manifest.json` that
    ties them together (core/corpus.py)."""

    num_walkers: int
    length: int
    seed: int = 0
    out_name: str = "walks.npy"
    # Store-name prefix isolating this config's frontier/history stores when
    # several walk configs advance through ONE fused CSR scan per hop
    # (walk_hop_fused / drive_walks_fused — the job queue's batched-seeds
    # upside); "" is the classic un-prefixed single-config layout.
    ns: str = ""


def walker_block(wcfg: WalkCfg, nb: int, j: int) -> Tuple[int, int]:
    """Walker-id range [w0, w1) whose history bucket j collects (blocks of
    ceil(W/nb) ids; owner(w) = w // block)."""
    wpb = -(-wcfg.num_walkers // nb)
    return min(j * wpb, wcfg.num_walkers), min((j + 1) * wpb, wcfg.num_walkers)


def _gather_adjv(adjv_mm: np.ndarray, idx: np.ndarray, chunk: int,
                 ledger: IOLedger, gauge: MemoryGauge) -> np.ndarray:
    """adjv[idx] for idx sorted by CSR row (the frontier's sort order), read
    as a strictly-forward scan of <=chunk-row blocks.  Within one row walkers
    land at random offsets, but rows are nondecreasing, so every block load
    moves forward — sequential I/O, bounded memory, and all of it ledgered."""
    order = np.argsort(idx, kind="stable")
    si = idx[order]
    out = np.empty(idx.shape[0], np.int64)
    i = 0
    while i < si.size:
        lo = int(si[i])
        hi_ix = int(np.searchsorted(si, lo + chunk, side="left"))
        hi = int(si[hi_ix - 1]) + 1
        blk = np.asarray(adjv_mm[lo:hi], np.int64)
        ledger.read(blk.nbytes)
        gauge.track(blk.shape[0])
        out[order[i:hi_ix]] = blk[si[i:hi_ix] - lo]
        i = hi_ix
    return out


def walk_init_bucket(pcfg: PlainCfg, workdir: str, j: int, wcfg: WalkCfg, *,
                     ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                     transport: Optional[Transport] = None):
    """Launch bucket j's walker block: deterministic start vertices, step-0
    history rows, and the step-0 frontier exchange (partition_runs to the
    owner bucket of each start — paper Alg. 8 with walkers for edges)."""
    gauge = gauge if gauge is not None else MemoryGauge()
    B, chunk = pcfg.bucket_size, pcfg.chunk_edges
    w0, w1 = walker_block(wcfg, pcfg.nb, j)
    hist = BlockStore(workdir, whist_store_name(0, j, wcfg.ns), ledger,
                      columns=("wid", "step", "v"), gauge=gauge, fresh=True)
    adv = BlockStore(workdir, f"{wcfg.ns}wadv_init_b{j:03d}", ledger,
                     columns=("pos", "wid"), gauge=gauge, fresh=True)
    for lo in range(w0, w1, chunk):
        hi = min(lo + chunk, w1)
        wid = np.arange(lo, hi, dtype=np.int64)
        pos = walk_start_np(wcfg.seed, wid.astype(np.uint32), pcfg.n)
        hist.append_run(wid, np.zeros(wid.size, np.int64), pos)
        adv.append_run(pos, wid)
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        outs = tr.channels(lambda d: wfront_store_name(0, d, wcfg.ns), pcfg.nb,
                           columns=("pos", "wid"))
        partition_runs(adv, outs, lambda p, w: p // B, tag_prefix=f"{j:03d}",
                       overlap=pcfg.io_overlap, device=pcfg.device)
    adv.destroy()


def walk_hop_bucket(pcfg: PlainCfg, workdir: str, j: int, t: int, wcfg: WalkCfg, *,
                    ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                    transport: Optional[Transport] = None):
    """Advance every walker currently owned by bucket j one hop (step t+1).

    The paper's discipline applied to traversal: (i) external-sort the
    frontier inbox by current vertex, (ii) sort-merge-join it against the
    bucket's CSR — offv probed through two MonotoneLookups (row starts and
    row ends both advance monotonically), adjv gathered as a forward scan —
    and (iii) partition the advanced walkers through the transport to their
    new owner's step-t+1 inbox.  Every access is a bounded sequential block;
    no random CSR I/O.
    """
    gauge = gauge if gauge is not None else MemoryGauge()
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        front = tr.drain_inbox(wfront_store_name(t, j, wcfg.ns),
                               columns=("pos", "wid"))
        tmp = BlockStore(workdir, wfront_store_name(t, j, wcfg.ns) + "_sorted",
                         ledger, columns=("pos", "wid"), gauge=gauge, fresh=True)
        sort_runs(front, tmp, key=0, overlap=pcfg.io_overlap)
        stream = merge_runs(tmp, key=0, block_rows=pcfg.merge_block_rows,
                            max_fanin=pcfg.merge_fanin,
                            overlap=pcfg.io_overlap)
        _walk_advance(pcfg, workdir, j, t, wcfg, stream, tr,
                      ledger=ledger, gauge=gauge)
        tmp.destroy()


class _HopEmitter:
    """One walk config's sinks for one hop of bucket j: the step-t+1 history
    store and (unless this is the last hop) the advance store that gets
    partitioned to the next frontier.  `emit` consumes merged (pos, wid)
    chunks in nondecreasing pos order against CALLER-OWNED CSR cursors —
    which is what lets walk_hop_fused_bucket advance several configs through
    ONE shared scan of offv/adjv (one emitter per config, one cursor set)."""

    def __init__(self, pcfg: PlainCfg, workdir: str, j: int, t: int,
                 wcfg: WalkCfg, ledger: IOLedger, gauge: MemoryGauge):
        self.pcfg, self.wcfg, self.j, self.t = pcfg, wcfg, j, t
        self.base = j * pcfg.bucket_size
        self.ledger, self.gauge = ledger, gauge
        self.hist = BlockStore(workdir, whist_store_name(t + 1, j, wcfg.ns),
                               ledger, columns=("wid", "step", "v"),
                               gauge=gauge, fresh=True)
        self.adv = None
        if t + 1 < wcfg.length:
            self.adv = BlockStore(workdir,
                                  f"{wcfg.ns}wadv_s{t:04d}_b{j:03d}", ledger,
                                  columns=("pos", "wid"), gauge=gauge,
                                  fresh=True)

    def emit(self, pos: np.ndarray, wid: np.ndarray,
             lk_lo: MonotoneLookup, lk_hi: MonotoneLookup,
             adjv_mm: np.ndarray) -> None:
        pcfg, wcfg, t = self.pcfg, self.wcfg, self.t
        row = pos - self.base
        start = lk_lo.lookup(row)
        end = lk_hi.lookup(row + 1)
        deg = end - start
        r = walk_rand_np(wcfg.seed, wid.astype(np.uint32),
                         t + 1).astype(np.int64)
        sink = deg == 0
        idx = start + np.where(sink, 0, r % np.maximum(deg, 1))
        nxt = np.where(sink, r % pcfg.n, 0).astype(np.int64)
        live = ~sink
        if live.any():
            nxt[live] = _gather_adjv(adjv_mm, idx[live], pcfg.chunk_edges,
                                     self.ledger, self.gauge)
        self.hist.append_run(wid, np.full(wid.size, t + 1, np.int64), nxt)
        if self.adv is not None:
            self.adv.append_run(nxt, wid)

    def finish(self, tr: Transport) -> None:
        if self.adv is None:
            return
        pcfg, t, ns = self.pcfg, self.t, self.wcfg.ns
        outs = tr.channels(lambda d: wfront_store_name(t + 1, d, ns),
                           pcfg.nb, columns=("pos", "wid"))
        partition_runs(self.adv, outs,
                       lambda p, w: p // pcfg.bucket_size,
                       tag_prefix=f"{self.j:03d}",
                       overlap=pcfg.io_overlap, device=pcfg.device)
        self.adv.destroy()


def _csr_cursors(pcfg: PlainCfg, workdir: str, j: int, ledger: IOLedger,
                 gauge: MemoryGauge):
    """Bucket j's hop-join read state: two offv cursors + the adjv memmap.
    Two independent offv cursors, one per row end: a single interleaved
    probe stream (row, row+1, row', row'+1, ...) is NOT monotone when
    consecutive walkers share a vertex (5,6,5,6), so the 2x offv scan is
    the price of keeping each stream strictly nondecreasing."""
    offv_file = csr_offv_path(workdir, j)
    chunk = pcfg.chunk_edges
    lk_lo = MonotoneLookup([NpyColumnStore(offv_file, ledger, gauge)],
                           block_rows=chunk, gauge=gauge)
    lk_hi = MonotoneLookup([NpyColumnStore(offv_file, ledger, gauge)],
                           block_rows=chunk, gauge=gauge)
    adjv_mm = np.load(csr_adjv_path(workdir, j), mmap_mode="r")
    return lk_lo, lk_hi, adjv_mm


def _walk_advance(pcfg: PlainCfg, workdir: str, j: int, t: int, wcfg: WalkCfg,
                  stream, tr: Transport, *,
                  ledger: IOLedger, gauge: MemoryGauge):
    """The hop's join+advance tail, shared by walk_hop_bucket (inline sort)
    and walk_hop_join_bucket (pooled cascade): sort-merge-join the
    vertex-sorted frontier `stream` against bucket j's CSR, emit step-t+1
    history rows, and partition the advanced walkers to their new owners."""
    lk_lo, lk_hi, adjv_mm = _csr_cursors(pcfg, workdir, j, ledger, gauge)
    em = _HopEmitter(pcfg, workdir, j, t, wcfg, ledger, gauge)
    for pos, wid in stream:
        em.emit(pos, wid, lk_lo, lk_hi, adjv_mm)
    em.finish(tr)


def walk_hop_fused_bucket(pcfg: PlainCfg, workdir: str, j: int, t: int,
                          wcfgs: Sequence[WalkCfg], *,
                          ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                          transport: Optional[Transport] = None):
    """Advance SEVERAL independent walk configs (different seeds/widths,
    same length, distinct ns prefixes) one hop through bucket j with ONE
    scan of the bucket's CSR — the fused-walk upside: hop phases for different
    corpora are independent, so their sorted frontiers k-way merge at chunk
    granularity into a single globally nondecreasing pos stream that shares
    one pair of offv MonotoneLookup cursors and one adjv memmap.

    Per config the outputs (history rows, next frontier frames) are
    bit-identical to running walk_hop_bucket alone: each config keeps its
    own _HopEmitter (own RNG stream, own ns-prefixed stores), and the merge
    only decides the interleaving — which the corpus gather erases by
    sorting on the unique wid*(L+1)+step key."""
    gauge = gauge if gauge is not None else MemoryGauge()
    wcfgs = list(wcfgs)
    if len({w.ns for w in wcfgs}) != len(wcfgs):
        raise ValueError("walk_hop_fused_bucket: walk configs must carry "
                         "distinct ns prefixes")
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        tmps, heads = [], []
        for w in wcfgs:
            front = tr.drain_inbox(wfront_store_name(t, j, w.ns),
                                   columns=("pos", "wid"))
            tmp = BlockStore(workdir,
                             wfront_store_name(t, j, w.ns) + "_sorted",
                             ledger, columns=("pos", "wid"), gauge=gauge,
                             fresh=True)
            sort_runs(front, tmp, key=0, overlap=pcfg.io_overlap)
            tmps.append(tmp)
            stream = merge_runs(tmp, key=0, block_rows=pcfg.merge_block_rows,
                                max_fanin=pcfg.merge_fanin,
                                overlap=pcfg.io_overlap)
            # head = [stream, pos_chunk, wid_chunk, offset] or None (drained)
            try:
                pos, wid = next(stream)
                heads.append([stream, pos, wid, 0])
            except StopIteration:
                heads.append(None)
        lk_lo, lk_hi, adjv_mm = _csr_cursors(pcfg, workdir, j, ledger, gauge)
        ems = [_HopEmitter(pcfg, workdir, j, t, w, ledger, gauge)
               for w in wcfgs]
        while True:
            live = [s for s, h in enumerate(heads) if h is not None]
            if not live:
                break
            # Chunk-level k-way merge: pick the stream whose head value is
            # minimal (ties to the lowest stream id), then emit its longest
            # head-chunk prefix that stays below every OTHER live head —
            # `<= other` when we win the tie (other id higher), `< other`
            # when the other would (id lower).  The chosen head's first
            # value always qualifies, so every round makes progress, and
            # the concatenated emits are globally nondecreasing in pos —
            # exactly the monotonicity the shared cursors need.
            s_star = min(live,
                         key=lambda s: (int(heads[s][1][heads[s][3]]), s))
            stream, pos, wid, off = heads[s_star]
            cut = None
            for o in live:
                if o == s_star:
                    continue
                bound = int(heads[o][1][heads[o][3]]) + (1 if o > s_star else 0)
                cut = bound if cut is None else min(cut, bound)
            hi = pos.size if cut is None else int(
                np.searchsorted(pos[off:], cut, side="left")) + off
            ems[s_star].emit(pos[off:hi], wid[off:hi], lk_lo, lk_hi, adjv_mm)
            if hi < pos.size:
                heads[s_star][3] = hi
            else:
                try:
                    npos, nwid = next(stream)
                    heads[s_star] = [stream, npos, nwid, 0]
                except StopIteration:
                    heads[s_star] = None
        for em, tmp in zip(ems, tmps):
            em.finish(tr)
            tmp.destroy()


def walk_hop_sort_bucket(pcfg: PlainCfg, workdir: str, j: int, t: int,
                         wcfg: WalkCfg, *,
                         ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                         transport: Optional[Transport] = None) -> int:
    """Pooled-cascade walk hop, phase 1 of 3: sort pass over bucket j's
    step-t frontier inbox.  Returns the run count for the cascade plan."""
    gauge = gauge if gauge is not None else MemoryGauge()
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        front = tr.drain_inbox(wfront_store_name(t, j, wcfg.ns),
                               columns=("pos", "wid"))
    out = BlockStore(workdir, wfront_store_name(t, j, wcfg.ns) + "_sorted",
                     ledger, columns=("pos", "wid"), gauge=gauge, fresh=True)
    sort_runs(front, out, key=0, overlap=pcfg.io_overlap)
    return out.num_runs


def walk_hop_join_bucket(pcfg: PlainCfg, workdir: str, j: int, t: int,
                         src_name: str, presorted: bool, wcfg: WalkCfg, *,
                         ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                         transport: Optional[Transport] = None):
    """Pooled-cascade walk hop, final phase: advance from `src_name` (the
    cascade's last level when `presorted`, else a flat bounded merge).
    `wcfg` stays the LAST positional arg — the cluster wire protocol
    extracts and re-appends WalkCfg there."""
    gauge = gauge if gauge is not None else MemoryGauge()
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        src = BlockStore.attach(workdir, src_name, ledger,
                                columns=("pos", "wid"), gauge=gauge)
        if presorted:
            stream = merge_segments([(src, list(range(src.num_runs)))], key=0,
                                    block_rows=pcfg.merge_block_rows,
                                    overlap=pcfg.io_overlap)
        else:
            stream = merge_runs(src, key=0, block_rows=pcfg.merge_block_rows,
                                max_fanin=pcfg.merge_fanin,
                                overlap=pcfg.io_overlap)
        _walk_advance(pcfg, workdir, j, t, wcfg, stream, tr,
                      ledger=ledger, gauge=gauge)


def walk_hist_scatter_bucket(pcfg: PlainCfg, workdir: str, j: int, wcfg: WalkCfg, *,
                             ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                             transport: Optional[Transport] = None):
    """Collect phase, scatter half: ship every history row bucket j emitted
    through the transport to the walker-block owner of its walker id."""
    gauge = gauge if gauge is not None else MemoryGauge()
    wpb = -(-wcfg.num_walkers // pcfg.nb)
    with _exchange(pcfg, workdir, ledger, gauge, transport) as tr:
        outs = tr.channels(lambda d: whist_inbox_name(d, wcfg.ns), pcfg.nb,
                           columns=("wid", "step", "v"))
        for s in range(wcfg.length + 1):
            src = BlockStore.attach(workdir, whist_store_name(s, j, wcfg.ns),
                                    ledger, columns=("wid", "step", "v"),
                                    gauge=gauge)
            partition_runs(src, outs, lambda w, st, v: w // wpb,
                           tag_prefix=f"{j:03d}_{s:04d}",
                           overlap=pcfg.io_overlap, device=pcfg.device)


def walk_hist_gather_bucket(pcfg: PlainCfg, workdir: str, j: int, wcfg: WalkCfg, *,
                            ledger: IOLedger, gauge: Optional[MemoryGauge] = None,
                            transport: Optional[Transport] = None) -> str:
    """Collect phase, join half — SHARDED: external-sort bucket j's inbox by
    the flat key wid*(L+1)+step; the merged stream covers exactly the walker
    block's cells once each, so writing it out is one sequential pass over
    bucket j's OWN corpus shard (`{out}_b{j}.npy`, rows [w0, w1) of the
    corpus).  No workdir ever holds the full corpus — on a cluster each
    host keeps only its buckets' shards, and the driver's manifest
    (core/corpus.py) is the only global artifact."""
    gauge = gauge if gauge is not None else MemoryGauge()
    L = wcfg.length
    w0, w1 = walker_block(wcfg, pcfg.nb, j)
    shard_path = os.path.join(workdir, corpus_shard_name(wcfg.out_name, j))

    def key(w, s, v):
        return w * (L + 1) + s

    with _exchange(pcfg, workdir, ledger, gauge, transport) as _tr:
        inbox = _tr.drain_inbox(whist_inbox_name(j, wcfg.ns),
                                columns=("wid", "step", "v"))
    if w1 == w0:
        # Degenerate walker block (W < nb): an empty, valid shard.
        np.save(shard_path, np.zeros((0, L + 1), np.int64))
        return shard_path
    tmp = BlockStore(workdir, whist_inbox_name(j, wcfg.ns) + "_sorted", ledger,
                     columns=("wid", "step", "v"), gauge=gauge, fresh=True)
    sort_runs(inbox, tmp, key=key, overlap=pcfg.io_overlap)
    out = np.lib.format.open_memmap(shard_path, mode="w+", dtype=np.int64,
                                    shape=(w1 - w0, L + 1))
    flat = out.reshape(-1)
    base = w0 * (L + 1)
    for w, s, v in merge_runs(tmp, key=key, block_rows=pcfg.merge_block_rows,
                              max_fanin=pcfg.merge_fanin,
                              overlap=pcfg.io_overlap):
        flat[w * (L + 1) + s - base] = v
        ledger.write(v.nbytes)
    out.flush()
    del out
    tmp.destroy()
    return shard_path


def drive_walks(pcfg: PlainCfg, workdir: str, wcfg: WalkCfg, map_kernel,
                orchestrator: "PhaseOrchestrator",
                transport: Optional[Transport] = None,
                shard_dir_of=None, shard_host_of=None,
                fine_phases: bool = False) -> str:
    """The walk phase loop, shared by the inline driver (data/walks.py's
    external_walks), PartitionedGenerator.walk_corpus, and the cluster
    runtime.  `map_kernel` is the barrier, exactly as in drive_shuffle.
    Requires the csr_sorted phase outputs (csr_offv_*/csr_adjv_* bucket
    files) in each bucket owner's `workdir`.  Returns the path of the corpus
    MANIFEST (core/corpus.py); the corpus itself stays as per-bucket shard
    files written by the gather kernels — `shard_dir_of(j)` /
    `shard_host_of(j)` tell the manifest where bucket j's shard landed
    (default: this driver's workdir / host 0).

    Resume discipline: each phase pre-cleans its own multi-writer outputs
    through the driver's `transport` (stale runs AND partial frames from a
    crashed attempt, on whichever host owns the inbox) and the PREVIOUS
    phase's consumed frontier — inputs are never destroyed by the phase that
    reads them, so a phase can always be rerun after a mid-phase crash.
    With `fine_phases` (cluster mode) every clean is ITS OWN checkpointed
    phase, for the reason drive_shuffle documents: a rerun with per-host
    task skipping must not re-clean inboxes completed hosts already filled.
    walk_gc reclaims everything once the corpus shards are on disk.
    """
    nb, L = pcfg.nb, wcfg.length
    orch = orchestrator
    mark, skip = _MARK, _SKIP
    shard_dir_of = shard_dir_of if shard_dir_of is not None else (
        lambda j: workdir)
    shard_host_of = shard_host_of if shard_host_of is not None else (
        lambda j: 0)

    def phase(name, clean_fn, map_fn):
        """One barrier with its pre-senders clean: a single phase normally,
        split into `{name}_clean` + `{name}` under fine_phases."""
        if fine_phases:
            orch.run_phase(f"{name}_clean", clean_fn, save=mark, load=skip)
            orch.run_phase(name, map_fn, save=mark, load=skip)
        else:
            orch.run_phase(name, lambda: (clean_fn(), map_fn()),
                           save=mark, load=skip)

    with _exchange(pcfg, workdir, IOLedger(), None, transport) as tr:
        phase("walk_init",
              lambda: tr.clean_inboxes(
                  [wfront_store_name(0, d, wcfg.ns) for d in range(nb)]),
              lambda: map_kernel("walk_init", [(j, wcfg) for j in range(nb)]))
        for t in range(L):
            def _clean(t=t):
                if t > 0:
                    # Reclaim the PREVIOUS hop's consumed frontier (GC, not
                    # correctness: hop t-1 drained it already).
                    tr.clean_inboxes(
                        [wfront_store_name(t - 1, d, wcfg.ns)
                         for d in range(nb)])
                tr.clean_inboxes(
                    [wfront_store_name(t + 1, d, wcfg.ns) for d in range(nb)])

            if not pcfg.pooled_cascade:
                phase(f"walk_hop_{t:04d}", _clean,
                      lambda t=t: map_kernel("walk_hop",
                                             [(j, t, wcfg) for j in range(nb)]))
                continue
            # Pooled-cascade hop: sort barrier, cascade levels as (bucket,
            # group) pool tasks, then the join+advance barrier — the walk
            # twin of the pooled CSR sort.  Every step is its own
            # checkpointed phase (the clean separately, for the per-host
            # resume reason drive_shuffle documents).
            orch.run_phase(f"walk_hop_{t:04d}_clean", _clean,
                           save=mark, load=skip)
            counts = orch.run_phase(
                f"walk_sort_{t:04d}",
                lambda t=t: [int(c) for c in map_kernel(
                    "walk_hop_sort", [(j, t, wcfg) for j in range(nb)])],
                save=lambda r: {"counts": list(r)},
                load=lambda m: [int(c) for c in m["counts"]])
            srcs = pooled_cascade_levels(
                pcfg, orch, map_kernel, {j: counts[j] for j in range(nb)},
                lambda j, t=t: wfront_store_name(t, j, wcfg.ns) + "_sorted",
                f"walk_{t:04d}", key=0)
            orch.run_phase(
                f"walk_hop_{t:04d}",
                lambda t=t, srcs=srcs: map_kernel(
                    "walk_hop_join",
                    [(j, t, srcs[j][0], srcs[j][1], wcfg) for j in range(nb)]),
                save=mark, load=skip,
                frees=[srcs[j][0] for j in range(nb)])

        def _collect():
            map_kernel("walk_hist_scatter", [(j, wcfg) for j in range(nb)])
            map_kernel("walk_hist_gather", [(j, wcfg) for j in range(nb)])

        phase("walk_collect",
              lambda: tr.clean_inboxes([whist_inbox_name(d, wcfg.ns)
                                        for d in range(nb)]),
              _collect)

        manifest_path = os.path.join(workdir,
                                     corpus_manifest_name(wcfg.out_name))

        def _manifest():
            shards = []
            for j in range(nb):
                w0, w1 = walker_block(wcfg, nb, j)
                shards.append({
                    "bucket": j, "w0": w0, "w1": w1,
                    "host": shard_host_of(j),
                    "path": os.path.join(shard_dir_of(j),
                                         corpus_shard_name(wcfg.out_name, j)),
                })
            write_manifest(manifest_path, wcfg.num_walkers, L, shards)

        orch.run_phase("walk_manifest", _manifest, save=mark, load=skip)

        def _gc():
            # keep_all is the same debugging escape hatch _apply_frees
            # honors: the walk intermediates (frontiers, history stores)
            # stay on disk for inspection.
            if orch.keep_all:
                return
            names = []
            for d in range(nb):
                for t in range(L + 1):
                    names.append(wfront_store_name(t, d, wcfg.ns))
                    names.append(whist_store_name(t, d, wcfg.ns))
                names.append(whist_inbox_name(d, wcfg.ns))
            tr.clean_inboxes(names)

        orch.run_phase("walk_gc", _gc, save=mark, load=skip)
    return manifest_path


def drive_walks_fused(pcfg: PlainCfg, workdir: str, wcfgs: Sequence[WalkCfg],
                      map_kernel, orchestrator: "PhaseOrchestrator",
                      transport: Optional[Transport] = None,
                      shard_dir_of=None, shard_host_of=None,
                      fine_phases: bool = False) -> List[str]:
    """drive_walks for SEVERAL independent corpora at once: init/collect
    barriers batch all configs, and each hop is one walk_hop_fused barrier
    whose bucket tasks merge every config's frontier through a single CSR
    scan (the fused-walk upside — k corpora pay one offv/adjv pass per
    hop instead of k).  Configs must share `length` (hops are lockstep) and
    carry distinct, NONEMPTY ns prefixes plus distinct out_names; hops use
    the inline-sort variant (pooled_cascade does not apply here).  Returns
    the manifest path per config, in input order; each corpus is
    bit-identical to its own drive_walks run."""
    nb = pcfg.nb
    wcfgs = list(wcfgs)
    if not wcfgs:
        raise ValueError("drive_walks_fused: no walk configs")
    L = wcfgs[0].length
    if any(w.length != L for w in wcfgs):
        raise ValueError("drive_walks_fused: configs must share length "
                         f"(got {[w.length for w in wcfgs]})")
    if any(not w.ns for w in wcfgs) or len({w.ns for w in wcfgs}) != len(wcfgs):
        raise ValueError("drive_walks_fused: configs need distinct nonempty "
                         "ns prefixes")
    if len({w.out_name for w in wcfgs}) != len(wcfgs):
        raise ValueError("drive_walks_fused: configs need distinct out_names")
    orch = orchestrator
    mark, skip = _MARK, _SKIP
    shard_dir_of = shard_dir_of if shard_dir_of is not None else (
        lambda j: workdir)
    shard_host_of = shard_host_of if shard_host_of is not None else (
        lambda j: 0)

    def phase(name, clean_fn, map_fn):
        if fine_phases:
            orch.run_phase(f"{name}_clean", clean_fn, save=mark, load=skip)
            orch.run_phase(name, map_fn, save=mark, load=skip)
        else:
            orch.run_phase(name, lambda: (clean_fn(), map_fn()),
                           save=mark, load=skip)

    with _exchange(pcfg, workdir, IOLedger(), None, transport) as tr:
        phase("walk_init",
              lambda: tr.clean_inboxes(
                  [wfront_store_name(0, d, w.ns)
                   for w in wcfgs for d in range(nb)]),
              lambda: map_kernel("walk_init",
                                 [(j, w) for w in wcfgs for j in range(nb)]))
        for t in range(L):
            def _clean(t=t):
                if t > 0:
                    tr.clean_inboxes(
                        [wfront_store_name(t - 1, d, w.ns)
                         for w in wcfgs for d in range(nb)])
                tr.clean_inboxes(
                    [wfront_store_name(t + 1, d, w.ns)
                     for w in wcfgs for d in range(nb)])

            phase(f"walk_hop_{t:04d}", _clean,
                  lambda t=t: map_kernel(
                      "walk_hop_fused",
                      [(j, t, wcfgs) for j in range(nb)]))

        def _collect():
            map_kernel("walk_hist_scatter",
                       [(j, w) for w in wcfgs for j in range(nb)])
            map_kernel("walk_hist_gather",
                       [(j, w) for w in wcfgs for j in range(nb)])

        phase("walk_collect",
              lambda: tr.clean_inboxes(
                  [whist_inbox_name(d, w.ns)
                   for w in wcfgs for d in range(nb)]),
              _collect)

        paths = [os.path.join(workdir, corpus_manifest_name(w.out_name))
                 for w in wcfgs]

        def _manifests():
            for w, path in zip(wcfgs, paths):
                shards = []
                for j in range(nb):
                    w0, w1 = walker_block(w, nb, j)
                    shards.append({
                        "bucket": j, "w0": w0, "w1": w1,
                        "host": shard_host_of(j),
                        "path": os.path.join(
                            shard_dir_of(j),
                            corpus_shard_name(w.out_name, j)),
                    })
                write_manifest(path, w.num_walkers, L, shards)

        orch.run_phase("walk_manifest", _manifests, save=mark, load=skip)

        def _gc():
            if orch.keep_all:
                return
            names = []
            for w in wcfgs:
                for d in range(nb):
                    for t in range(L + 1):
                        names.append(wfront_store_name(t, d, w.ns))
                        names.append(whist_store_name(t, d, w.ns))
                    names.append(whist_inbox_name(d, w.ns))
            tr.clean_inboxes(names)

        orch.run_phase("walk_gc", _gc, save=mark, load=skip)
    return paths


# ---------------------------------------------------------------------------
# PhaseOrchestrator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PhaseRecord:
    name: str
    status: str                      # "done" | "resumed"
    seconds: float
    ledger_delta: Dict[str, int]


class PhaseOrchestrator:
    """Runs named phases with per-phase ledger deltas and checkpoint/resume.

    With `checkpoint=True`, each completed phase's `save()` payload (e.g.
    BlockStore manifests) is persisted to `<workdir>/phases.json`; a new
    orchestrator over the same workdir replays completed phases through
    `load()` instead of recomputing them — intermediate stores are reused
    in place, so resume does (almost) no I/O.
    """

    def __init__(self, workdir: str, ledger: IOLedger, checkpoint: bool = False,
                 config_key: Optional[str] = None, state_name: str = "phases.json",
                 keep_all: bool = False, sweep: bool = True,
                 cleaner: Optional[Callable[[Sequence[str]], None]] = None,
                 stats: Optional[TransportStats] = None):
        # `state_name` separates checkpoint namespaces sharing one workdir
        # (the walk pipeline resumes independently of the generation pipeline
        # whose CSR it reads — see drive_walks).
        # `sweep=False` skips the stray-file sweeps below — for callers that
        # already swept at a moment when no exchange could be mid-frame (the
        # cluster HostRunner sweeps before its ExchangeServer starts
        # accepting; sweeping here would race a live receive's `.part`).
        # `cleaner` overrides how freed stores are removed (default: local
        # clean_store); it receives the whole frees list in ONE call so a
        # transport-backed cleaner (the cluster controller routing frees to
        # whichever host owns each store) can batch names per CLEAN frame
        # instead of paying one RPC round per store.
        # `stats` (optional) is a live TransportStats the driver keeps
        # aggregated across its barriers (e.g. PartitionedGenerator's
        # exchange_stats); when provided, every phase record also carries a
        # `wire_`-prefixed delta of it — per-phase WIRE bytes next to the
        # per-phase disk bytes, which is what lets benchmarks and tests
        # assert "the recompute shuffle moved zero exchange bytes" per phase.
        self.workdir = workdir
        self.ledger = ledger
        self.checkpoint = checkpoint
        self._cleaner = cleaner
        self._stats = stats
        # Checkpoint GC: run_phase(frees=[...]) names stores whose LAST
        # consumer is that phase; once the phase is done (and, when
        # checkpointing, its manifest is durably on disk) they are dropped,
        # bounding the workdir to ~the live frontier of the pipeline instead
        # of every intermediate ever written.  keep_all=True is the debugging
        # escape hatch that retains everything.
        self.keep_all = keep_all
        self.records: List[PhaseRecord] = []
        self._state_path = os.path.join(workdir, state_name)
        self._config_key = config_key
        self._completed: Dict[str, Dict] = {}
        # Cascade intermediate stores are merge-private scratch: a crash mid
        # merge leaves them behind, and they are never part of any phase's
        # checkpointed manifest — sweep them before resuming so a resumed run
        # starts from exactly the stores the manifests describe.  Partial
        # exchange frames (`.part`, a receive killed mid-frame) are the same
        # kind of stray for the socket transport — swept with them.  (Pooled
        # cascade stores — `__pcas_l` — are NOT swept: those are checkpointed
        # phase outputs, not kernel scratch.)
        if sweep:
            clean_cascade_stores(workdir)
            sweep_partial_frames(workdir)
        if checkpoint and os.path.exists(self._state_path):
            try:
                with open(self._state_path) as f:
                    state = json.load(f)
            except (json.JSONDecodeError, OSError):
                # A torn/corrupt state file is exactly the crash this feature
                # recovers from — fall back to recomputing everything.
                state = {}
            # A checkpoint taken under a different config describes a
            # DIFFERENT graph — resuming from it would be silent corruption
            # (e.g. same workdir, new seed).  Invalidate wholesale.
            if config_key is not None and state.get("__config__") != config_key:
                state = {}
            self._completed = {k: v for k, v in state.items() if k != "__config__"}

    def run_phase(
        self,
        name: str,
        fn: Callable[[], object],
        save: Optional[Callable[[object], Dict]] = None,
        load: Optional[Callable[[Dict], object]] = None,
        frees: Sequence[str] = (),
    ):
        """`frees` names stores this phase is the LAST consumer of; they are
        removed once the phase completes — strictly AFTER the checkpoint
        write, so a crash between completion and checkpoint still leaves the
        rerun its inputs.  A resumed phase re-applies its frees (idempotent),
        covering a crash between checkpoint write and GC."""
        if self.checkpoint and load is not None and name in self._completed:
            result = load(self._completed[name])
            self.records.append(PhaseRecord(name, "resumed", 0.0,
                                            {k: 0 for k in self.ledger.as_dict()
                                             } | {k: 0 for k in self._wire_dict()}))
            self._apply_frees(frees)
            return result
        snap = self.ledger.snapshot()
        wire_snap = self._wire_dict()
        t_wall = time.time()
        t0 = time.perf_counter()
        result = fn()
        seconds = time.perf_counter() - t0
        delta = self.ledger.delta_since(snap)
        delta.update({k: v - wire_snap[k]
                      for k, v in self._wire_dict().items()})
        self.records.append(PhaseRecord(name, "done", seconds, delta))
        # Phase spans are emitted on the DONE path only: a resumed phase did
        # no work in this run, so it contributes no span — which is exactly
        # what makes a kill+resume trace free of duplicate phase spans.
        tracer = get_tracer()
        if tracer.enabled:
            tracer.event(name, "phase", t_wall, seconds,
                         args={k: v for k, v in delta.items() if v} or None)
        # Every phase also refreshes the process-wide unified snapshot (the
        # ledger/stats here are cumulative, so latest-wins is correct) —
        # this is what benchmarks/run.py harvests into BENCH json.
        GLOBAL_METRICS.update(
            "orchestrator", unified_snapshot(ledger=self.ledger,
                                             stats=self._stats))
        if self.checkpoint and save is not None:
            self._completed[name] = save(result)
            state = dict(self._completed)
            if self._config_key is not None:
                state["__config__"] = self._config_key
            tmp = self._state_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, self._state_path)  # atomic: never a torn state file
        self._apply_frees(frees)
        return result

    def _wire_dict(self) -> Dict[str, int]:
        if self._stats is None:
            return {}
        return {f"wire_{k}": v
                for k, v in dataclasses.asdict(self._stats).items()}

    def completed(self, name: str) -> bool:
        """Whether a checkpointed run of phase `name` exists (the cluster
        HostRunner peeks before submitting work to its local pool)."""
        return self.checkpoint and name in self._completed

    def _apply_frees(self, frees: Sequence[str]) -> None:
        if self.keep_all or not frees:
            return
        if self._cleaner is not None:
            self._cleaner(list(frees))
            return
        for name in frees:
            clean_store(self.workdir, name)

    def delta(self, name: str) -> Dict[str, int]:
        """Ledger delta of the most recent run of phase `name`."""
        for rec in reversed(self.records):
            if rec.name == name:
                return rec.ledger_delta
        raise KeyError(name)

    def report(self) -> List[Dict]:
        return [
            {"phase": r.name, "status": r.status, "seconds": round(r.seconds, 4),
             **r.ledger_delta}
            for r in self.records
        ]


# ---------------------------------------------------------------------------
# PartitionedGenerator: nb workers, one vertex range each
# ---------------------------------------------------------------------------

def _traced_kernel(name: str, fn):
    """Span instrumentation for one registered kernel.  Wrapping at
    _KERNELS registration covers every dispatch path with one change —
    the inline driver (StreamingGenerator._run_kernels_inline), the
    process pool, and the cluster HostRunner all resolve kernels through
    this dict.  The span carries the kernel's bucket and its private
    ledger's nonzero counter deltas; with tracing disabled the cost is one
    attribute check.  The `traced_kernel` attribute is the CI lint's
    checkable witness (trace.lint_kernel_coverage)."""

    @functools.wraps(fn)
    def wrapper(pcfg, workdir, *args, ledger=None, gauge=None,
                transport=None):
        tracer = get_tracer()
        if not tracer.enabled:
            return fn(pcfg, workdir, *args, ledger=ledger, gauge=gauge,
                      transport=transport)
        snap = ledger.snapshot() if ledger is not None else None
        t_wall = time.time()
        t0 = time.perf_counter()
        out = fn(pcfg, workdir, *args, ledger=ledger, gauge=gauge,
                 transport=transport)
        span_args: Dict = {}
        if args and isinstance(args[0], int):
            span_args["bucket"] = args[0]
        if snap is not None:
            span_args.update({k: v for k, v in
                              ledger.delta_since(snap).items() if v})
        tracer.event(name, "kernel", t_wall, time.perf_counter() - t0,
                     args=span_args or None)
        return out

    wrapper.traced_kernel = name
    return wrapper


_KERNELS = {
    "init_pv": init_pv_bucket,
    "shuffle_round": shuffle_bucket_round,
    "pv_feistel": materialize_pv_bucket,
    "generate": generate_bucket_edges,
    "relabel_scatter": relabel_scatter_bucket,
    "relabel_apply": relabel_apply_bucket,
    "relabel_sort": relabel_sort_bucket,
    "relabel_join": relabel_join_bucket,
    "relabel_recompute": relabel_recompute_bucket,
    "gen_relabel_recompute": gen_relabel_recompute_bucket,
    "redistribute": redistribute_bucket,
    "csr_sorted": csr_bucket_sorted,
    "csr_sort": csr_sort_bucket,
    "cascade_merge": cascade_merge_bucket,
    "csr_emit": csr_emit_bucket,
    "csr_scatter": csr_bucket_scatter,
    "walk_init": walk_init_bucket,
    "walk_hop": walk_hop_bucket,
    "walk_hop_fused": walk_hop_fused_bucket,
    "walk_hop_sort": walk_hop_sort_bucket,
    "walk_hop_join": walk_hop_join_bucket,
    "walk_hist_scatter": walk_hist_scatter_bucket,
    "walk_hist_gather": walk_hist_gather_bucket,
}
_KERNELS = {name: _traced_kernel(name, fn) for name, fn in _KERNELS.items()}


# Process-local transport reuse: pool workers persist across barriers, so a
# socket transport (and its per-peer TCP connections) is built once per
# (workdir, peers) and rebound to each task's private ledger/gauge instead
# of paying connect/teardown on every kernel invocation — O(phases * nb)
# churn otherwise.  Evicted (and closed) if a kernel dies, so a poisoned
# connection never leaks into the next task.
_TRANSPORT_CACHE: Dict[Tuple, Transport] = {}


def _run_kernel(task):
    """Worker entry point: run one bucket kernel with a private ledger/gauge
    and the process-cached transport, and ship the accounting (including
    sender-side exchange stats — transports hold sockets and cannot cross
    the process boundary themselves — and the kernel launches the task
    made) back to the parent."""
    kernel, pcfg, workdir, args = task
    launched = dict(build.LAUNCHES)
    # Pool workers are fresh (spawned) processes: the first traced task
    # installs this process's tracer under the task's workdir.  Idempotent,
    # strictly no-op (no directory created) when the job isn't tracing.
    maybe_install_tracer(workdir, enabled=getattr(pcfg, "trace", False))
    ledger = IOLedger()
    # budget_rows lets merge cursors derive refill blocks from the chunk
    # budget (MemoryGauge.cursor_rows) so deep cascades stay under one
    # chunk even when prefetch doubles residency.
    gauge = MemoryGauge(budget_rows=pcfg.chunk_edges)
    # exchange_namespace is part of the identity: two jobs sharing one host
    # workdir must not reuse each other's (differently-namespaced) channels.
    key = (workdir, pcfg.transport, pcfg.peer_addrs,
           getattr(pcfg, "exchange_namespace", None),
           getattr(pcfg, "shard_map_version", 0))
    tr = _TRANSPORT_CACHE.get(key)
    if tr is None:
        tr = _TRANSPORT_CACHE[key] = make_transport(pcfg, workdir, ledger, gauge)
    else:
        tr.rebind(ledger, gauge)
    try:
        out = _KERNELS[kernel](pcfg, workdir, *args, ledger=ledger,
                               gauge=gauge, transport=tr)
    except BaseException:
        _TRANSPORT_CACHE.pop(key, None)
        tr.close()
        raise
    if args and isinstance(args[0], int):
        # Kernel-side skew attribution: bucket kernels take their bucket
        # index as the first positional arg (the store-naming convention's
        # dispatch twin), so the task's whole I/O bill lands in that
        # bucket's per-bucket counters — the rebalancer's load signal.
        ledger.bucket(args[0], ledger.bytes_read + ledger.bytes_written,
                      ledger.rows_written)
    launched = {k: v - launched[k] for k, v in build.LAUNCHES.items()
                if v != launched[k]}
    return (out, ledger.as_dict(), gauge.peak_rows, dataclasses.asdict(tr.stats),
            launched)


def task_key(namespace: str, kernel: str, wire_args: Sequence,
             ns: str = "") -> str:
    """The canonical task identity the cluster checkpoints under — shared
    by ClusterController.run_tasks (live dispatch) and phase_task_plan
    (static export) so the two can never drift.  `wire_args` are the
    JSON-safe positional args (WalkCfg already extracted); `ns` is the walk
    config's store prefix, appended only when nonempty so fused multi-corpus
    barriers (same j, same kernel, different seeds) stay distinct while
    every pre-existing key is unchanged."""
    key = f"{namespace}:{kernel}:" + ":".join(str(a) for a in wire_args)
    if ns:
        key += f":{ns}"
    return key


def phase_task_plan(pcfg: PlainCfg, csr_variant: str = "sorted",
                    walks: Sequence[Tuple[int, int, int, str]] = (),
                    gen_namespace: str = "gen",
                    fuse_gen_relabel: bool = False,
                    fuse_walks: bool = False) -> List[Dict]:
    """Static export of the per-phase task-key decomposition a cluster run
    of this config dispatches — the job queue's DAG source: the scheduler
    calls this ONCE at submit time to know every barrier, every task key
    inside it, and the dependency edges between barriers, without running
    anything.  Returns ordered [{"phase", "kernel", "keys", "deps"}];
    `deps` name earlier phases (barriers), keys match task_key()/run_tasks
    exactly.  Driver-side cleans are not tasks and do not appear.  Walk
    corpora (one (num_walkers, length, seed, out_name) tuple each) chain
    after the CSR phase and are mutually independent — unless `fuse_walks`,
    in which case all of them (equal lengths required) advance through ONE
    walk_hop_fused barrier per hop, the shape walk_corpus_fused dispatches.
    pooled_cascade plans are data-dependent (cascade level counts come from
    sort output) and raise ValueError."""
    if pcfg.pooled_cascade:
        raise ValueError(
            "phase_task_plan: pooled_cascade merge levels are data-dependent "
            "(level count derives from sorted-run counts at runtime) — no "
            "static task plan exists; submit with pooled_cascade=False")
    if csr_variant not in ("sorted", "scatter"):
        raise ValueError(f"csr_variant must be 'sorted' or 'scatter', "
                         f"got {csr_variant!r}")
    nb = pcfg.nb
    plan: List[Dict] = []

    def add(phase, kernel, argss, deps):
        plan.append({
            "phase": phase, "kernel": kernel,
            "keys": [task_key(gen_namespace if not phase.startswith("walk")
                              else deps_ns, kernel, args) for args in argss],
            "deps": list(deps),
        })
        return phase

    deps_ns = gen_namespace
    buckets = [(i,) for i in range(nb)]
    if pcfg.shuffle_variant == "recompute":
        if fuse_gen_relabel:
            last = add("gen_relabel", "gen_relabel_recompute", buckets, [])
        else:
            last = add("generate", "generate", buckets, [])
            last = add("relabel_recompute", "relabel_recompute", buckets,
                       [last])
    else:
        if fuse_gen_relabel:
            raise ValueError("fuse_gen_relabel requires "
                             "shuffle_variant='recompute'")
        if pcfg.perm_family == "feistel":
            last = add("shuffle_init", "pv_feistel", buckets, [])
        else:
            last = add("shuffle_init", "init_pv", buckets, [])
            for r in range(pcfg.rounds):
                last = add(f"shuffle_round_r{r}", "shuffle_round",
                           [(i, r) for i in range(nb)], [last])
        shuffle_done = last
        last = add("generate", "generate", buckets, [])
        for p in (0, 1):
            last = add(f"relabel_scatter_p{p}", "relabel_scatter",
                       [(i, p) for i in range(nb)],
                       [last, shuffle_done] if p == 0 else [last])
            last = add(f"relabel_apply_p{p}", "relabel_apply",
                       [(i, p) for i in range(nb)], [last])
        last = add("redistribute", "redistribute", buckets, [last])
    csr_kernel = "csr_scatter" if csr_variant == "scatter" else "csr_sorted"
    csr_phase = add("csr_scatter" if csr_variant == "scatter" else
                    "csr_sorted", csr_kernel, buckets, [last])
    if fuse_walks and walks:
        lengths = {L for (_, L, _, _) in walks}
        if len(lengths) != 1:
            raise ValueError(f"fuse_walks requires equal lengths, "
                             f"got {sorted(lengths)}")
        (L,) = lengths
        # Matches ClusterGenerator.walk_corpus_fused dispatch exactly: one
        # shared namespace, per-config ns suffixes w{k}_ on init/collect
        # keys, ns-free keys on the fused hop (the WalkCfg list is not a
        # wire arg).
        deps_ns = "walkf:" + ";".join(
            f"{w}:{l}:{s}:{o}" for (w, l, s, o) in walks)
        nss = [f"w{k}_" for k in range(len(walks))]
        per_cfg = [(i, ns) for ns in nss for i in range(nb)]

        def add_fused(phase, kernel, keys, deps):
            plan.append({"phase": phase, "kernel": kernel,
                         "keys": keys, "deps": list(deps)})
            return phase

        last = add_fused(
            "walk_init", "walk_init",
            [task_key(deps_ns, "walk_init", (i,), ns=ns)
             for i, ns in per_cfg], [csr_phase])
        for t in range(L):
            last = add_fused(
                f"walk_hop_{t:04d}", "walk_hop_fused",
                [task_key(deps_ns, "walk_hop_fused", (j, t))
                 for j in range(nb)], [last])
        last = add_fused(
            "walk_hist_scatter", "walk_hist_scatter",
            [task_key(deps_ns, "walk_hist_scatter", (i,), ns=ns)
             for i, ns in per_cfg], [last])
        add_fused(
            "walk_hist_gather", "walk_hist_gather",
            [task_key(deps_ns, "walk_hist_gather", (i,), ns=ns)
             for i, ns in per_cfg], [last])
        return plan
    for (W, L, seed, out_name) in walks:
        deps_ns = f"walk:{W}:{L}:{seed}:{out_name}"
        wtag = deps_ns.replace(":", "_")
        last = add(f"walk_init[{wtag}]", "walk_init", buckets, [csr_phase])
        for t in range(L):
            last = add(f"walk_hop_{t:04d}[{wtag}]", "walk_hop",
                       [(j, t) for j in range(nb)], [last])
        last = add(f"walk_hist_scatter[{wtag}]", "walk_hist_scatter",
                   buckets, [last])
        add(f"walk_hist_gather[{wtag}]", "walk_hist_gather", buckets, [last])
    return plan


class PartitionedGenerator:
    """Multi-process out-of-core generator: the paper's cluster on one host.

    nb workers (a `concurrent.futures` pool over a spawn context — safe with
    a CUDA context in the parent), each owning vertex range [i*B, (i+1)*B).
    Every worker runs its hooks on `device` (one CUDA context per worker);
    the kernel libraries are built in the parent before the pool starts,
    so workers only load them.
    The bucket exchanges that MPI would carry ride the configured Transport:
    the shared filesystem (cfg.transport="fs") or framed TCP to
    ExchangeServers ("socket") — with socket and no explicit peer_addrs, the
    driver starts `exchange_servers` loopback servers and workers rendezvous
    with them; with explicit peer_addrs each address may live on another
    host, which is the multi-host deployment shape.  Phases are
    bulk-synchronous: scatter kernels for every bucket complete (barrier)
    before any join kernel starts, exactly the paper's structure, and a send
    is acked only once durable at the receiver — so the barrier doubles as
    the exchange flush.

    `max_workers=0` runs the same kernels in-process (the sequential
    debugging mode); the stores, and therefore the result, are identical —
    across worker counts AND across transports.

    `checkpoint=True` makes every phase resumable (state in
    <workdir>/phases.json): a killed run — even one killed mid-exchange —
    replays unfinished phases from the senders' still-checkpointed input
    stores, after the pre-senders inbox sweep clears stale runs and partial
    frames.  Unless `keep_all` (default: cfg.keep_phase_stores), each
    phase's stores are dropped once every downstream consumer is
    done/checkpointed, bounding the disk footprint.
    """

    def __init__(self, cfg, workdir: str, max_workers: Optional[int] = None,
                 checkpoint: bool = False, keep_all: Optional[bool] = None,
                 exchange_servers: int = 1, device="cuda"):
        pcfg = validate_external_shape(
            dataclasses.replace(cfg, device=str(resolve_device(device)))
            if isinstance(cfg, PlainCfg) else plain_config(cfg, device))
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        maybe_install_tracer(workdir, enabled=pcfg.trace)
        self.ledger = IOLedger()
        self.gauge = MemoryGauge(budget_rows=pcfg.chunk_edges)
        self._servers: List[ExchangeServer] = []
        self.exchange_stats = TransportStats()
        if pcfg.transport == "socket" and pcfg.peer_addrs is None:
            ns = max(1, min(int(exchange_servers), pcfg.nb))
            self._servers = [ExchangeServer(workdir) for _ in range(ns)]
            pcfg = dataclasses.replace(
                pcfg, peer_addrs=tuple(self._servers[j % ns].addr
                                       for j in range(pcfg.nb)))
        self.pcfg = pcfg
        self.transport = make_transport(pcfg, workdir, self.ledger, self.gauge)
        if max_workers is None:
            max_workers = min(self.pcfg.nb, os.cpu_count() or 1)
        self.max_workers = max_workers
        self._pool: Optional[ProcessPoolExecutor] = None
        if keep_all is None:
            keep_all = bool(getattr(cfg, "keep_phase_stores", False))
        self.keep_all = keep_all
        self.orchestrator = PhaseOrchestrator(
            workdir, self.ledger, checkpoint=checkpoint,
            config_key=repr(("partitioned", result_config_key(self.pcfg))),
            keep_all=keep_all, stats=self.exchange_stats)

    def _shutdown_pool(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def close(self):
        self._shutdown_pool()
        self.transport.close()
        # In-process mode (max_workers=0) populates the worker transport
        # cache in THIS process; drop those entries so their connections
        # don't dangle into stopped servers.
        for key in [k for k in _TRANSPORT_CACHE if k[0] == self.workdir]:
            _TRANSPORT_CACHE.pop(key).close()
        self._drain_servers()
        for srv in self._servers:
            srv.stop()
        self._servers = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _drain_servers(self):
        """Fold receiver-side accounting (disk writes, frame peaks, wire
        bytes) into the driver's ledger/gauge/stats — called at every barrier
        so per-phase ledger deltas include the receive half of the exchange."""
        for srv in self._servers:
            self.exchange_stats.add(srv.drain_accounting(self.ledger, self.gauge))

    # -- the barrier ----------------------------------------------------------
    # Fine-grained phase mode: False here (the outer named phases — shuffle,
    # relabel, ... — are the checkpoint unit, today's behavior); the cluster
    # generator flips it so every clean and every kernel barrier checkpoints
    # separately, which is what makes per-HOST resume sound (see
    # drive_shuffle's docstring).
    _fine_phases = False
    # Corpus shard placement hooks (drive_walks): None = all shards in this
    # driver's workdir, owned by "host 0".  The cluster generator maps each
    # bucket to its owner host's workdir.
    _shard_dir_of = None
    _shard_host_of = None
    # Fuse generate+relabel into gen_relabel_recompute (recompute variant
    # only): the raw-edge store is never written, so the task reads and
    # writes NOTHING locally — the job-queue scheduler marks such tasks
    # stealable and migrates them freely between hosts.
    _fuse_gen_relabel = False

    def _submit(self, kernel: str, tasks: Sequence[Tuple]) -> List:
        """Execution strategy: run bucket-kernel tasks to completion and
        return their (out, ledger dict, peak rows, transport stats) tuples.
        Overridden by the cluster generator to dispatch through HostRunners."""
        if self.max_workers == 0:
            return [_run_kernel(t) for t in tasks]
        if self._pool is None:
            if self.pcfg.device.startswith("cuda"):
                build.library()   # nvcc here, once; workers only load the .so
            # One persistent pool for the whole run: workers pay their
            # interpreter/import startup once, not once per barrier.
            self._pool = ProcessPoolExecutor(
                max_workers=self.max_workers, mp_context=get_context("spawn"))
        return list(self._pool.map(_run_kernel, tasks))

    def _map(self, kernel: str, argss: Sequence[Tuple]) -> List:
        tasks = [(kernel, self.pcfg, self.workdir, args) for args in argss]
        results = self._submit(kernel, tasks)
        outs = []
        for out, ldict, peak, sdict, launched in results:
            self.ledger.merge(ldict)
            self.gauge.track(peak)
            self.exchange_stats.add(TransportStats(**sdict))
            if self.max_workers:
                build.add_worker_launches(launched)
            outs.append(out)
        self._drain_servers()
        return outs

    # -- phase-granularity helpers --------------------------------------------
    def _outer(self, name: str, fn, frees: Sequence[str] = ()):
        """A coarse driver phase.  In fine mode the inner steps checkpoint
        themselves, so only the GC declaration (when any) needs its own
        phase — the frees still run exactly once per completion."""
        if self._fine_phases:
            out = fn()
            if frees:
                self.orchestrator.run_phase(f"{name}_gc", lambda: None,
                                            save=_MARK, load=_SKIP, frees=frees)
            return out
        return self.orchestrator.run_phase(name, fn, save=_MARK, load=_SKIP,
                                           frees=frees)

    def _step(self, name: str, fn):
        """An inner step (one clean or one kernel barrier): checkpointed on
        its own in fine mode, a plain call otherwise."""
        if self._fine_phases:
            return self.orchestrator.run_phase(name, fn, save=_MARK, load=_SKIP)
        return fn()

    def _maybe_rebalance(self, tag: str) -> None:
        """Shard-map rebalance hook, called at phase barriers (before the
        CSR phase and before each walk drive).  A single-host partitioned
        run has one workdir and nothing to move — the cluster generator
        overrides this with the plan/migrate/commit micro-phases."""

    # -- phases ----------------------------------------------------------------
    def _shuffle(self):
        drive_shuffle(self.pcfg, self.workdir, self._map,
                      orchestrator=(self.orchestrator if self._fine_phases
                                    else None),
                      transport=self.transport)

    def _relabel(self):
        nb = self.pcfg.nb
        for p in (0, 1):
            self._step(f"relabel_clean_p{p}",
                       lambda p=p: self.transport.clean_inboxes(
                           [relabel_inbox_name(p, j) for j in range(nb)]))
            self._step(f"relabel_scatter_p{p}",
                       lambda p=p: self._map("relabel_scatter",
                                             [(i, p) for i in range(nb)]))
            self._step(f"relabel_apply_p{p}",
                       lambda p=p: self._map("relabel_apply",
                                             [(i, p) for i in range(nb)]))

    def _relabel_pooled(self):
        """The relabel join with its external sort's cascade merge LEVELS
        dispatched through the worker pool / cluster (the csr pooled-cascade
        treatment applied to relabel, per pass): scatter, then a counts-
        returning sort barrier, then one barrier per cascade level, then the
        sort-merge-join against pv.  Bit-identical to _relabel."""
        nb = self.pcfg.nb
        orch = self.orchestrator
        for p in (0, 1):
            orch.run_phase(
                f"relabel_clean_p{p}",
                lambda p=p: self.transport.clean_inboxes(
                    [relabel_inbox_name(p, j) for j in range(nb)]),
                save=_MARK, load=_SKIP)
            # Scatter is the last consumer of its input edge stores.
            orch.run_phase(
                f"relabel_scatter_p{p}",
                lambda p=p: self._map("relabel_scatter",
                                      [(i, p) for i in range(nb)]),
                save=_MARK, load=_SKIP,
                frees=[edges_store_name(i) if p == 0 else edges_store_name(i, 0)
                       for i in range(nb)])
            counts = orch.run_phase(
                f"relabel_sort_p{p}",
                lambda p=p: [int(c) for c in
                             self._map("relabel_sort",
                                       [(i, p) for i in range(nb)])],
                save=lambda r: {"counts": list(r)},
                load=lambda m: [int(c) for c in m["counts"]],
                frees=[relabel_inbox_name(p, j) for j in range(nb)])
            srcs = pooled_cascade_levels(
                self.pcfg, orch, self._map, {i: counts[i] for i in range(nb)},
                lambda i, p=p: relabel_inbox_name(p, i) + "_sorted",
                f"relabel_p{p}", key=1)
            orch.run_phase(
                f"relabel_join_p{p}",
                lambda p=p, srcs=srcs: self._map(
                    "relabel_join",
                    [(i, p, srcs[i][0], srcs[i][1]) for i in range(nb)]),
                save=_MARK, load=_SKIP,
                frees=[srcs[i][0] for i in range(nb)])

    def _relabel_recompute(self):
        """shuffle_variant='recompute': the single scan+exchange that
        replaces relabel (both passes) AND redistribute — endpoints are
        relabeled by hash evaluation in-stream (see
        relabel_recompute_bucket)."""
        nb = self.pcfg.nb
        self._step("relabel_recompute_clean",
                   lambda: self.transport.clean_inboxes(
                       [owned_store_name(j) for j in range(nb)]))
        return self._step("relabel_recompute_map",
                          lambda: self._map("relabel_recompute",
                                            [(i,) for i in range(nb)]))

    def _gen_relabel_fused(self):
        """shuffle_variant='recompute' with _fuse_gen_relabel: generate and
        relabel in ONE kernel per bucket, regenerating edges from the RNG
        (see gen_relabel_recompute_bucket) — no raw-edge store, no frees."""
        nb = self.pcfg.nb
        self._step("gen_relabel_clean",
                   lambda: self.transport.clean_inboxes(
                       [owned_store_name(j) for j in range(nb)]))
        return self._step("gen_relabel_map",
                          lambda: self._map("gen_relabel_recompute",
                                            [(i,) for i in range(nb)]))

    def _redistribute(self):
        nb = self.pcfg.nb
        self._step("redistribute_clean",
                   lambda: self.transport.clean_inboxes(
                       [owned_store_name(j) for j in range(nb)]))
        return self._step("redistribute_map",
                          lambda: self._map("redistribute",
                                            [(i,) for i in range(nb)]))

    # -- CSR variants -----------------------------------------------------------
    def _csr_dir(self, i: int) -> str:
        """Directory holding bucket i's CSR files (host workdir on a cluster)."""
        return self.workdir

    def _save_csr(self, paths):
        return {"paths": [[os.path.basename(o), os.path.basename(a)]
                          for o, a in paths]}

    def _load_csr(self, m):
        return [(os.path.join(self._csr_dir(i), o),
                 os.path.join(self._csr_dir(i), a))
                for i, (o, a) in enumerate(m["paths"])]

    def _run_csr_sorted_pooled(self, nb: int):
        """§III-B7 CSR with the cascade's intermediate merge levels dispatched
        through the worker pool / cluster (the "embarrassingly parallel"
        upside): sort pass as one barrier, then one barrier per cascade
        LEVEL whose tasks are the (bucket, group) merges of that level, then
        a streaming emit.  Bit-identical to the inline cascade and to the
        flat merge (stable merge + consecutive groups)."""
        orch = self.orchestrator
        counts = orch.run_phase(
            "csr_sort",
            lambda: [int(c) for c in self._map("csr_sort",
                                               [(i,) for i in range(nb)])],
            save=lambda r: {"counts": list(r)},
            load=lambda m: [int(c) for c in m["counts"]],
            frees=[owned_store_name(j) for j in range(nb)])
        srcs = pooled_cascade_levels(
            self.pcfg, orch, self._map, {i: counts[i] for i in range(nb)},
            sorted_owned_store_name, "csr", key="csr")
        emit_tasks = [(i, srcs[i][0], srcs[i][1]) for i in range(nb)]
        emit_frees = [srcs[i][0] for i in range(nb)]
        return orch.run_phase(
            "csr_emit", lambda: self._map("csr_emit", emit_tasks),
            save=self._save_csr, load=self._load_csr, frees=emit_frees)

    def _run_csr_scatter(self, nb: int):
        """Paper Alg. 10/11 under real process parallelism (the partitioned
        scatter-CSR): same files as 'sorted', random-write I/O ledger."""
        orch = self.orchestrator
        if not self.keep_all and any(orch.completed(p)
                                     for p in ("csr_sorted", "csr_sort",
                                               "csr_emit")):
            # A checkpointed sorted run already freed the redistribute
            # outputs this variant needs — fail with guidance, not with an
            # empty inbox silently producing an empty graph.
            raise ValueError(
                "csr_variant='scatter' needs the redistribute output stores, "
                "but a checkpointed sorted-CSR phase already garbage-"
                "collected them; rerun with keep_phase_stores=True or a "
                "fresh workdir")
        return orch.run_phase(
            "csr_scatter",
            lambda: self._map("csr_scatter", [(i,) for i in range(nb)]),
            save=self._save_csr, load=self._load_csr,
            frees=[owned_store_name(j) for j in range(nb)])

    # -- driver ----------------------------------------------------------------
    def _run_phases(self, csr_variant: str = "sorted") -> List[Tuple[str, str]]:
        """All generation phases through the orchestrator; returns the
        per-bucket (offv_path, adjv_path) list WITHOUT loading the CSR —
        the cluster driver stops here and writes a manifest instead."""
        if csr_variant not in ("sorted", "scatter"):
            raise ValueError(
                f"partitioned csr_variant must be 'sorted' or 'scatter', "
                f"got {csr_variant!r}")
        nb = self.pcfg.nb
        if self.pcfg.shuffle_variant == "recompute":
            # Communication-free path: no shuffle (the permutation is a
            # hash family, not a store), and relabel+redistribute collapse
            # into one scan+exchange.
            if self._fuse_gen_relabel:
                # Further fusion: generate never materializes either — the
                # relabel scan regenerates its input (bit-identical inboxes,
                # zero local state, stealable tasks).
                self._outer("gen_relabel", self._gen_relabel_fused)
            else:
                self.orchestrator.run_phase(
                    "generate",
                    lambda: self._map("generate", [(i,) for i in range(nb)]),
                    save=_MARK, load=_SKIP)
                self._outer("relabel_recompute", self._relabel_recompute,
                            frees=[edges_store_name(i) for i in range(nb)])
        else:
            self._outer("shuffle", self._shuffle)
            self.orchestrator.run_phase(
                "generate",
                lambda: self._map("generate", [(i,) for i in range(nb)]),
                save=_MARK, load=_SKIP)
            # GC declarations: each store list's LAST consumer is the naming
            # phase.  pv buckets are never freed here — they ARE the
            # partitioned driver's permutation output (pv_buckets()).
            if self.pcfg.pooled_cascade:
                self._relabel_pooled()
            else:
                self._outer("relabel", self._relabel,
                            frees=[edges_store_name(i) for i in range(nb)]
                                  + [edges_store_name(i, 0) for i in range(nb)])
            self._outer("redistribute", self._redistribute,
                        frees=[edges_store_name(i, 1) for i in range(nb)])
        # Phase barrier: bucket loads are now known (per-bucket ledger
        # counters) and no exchange is in flight — the one legal point to
        # rewrite the shard map before the CSR phase reads the buckets.
        self._maybe_rebalance("csr")
        if csr_variant == "scatter":
            paths = self._run_csr_scatter(nb)
        elif self.pcfg.pooled_cascade:
            paths = self._run_csr_sorted_pooled(nb)
        else:
            paths = self.orchestrator.run_phase(
                "csr_sorted",
                lambda: self._map("csr_sorted", [(i,) for i in range(nb)]),
                save=self._save_csr, load=self._load_csr,
                frees=[owned_store_name(j) for j in range(nb)])
        # Normalize to driver-resolvable paths (kernel returns are host-local
        # on a cluster; basename + _csr_dir is the shared convention).
        return [(os.path.join(self._csr_dir(i), os.path.basename(o)),
                 os.path.join(self._csr_dir(i), os.path.basename(a)))
                for i, (o, a) in enumerate(paths)]

    def run(self, csr_variant: str = "sorted"):
        """Returns ([(offv, adjv_memmap)] per bucket, aggregate IOLedger)."""
        paths = self._run_phases(csr_variant)
        self._shutdown_pool()
        csr = [load_bucket_csr(offv_path, adjv_path, self.ledger, self.gauge)
               for offv_path, adjv_path in paths]
        return csr, self.ledger

    def pv_buckets(self) -> List[BlockStore]:
        if self.pcfg.shuffle_variant == "recompute":
            raise ValueError(
                "shuffle_variant='recompute' materializes no pv stores — "
                "the permutation is recomputable: evaluate "
                "hostgen.graph_perm_np(seed, ids, n) (or its inverse) "
                "instead of reading bucket files")
        return attach_pv_buckets(self.pcfg, self.workdir, self.ledger, self.gauge)

    def walk_corpus(self, num_walkers: int, length: int, seed: int = 0,
                    out_name: str = "walks.npy",
                    checkpoint: bool = False) -> ShardedWalks:
        """Out-of-core walk corpus [num_walkers, length+1] over this
        generator's CSR bucket files — the walk-frontier exchange running
        through the same worker pool and the same Transport (filesystem
        `{sender}_{seq}` runs or framed TCP) as generation.  Requires run()
        to have completed (the CSR phase writes the bucket files the hops
        join against).  Returns a ShardedWalks view over the per-bucket
        shard files + manifest (the sharded collect: no monolithic corpus
        file exists).  Bit-identical to data/walks.host_walks on the
        assembled CSR, whichever transport carried the frontiers."""
        wcfg = WalkCfg(num_walkers=num_walkers, length=length, seed=seed,
                       out_name=out_name)
        self._maybe_rebalance(f"walk_{out_name}")
        orch = PhaseOrchestrator(self.workdir, self.ledger, checkpoint=checkpoint,
                                 state_name="walk_phases.json",
                                 config_key=repr((result_config_key(self.pcfg), wcfg)),
                                 keep_all=self.keep_all,
                                 stats=self.exchange_stats)
        path = drive_walks(self.pcfg, self.workdir, wcfg, self._map, orch,
                           transport=self.transport,
                           shard_dir_of=self._shard_dir_of,
                           shard_host_of=self._shard_host_of,
                           fine_phases=self._fine_phases)
        return ShardedWalks(path)

    def walk_corpus_fused(self, specs: Sequence[Tuple[int, int, int, str]],
                          checkpoint: bool = False) -> List[ShardedWalks]:
        """Several corpora in one pass: `specs` is a list of
        (num_walkers, length, seed, out_name) tuples — all lengths equal —
        and every hop advances ALL of them through one CSR scan per bucket
        (drive_walks_fused / walk_hop_fused_bucket).  Each returned corpus
        is bit-identical to the corresponding walk_corpus() call; the k
        configs share the offv/adjv read instead of each paying it."""
        wcfgs = [WalkCfg(num_walkers=w, length=l, seed=s, out_name=o,
                         ns=f"w{k}_")
                 for k, (w, l, s, o) in enumerate(specs)]
        self._maybe_rebalance(
            "walkf_" + "_".join(w.out_name for w in wcfgs))
        orch = PhaseOrchestrator(
            self.workdir, self.ledger, checkpoint=checkpoint,
            state_name="walk_fused_phases.json",
            config_key=repr((result_config_key(self.pcfg), tuple(wcfgs))),
            keep_all=self.keep_all, stats=self.exchange_stats)
        paths = drive_walks_fused(self.pcfg, self.workdir, wcfgs, self._map,
                                  orch, transport=self.transport,
                                  shard_dir_of=self._shard_dir_of,
                                  shard_host_of=self._shard_host_of,
                                  fine_phases=self._fine_phases)
        return [ShardedWalks(p) for p in paths]
