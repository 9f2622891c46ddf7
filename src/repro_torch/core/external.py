"""Out-of-core (external memory) generation path — the paper's SSD tier
(twin of `repro.core.external`; the per-chunk hot loops run on the driver's
`device` through `core/chunks.py`).

The device pipeline (pipeline.py) is the TPU adaptation; this module is the
*literal* external-memory system, rebuilt as three layers:

  storage        core/blockstore.py — BlockStore (typed multi-column runs),
                 external sort (sort_runs + merge_runs over block-buffered
                 cursors), bounded bucket partitioning (partition_runs), and
                 the MonotoneLookup sort-merge-join cursor.  Every byte moved
                 is charged to an IOLedger (sequential vs random, the
                 paper's cost unit); every buffer materialized is reported
                 to a MemoryGauge so tests can *assert* bounded memory.
  phases         core/phases.py — bucket-level phase kernels addressed by
                 store naming convention, the PhaseOrchestrator (named,
                 resumable phases with per-phase ledger deltas), and the
                 multi-process PartitionedGenerator.
  driver         StreamingGenerator (this file) — runs the five phases in
                 one process through the orchestrator.

Phase algebra and I/O complexity (paper Alg. 2-11, §III-B):

  shuffle       "device": pv via the on-device shuffle, spilled to bucket
                files — fast, but holds pv in RAM: the §IV-A "artificial
                limitation on the shuffle" the paper calls out.
                "external": paper Alg. 2-4 ON DISK — pv is built as nb
                bucket files via log_nb(n) rounds of {external sort by
                counter-hash key, positional slice exchange}.  Peak RSS is
                O(chunk_edges) at ANY scale, all I/O sequential.
                "recompute": communication-free (Funke et al.'s hash-derived
                permutation) — pv is the keyed invertible Feistel family
                (hostgen.graph_perm_np), evaluated wherever a label is
                needed.  ZERO shuffle phases: no pv store, no shuffle-round
                I/O, no exchange bytes.  The permutation's cost moves from
                the I/O column to the compute column: O(1) mix32 rounds per
                evaluation, charged to ledger.hash_evals.
  generate      O(b*f / C_e) sequential writes          (Alg. 5)
  relabel       O(2*b*f*S(int) / C_e) sequential        (Alg. 6-7): edges
                external-sorted by the key field, pv *runs* streamed past
                them (MonotoneLookup) — a sort-merge-join against bucket
                files, never a memmapped monolith.
                "recompute": the two relabel passes AND redistribute fuse
                into ONE O(b*f / C_e) sequential scan that maps
                u -> perm(u) in-stream (2 hash evals per edge, 0 exchange
                bytes beyond the owner exchange below): both external sorts,
                both scatter exchanges and the pv join vanish.
  redistribute  O(B*f / C_e) sequential                 (Alg. 8-9)
  csr_scatter   O(b) RANDOM                             (Alg. 10-11 — the Fig. 2 blowup)
  csr_sorted    O(B / C_e) sequential                   (§III-B7 — the predicted fix)

Measured via (core/trace.py — every cost term above is attributable on a
real timeline, not only predicted; run with cfg.trace=True, merge with
`python -m repro.launch.cluster trace`, load in Perfetto):

  term          measured via
  ------------  ---------------------------------------------------------
  shuffle       "phase"-cat spans "shuffle" / per-round shuffle phases;
                ledger seq_read/seq_write bytes in the span args.
                "recompute": no spans at all — its cost is ledger.hash_evals.
  generate      "kernel"-cat span "generate" (or the fused
                "gen_relabel_recompute"); ledger rows/bytes written.
  relabel       "kernel" spans "relabel_sort"/"relabel_join"; "io"-cat spans
                "sort:<store>" / "merge:<store>" for each external sort pass.
  redistribute  "kernel" span "redistribute"; "io" span "partition:<store>".
  csr_scatter   "kernel" span "csr_scatter"; ledger rand_write counter —
                the Fig. 2 blowup shows up as dur with few bytes/sec.
  csr_sorted    "kernel" spans "csr_sort"/"csr_emit"; "io" spans
                "sort:csr*" + "merge:csr*".
  exchange E_x  "wire"-cat spans "send:<store>" / instants "recv:<store>";
                TransportStats bytes_sent/bytes_recv in unified_snapshot.
  migration     "wire" span "migrate:<relpath>"; TransportStats migrate_bytes.
  overlap       "stall"-cat spans "read_stall"/"write_stall" (>= 1 ms only);
                full totals in ledger read_wait_s/write_wait_s/overlap_s.
  barriers      "ctrl"-cat spans "barrier:<kernel>" on the controller lane;
                per-task "task_report" instants carry host + seconds.

Phase wall times are the "phase"-cat spans — one per completed
orchestrator phase, args = the nonzero ledger delta for that phase (the
same rows orchestrator.report() prints).

Network-exchange term (core/transport.py): every bucket exchange above
(shuffle slice exchange, relabel scatter, redistribute, per-hop walk-frontier
exchange) moves E_x exchanged bytes through the configured Transport:

  transport="fs"      O(2 * E_x / C_e) interconnect transfers — on a shared
                      (network) filesystem every exchanged byte crosses the
                      wire twice: sender -> shared store, then shared store
                      -> receiver at drain time.  The reference backend, and
                      exact on one host where "interconnect" is the disk.
  transport="socket"  O(E_x / C_e) framed-TCP transfers + one O(E_x / C_e)
                      sequential local write at the receiver — bytes cross
                      the wire once (the paper's MPI shape: exchange overlaps
                      the receiver's sequential disk I/O), acked per frame so
                      the in-flight window is one writer-bounded run and the
                      O(chunk_edges) memory bound holds end to end.  Output
                      bytes are identical either way; only the motion differs.

Multi-host sharded-collect term (core/cluster.py + core/corpus.py): on an
H-host cluster the walk-history collect writes each bucket's corpus shard on
its OWNER host — O(W*(L+1)*S(int) / C_e) sequential writes in total, but at
most a 1/H bucket-balanced share of them on any single host's disk, and ZERO
corpus bytes on the controller (it writes only the O(nb)-entry manifest).
The single-workdir alternative would add one full O(corpus / C_e) network
copy to gather the shards onto one host; the sharded collect deletes that
term — training streams per-batch rows from the shard files where they lie
(data/loader.ExternalWalkLoader over the manifest).  The same placement
holds for the graph itself: bucket CSR files live only on their owner host.

Multi-job scheduling term (core/jobqueue.py over core/cluster.py): a drain
of J concurrent jobs adds ONLY control-plane bytes — per host-poll one
lease of up to lease_size tasks and one report per task, each a
header-only control frame of O(100) bytes; steals ride the same poll
frames, so lease/steal control traffic is O((T/lease_size + T) * 100 B)
for T total tasks across all jobs, a vanishing term next to any E_x.
Data-bearing tasks never migrate (placement stays with the bucket owner's
disk); only communication-free recompute tasks are stealable, and a steal
moves ZERO input bytes — the thief regenerates from (cfg, bucket) alone.
What the queue buys is the OVERLAP FACTOR, serial_makespan /
queued_makespan >= 1: while one job's barrier waits on a straggler the
fleet runs other jobs' sequential I/O and exchanges, so fleet utilization
(busy-seconds / H * makespan) rises toward 1 without changing any job's
per-phase I/O terms above — and k same-length corpora submitted as one
fused walk job (walk_hop_fused) share each hop's O(B / C_e) CSR scan,
dividing that read term by k.

Shard-migration term (core/shardmap.py + core/cluster.py): a skew
rebalance at a phase barrier moves the migrated buckets' shard files —
stores, CSR arrays, corpus shards — from straggler to cold host over the
exchange transport, one O(bytes(b) / C_e) sequential read + framed send +
sequential durable write per migrated bucket b.  The planner is fed by the
IOLedger's per-bucket byte counters (`bucket_bytes[b]`, surfaced in every
BENCH_*.json), moves each bucket at most once per barrier, and only when
the move strictly shrinks the host-load spread, so migration bytes are
bounded by the skew actually observed — a uniform graph pays ZERO.  Every
later phase term above is unchanged in total but re-balanced per host:
the 1/H shares stop being nominal and track bytes, which is the whole
point.  Migration is resumable per file (ack-after-durable + per-file
micro-phases), so a crash never re-pays completed shard transfers.

I/O-overlap term (cfg.io_overlap, default on — blockstore.PrefetchReader /
WriteBehindWriter): every pass above is a read stream R, a compute term C,
and a write stream W that the serial path pays as R + C + W.  With overlap
on, merge-cursor refills prefetch on a background I/O thread (depth 2,
double-buffered) and run/partition/exchange emission completes write-behind
with one chunk in flight, so the effective per-pass cost drops toward
max(R, C, W) — the paper's dedicated-I/O-thread model.  The byte counts in
every term above are UNCHANGED (the flag is timing-only and bit-identical;
result_config_key normalizes it out), resident memory at most doubles (one
in-flight buffer per direction, MemoryGauge-tracked), and the time NOT
hidden is measured: ledger.read_wait_s (consumer stalled on prefetch),
ledger.write_wait_s (producer stalled on the in-flight chunk), and
ledger.overlap_s (I/O seconds actually hidden behind compute) appear in the
per-phase orchestrator deltas and BENCH json.  Buffers below the async
byte floor (blockstore._ASYNC_IO_MIN_BYTES) move synchronously even with
the flag on — for tiny blocks the thread handoff costs more than the
transfer it would hide, so overlap engages only where R or W is real.

Every external merge above pays an extra O(log_merge_fanin(nruns))-deep
cascade of sequential read+write passes whenever a store's run count exceeds
cfg.merge_fanin (blockstore.merge_runs): the bounded-fan-in multiway merge
trades those log-depth passes for an open-file count and merge heap bounded
by merge_fanin at ANY store size — with nruns <= merge_fanin (the common
case at paper scales) the term is zero and the costs are exactly the flat
merge's.  With cfg.pooled_cascade the partitioned/cluster CSR sort runs the
SAME cascade as phase-level (bucket, group) tasks through the worker pool —
identical pass count and bytes, wall time divided by the pool width at every
intermediate level (one extra final pass when 1 < nruns <= fanin, the price
of pool-dispatching the last merge).

`StreamingGenerator(cfg, dir).run()` returns (pv memmap, per-bucket CSR,
ledger); `gen.orchestrator.report()` gives the per-phase ledger deltas that
benchmarks/bench_csr_variants.py and bench_external_shuffle.py print.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .blockstore import (  # noqa: F401  (IOLedger re-exported for compat)
    BlockStore,
    IOLedger,
    MemoryGauge,
    MonotoneLookup,
    merge_runs,
    partition_runs,
    sort_runs,
    write_behind,
)
from .chunks import graph_perm_chunk, rmat_chunk
from .phases import (
    PhaseOrchestrator,
    attach_pv_buckets,
    csr_bucket_sorted,
    csr_adjv_path,
    csr_offv_path,
    drive_shuffle,
    load_bucket_csr,
    plain_config,
    pv_store_name,
    result_config_key,
    validate_external_shape,
)
from .trace import maybe_install_tracer
from .transport import FilesystemTransport
from .types import GraphConfig


# Store names of the sequential driver, shared by the producer sites AND the
# checkpoint-GC frees declarations in run() — clean_store() ignores missing
# dirs, so a name drifting between the two would silently disable GC.
EDGES_STORE = "edges"


def relabeled_store_name(pass_ix: int) -> str:
    return f"relabeled_p{pass_ix}"


def seq_owned_store_name(i: int) -> str:
    return f"owned_{i:03d}"


class RunStore(BlockStore):
    """(src, dst) pair store — the original external edgelist ADT, now a
    two-column BlockStore (kept as a named type for call-site readability)."""

    def __init__(self, workdir: str, name: str, ledger: IOLedger,
                 gauge: Optional[MemoryGauge] = None, fresh: bool = False):
        super().__init__(workdir, name, ledger, columns=("src", "dst"), gauge=gauge,
                         fresh=fresh)

    def total_edges(self) -> int:
        return self.total_rows()


def external_sort_runs(store: BlockStore, out: BlockStore, key_col: int = 0,
                       chunk: Optional[int] = None) -> BlockStore:
    """Phase 1 of external merge sort (paper Alg. 7 lines 1-5): sort each
    writer-bounded run in memory, rewrite.  Thin wrapper over
    blockstore.sort_runs, kept under its historical name."""
    return sort_runs(store, out, key=key_col)


def external_merge(store: BlockStore, key_col: int = 0, block_rows: int = 0,
                   max_fanin: int = 0) -> Iterator[Tuple[np.ndarray, ...]]:
    """Phase 2: streaming k-way merge of sorted runs (paper's bounded-buffer
    merge, fig. 1).  Resident memory is one chunk split across the run
    cursors — never the whole store.  `max_fanin` >= 2 bounds the cursor
    count via the log-depth cascade (see blockstore.merge_runs)."""
    return merge_runs(store, key=key_col, block_rows=block_rows,
                      max_fanin=max_fanin)


class StreamingGenerator:
    """Single-host out-of-core generator: bounded RAM, disk-resident edges
    AND (with shuffle_variant="external") a disk-resident permutation.

    `nb` plays the role of the paper's compute nodes — per-owner partition
    files stand in for the MPI packets, so the same code measures the I/O
    cost of every phase without a network.  The multi-process twin
    (phases.PartitionedGenerator) runs the same bucket kernels with real
    process parallelism.
    """

    def __init__(self, cfg: GraphConfig, workdir: str,
                 checkpoint: Optional[bool] = None, device="cuda"):
        self.cfg = cfg
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.ledger = IOLedger()
        self.gauge = MemoryGauge(budget_rows=int(cfg.chunk_edges))
        ck = cfg.checkpoint_phases if checkpoint is None else checkpoint
        self._pcfg = plain_config(cfg, device)
        maybe_install_tracer(workdir, enabled=self._pcfg.trace)
        if self._pcfg.transport != "fs":
            raise ValueError(
                "StreamingGenerator is the single-process reference driver "
                "and exchanges through the filesystem only; use "
                "PartitionedGenerator for transport='socket'")
        self._transport = FilesystemTransport(workdir, self.ledger, self.gauge)
        if cfg.shuffle_variant == "external":
            validate_external_shape(self._pcfg)
        # shuffle_variant (and the rest of the variant knobs) live inside
        # result_config_key now — no need to append them separately.
        self.orchestrator = PhaseOrchestrator(
            workdir, self.ledger, checkpoint=ck,
            config_key=repr(result_config_key(self._pcfg)),
            keep_all=bool(getattr(cfg, "keep_phase_stores", False)))

    # -- phase 1: permutation ------------------------------------------------
    def permutation(self) -> List[BlockStore]:
        """Build pv as nb disk-resident bucket stores; bucket i holds
        pv[i*B : (i+1)*B] in run order."""
        if self.cfg.shuffle_variant == "device":
            return self._permutation_device()
        if self.cfg.shuffle_variant == "external":
            return self._permutation_external()
        if self.cfg.shuffle_variant == "recompute":
            raise ValueError(
                "shuffle_variant='recompute' materializes no pv stores — "
                "evaluate hostgen.graph_perm_np(seed, ids, n) (or its "
                "inverse) instead")
        raise ValueError(self.cfg.shuffle_variant)

    def _permutation_device(self) -> List[BlockStore]:
        """pv via the device shuffle (scale permitting), spilled to bucket
        files.  Holds the whole vector in RAM once — the §IV-A limitation —
        which the gauge records honestly."""
        from .shuffle import distributed_shuffle

        cfg1 = self.cfg.with_(nb=1)
        pv = distributed_shuffle(cfg1, self._pcfg.device).cpu().numpy()
        self.gauge.track(pv.size)
        B, chunk = self.cfg.bucket_size, self.cfg.chunk_edges
        buckets = []
        for i in range(self.cfg.nb):
            store = BlockStore(self.workdir, pv_store_name(self._pcfg.rounds, i),
                               self.ledger, columns=("v",), gauge=self.gauge,
                               fresh=True)
            for lo in range(i * B, (i + 1) * B, chunk):
                store.append_run(pv[lo : min(lo + chunk, (i + 1) * B)].astype(np.int64))
            buckets.append(store)
        return buckets

    def _run_kernels_inline(self, kernel: str, argss) -> List:
        """In-process map strategy for the shared phase drivers: same bucket
        kernels the partitioned workers run, against this driver's ledger
        and (filesystem) transport.  Returns the kernel outputs (the pooled
        drivers plan cascades from counts-returning sort kernels)."""
        from .phases import _KERNELS

        return [_KERNELS[kernel](self._pcfg, self.workdir, *args,
                                 ledger=self.ledger, gauge=self.gauge,
                                 transport=self._transport)
                for args in argss]

    def _permutation_external(self) -> List[BlockStore]:
        """Paper Alg. 2-4 on disk: rounds of {chunked local shuffle via
        external sort by counter-hash key, positional bucket exchange}.
        Peak RSS O(chunk_edges); every transfer sequential.  Bit-identical
        to distributed_shuffle on an nb-shard mesh (tested)."""
        p = self._pcfg
        drive_shuffle(p, self.workdir, self._run_kernels_inline,
                      transport=self._transport)
        return attach_pv_buckets(p, self.workdir, self.ledger, self.gauge)

    def export_pv(self, buckets: List[BlockStore]) -> np.ndarray:
        """Assemble pv into one memmap for callers/validation — streamed in
        chunk-sized blocks (the array returned is disk-backed, not resident)."""
        path = os.path.join(self.workdir, "pv.npy")
        out = np.lib.format.open_memmap(path, mode="w+", dtype=np.int64,
                                        shape=(self.cfg.n,))
        pos = 0
        for store in buckets:
            for (v,) in store.iter_blocks(self.cfg.chunk_edges):
                out[pos : pos + v.size] = v
                self.ledger.write(v.nbytes)
                pos += v.size
        out.flush()
        del out
        return np.load(path, mmap_mode="r")

    def export_pv_recompute(self) -> np.ndarray:
        """Assemble pv for callers/validation under shuffle_variant=
        'recompute': there are no bucket stores to stream, so each chunk is
        pure hash evaluation — pv[lo:hi] = perm([lo, hi)) — written straight
        to the memmap.  Bit-identical to export_pv over an
        external+feistel run of the same config (tested)."""
        p = self._pcfg
        path = os.path.join(self.workdir, "pv.npy")
        out = np.lib.format.open_memmap(path, mode="w+", dtype=np.int64,
                                        shape=(self.cfg.n,))
        chunk = self.cfg.chunk_edges
        for lo in range(0, self.cfg.n, chunk):
            ids = np.arange(lo, min(lo + chunk, self.cfg.n), dtype=np.int64)
            self.ledger.hashes(ids.size)
            v = graph_perm_chunk(p.seed, ids, p.n, rounds=p.feistel_rounds,
                                 device=p.device)
            out[lo : lo + ids.size] = v
            self.ledger.write(v.nbytes)
        out.flush()
        del out
        return np.load(path, mmap_mode="r")

    # -- phase 2: edge generation ---------------------------------------------
    def generate_edges(self) -> RunStore:
        """Alg. 5 through the `rmat_edges` kernel (bit-identical to the
        reference's numpy counter-RNG mirror — tested), chunk-bounded runs."""
        store = RunStore(self.workdir, EDGES_STORE, self.ledger, gauge=self.gauge, fresh=True)
        m, blk = self.cfg.m, self.cfg.chunk_edges
        for start in range(0, m, blk):
            cnt = min(blk, m - start)
            s, d = rmat_chunk(self._pcfg, start, cnt, self._pcfg.device)
            store.append_run(s, d)
        return store

    # -- phase 3: relabel (sort-merge-join, Alg. 6-7) --------------------------
    def relabel(self, edges: BlockStore, pv_buckets: List[BlockStore]) -> BlockStore:
        """Two passes, each keyed on column 1 and emitting (pv[col1], col0):

            pass 1: (src, dst)      -> (pv[dst], src)
            pass 2: (pv[dst], src)  -> (pv[src], pv[dst])

        i.e. the paper's order — destination field first, then source — with
        a column swap instead of two different sort keys.  The probe side is
        the external-sorted edge stream; the build side is the pv *runs*
        streamed forward by MonotoneLookup.  Both sides advance monotonically
        => pure sequential I/O.
        """
        cur = edges
        ov = self._pcfg.io_overlap
        for pass_ix in range(2):
            sorted_store = RunStore(self.workdir, f"sorted_p{pass_ix}",
                                    self.ledger, gauge=self.gauge, fresh=True)
            sort_runs(cur, sorted_store, key=1, overlap=ov)
            out = RunStore(self.workdir, relabeled_store_name(pass_ix),
                           self.ledger, gauge=self.gauge, fresh=True)
            lookup = MonotoneLookup(pv_buckets, block_rows=self.cfg.chunk_edges,
                                    gauge=self.gauge, device=self._pcfg.device)
            with write_behind([out], self.ledger, self.gauge,
                              enabled=ov) as sinks:
                for s, d in merge_runs(sorted_store, key=1,
                                       block_rows=self.cfg.merge_block_rows,
                                       max_fanin=self.cfg.merge_fanin,
                                       overlap=ov):
                    sinks[0].append_run(lookup.lookup(d), s)
            sorted_store.destroy()
            if cur is not edges:
                cur.destroy()
            cur = out
        # after the second pass columns are (new_src, new_dst)
        return cur

    # -- phase 3': communication-free relabel (recompute) ----------------------
    def relabel_recompute(self, edges: BlockStore) -> List[RunStore]:
        """shuffle_variant='recompute': ONE streaming scan applies
        u -> perm(u) to both endpoints by hash evaluation (no pv store, no
        external sorts, no join) and partitions straight to the owner
        stores — relabel (both passes) and redistribute fused.  Twin of
        phases.relabel_recompute_bucket."""
        p = self._pcfg
        nb, B = self.cfg.nb, self.cfg.bucket_size

        def relabel(s, d):
            self.ledger.hashes(s.size + d.size)
            return (graph_perm_chunk(p.seed, s, p.n, rounds=p.feistel_rounds,
                                     device=p.device),
                    graph_perm_chunk(p.seed, d, p.n, rounds=p.feistel_rounds,
                                     device=p.device))

        owners = [RunStore(self.workdir, seq_owned_store_name(i), self.ledger,
                           gauge=self.gauge, fresh=True) for i in range(nb)]
        partition_runs(edges, owners, lambda s, d: s // B, transform=relabel,
                       overlap=p.io_overlap, device=p.device)
        return owners

    # -- phase 4: redistribute (Alg. 8-9) --------------------------------------
    def redistribute(self, edges: BlockStore) -> List[RunStore]:
        nb, B = self.cfg.nb, self.cfg.bucket_size
        owners = [RunStore(self.workdir, seq_owned_store_name(i), self.ledger,
                           gauge=self.gauge, fresh=True) for i in range(nb)]
        partition_runs(edges, owners, lambda s, d: s // B,
                       overlap=self._pcfg.io_overlap, device=self._pcfg.device)
        return owners

    # -- phase 5: CSR ----------------------------------------------------------
    def build_csr_sorted(self, owners: List[BlockStore]) -> List[Tuple[np.ndarray, np.ndarray]]:
        """§III-B7: external sort by src + streaming Alg. 1.  Sequential;
        adjv streams into a per-bucket memmap, never resident.  Delegates to
        the shared bucket kernel (phases.csr_bucket_sorted) so both drivers
        build CSR with literally the same code."""
        results = []
        for i, store in enumerate(owners):
            offv_path, adjv_path = csr_bucket_sorted(
                self._pcfg, self.workdir, i, ledger=self.ledger,
                gauge=self.gauge, in_name=store.name)
            results.append(load_bucket_csr(offv_path, adjv_path,
                                           self.ledger, self.gauge))
        return results

    def build_csr_scatter(self, owners: List[BlockStore]) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Alg. 10-11: unordered scan with a bounded associative map flushed
        into a memmap'd adjv — every flush is a RANDOM write burst.  This is
        the variant whose I/O the paper measured blowing up (Fig. 2)."""
        if self._pcfg.perm_family == "feistel":
            # Scatter-CSR adjacency order is ENCOUNTER order; recompute and
            # external deliver the same owned-edge multiset in different
            # arrival orders, so the feistel family's bit-identity contract
            # requires the (src, dst)-sorted variant.
            raise ValueError(
                "csr_variant='scatter' is incompatible with "
                "perm_family='feistel': its adjacency lists are in arrival "
                "order, which the recomputable-permutation paths do not "
                "reproduce; use csr_variant='sorted'")
        B = self.cfg.bucket_size
        flush_at = max(16, self.cfg.chunk_edges // 256)  # mmc analogue
        results = []
        for i, store in enumerate(owners):
            base = i * B
            degv = np.zeros(B, np.int64)
            self.gauge.track(B)
            # Block-sized degree pass: iter_runs would load whole run files
            # (read_run's whole-run contract), spiking residency past chunk.
            for s, _ in store.iter_blocks(self.cfg.chunk_edges):
                np.add.at(degv, s - base, 1)
            offv = np.concatenate([[0], np.cumsum(degv)]).astype(np.int64)
            path = os.path.join(self.workdir, f"adjv_{i:03d}.npy")
            adjv = np.lib.format.open_memmap(path, mode="w+", dtype=np.int64,
                                             shape=(int(offv[-1]),))
            cursor = np.zeros(B, np.int64)
            adjvh = {}
            held = 0
            for s, d in store.iter_blocks(self.cfg.chunk_edges):
                for sv, dv in zip((s - base).tolist(), d.tolist()):
                    adjvh.setdefault(sv, []).append(dv)
                    held += 1
                    if held >= flush_at:
                        for v, lst in adjvh.items():  # random write per vertex
                            o = offv[v] + cursor[v]
                            adjv[o : o + len(lst)] = lst
                            cursor[v] += len(lst)
                            self.ledger.write(8 * len(lst), sequential=False)
                        adjvh, held = {}, 0
            for v, lst in adjvh.items():
                o = offv[v] + cursor[v]
                adjv[o : o + len(lst)] = lst
                cursor[v] += len(lst)
                self.ledger.write(8 * len(lst), sequential=False)
            adjv.flush()
            results.append((offv, np.asarray(adjv)))
        return results

    # -- driver ----------------------------------------------------------------
    def _save_stores(self, stores) -> dict:
        if isinstance(stores, BlockStore):
            return {"stores": [stores.manifest()], "single": True}
        return {"stores": [s.manifest() for s in stores], "single": False}

    def _load_stores(self, payload: dict):
        stores = [BlockStore.from_manifest(m, self.workdir, self.ledger, self.gauge)
                  for m in payload["stores"]]
        return stores[0] if payload["single"] else stores

    def run(self, csr_variant: Optional[str] = None):
        """Run all phases through the orchestrator.  Returns
        (pv memmap, [(offv, adjv)] per bucket, IOLedger); per-phase ledger
        deltas via `self.orchestrator.report()`.

        Checkpoint GC: every phase declares (via `frees`) the stores it is
        the last consumer of, so unless cfg.keep_phase_stores the workdir
        retains only the final artifacts (CSR bucket files + pv.npy) plus
        whatever the pipeline's current frontier still needs — the disk
        footprint is bounded instead of accumulating every intermediate.
        """
        csr_variant = csr_variant or self.cfg.csr_variant
        nb = self.cfg.nb
        orch = self.orchestrator
        sv, ld = self._save_stores, self._load_stores
        recompute = self.cfg.shuffle_variant == "recompute"
        if recompute:
            # Communication-free path: no shuffle phase at all (the
            # permutation is a hash family, not a store), and relabel +
            # redistribute fuse into one scan.
            edges = orch.run_phase("generate", self.generate_edges,
                                   save=sv, load=ld)
            owners = orch.run_phase(
                "relabel_recompute", lambda: self.relabel_recompute(edges),
                save=sv, load=ld, frees=[EDGES_STORE])
        else:
            pv_buckets = orch.run_phase("shuffle", self.permutation,
                                        save=sv, load=ld)
            edges = orch.run_phase("generate", self.generate_edges,
                                   save=sv, load=ld)
            relabeled = orch.run_phase(
                "relabel", lambda: self.relabel(edges, pv_buckets),
                save=sv, load=ld, frees=[EDGES_STORE])
            owners = orch.run_phase(
                "redistribute", lambda: self.redistribute(relabeled),
                save=sv, load=ld, frees=[relabeled_store_name(1)])

        def _load_csr(_m):
            return [load_bucket_csr(csr_offv_path(self.workdir, i),
                                    csr_adjv_path(self.workdir, i),
                                    self.ledger, self.gauge)
                    for i in range(nb)]

        if csr_variant == "sorted":
            # The CSR files are the durable output; the manifest only needs
            # to mark completion (paths are the naming convention's).
            csr = orch.run_phase(
                "csr_sorted", lambda: self.build_csr_sorted(owners),
                save=lambda _res: {"nb": nb}, load=_load_csr,
                frees=[seq_owned_store_name(i) for i in range(nb)])
        elif csr_variant == "scatter":
            # scatter keeps offv in RAM only — not checkpointable, so its
            # inputs are never freed by THIS run (a resume must be able to
            # rerun it).  A prior 'sorted' run over the same checkpoint may
            # have freed them already though — fail with guidance, not with
            # a FileNotFoundError deep inside np.load.
            gone = sum(len(s.missing_runs()) for s in owners)
            if gone:
                raise ValueError(
                    f"csr_variant='scatter' needs the redistribute output "
                    f"stores, but {gone} run file(s) were already "
                    "garbage-collected by a checkpointed csr_sorted run; "
                    "rerun with keep_phase_stores=True or a fresh workdir")
            csr = orch.run_phase("csr_scatter", lambda: self.build_csr_scatter(owners))
        else:
            raise ValueError(csr_variant)
        if recompute:
            pv = orch.run_phase(
                "export_pv", self.export_pv_recompute,
                save=lambda _res: {"path": "pv.npy"},
                load=lambda m: np.load(os.path.join(self.workdir, m["path"]),
                                       mmap_mode="r"))
        else:
            pv = orch.run_phase(
                "export_pv", lambda: self.export_pv(pv_buckets),
                save=lambda _res: {"path": "pv.npy"},
                load=lambda m: np.load(os.path.join(self.workdir, m["path"]),
                                       mmap_mode="r"),
                frees=[pv_store_name(self._pcfg.rounds, i) for i in range(nb)]
                      if csr_variant == "sorted" else [])
        return pv, csr, self.ledger
