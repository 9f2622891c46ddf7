"""Random-walk corpus over the generated graph (twin of `repro.data.walks`).

  host_walks         numpy sampler over one host CSR: the oracle
  csr_walks          the same walks on tensors of any device (the loader's)
  distributed_walks  walkers MIGRATE between shards with the paper's k:1
                     scatter-gather (`capacity_all_to_all`): before every hop
                     each walker's state (position, walker id) goes to the
                     shard that owns its current vertex, which advances it
                     from its LOCAL CSR rows.  The history stays put, in a
                     table by walker id that each hop writes, and is laid
                     out in the reference's row order once at the end.  The
                     reference's nb-shard mesh is the leading dimension of
                     each array here, so on the card every hop runs the
                     `bucket_hist` kernel once per shard.
  external_walks     the out-of-core sampler over the disk tier's CSR bucket
                     files: each hop is the redistribute phase applied to
                     walkers (core/phases.py walk kernels), the corpus a
                     sharded set of files (core/corpus.py).

The shared RNG contract, bit-identical across the samplers (and with the
reference's): the value drawn for walker w at step t is walk_rand(seed, w, t)
(uint32); the start vertex is start_vertex(seed, w, n) (the same RNG at step 0,
salted with 0xA5A5); a walker on a sink vertex (degree 0) teleports to
rand % n, otherwise it follows adjv[offv[pos] + rand % deg], so the order of
each CSR row is part of the contract.  uint32 values live in int64 tensors
masked to 32 bits (PyTorch has no uint32 `%` or `>>` on the CPU); a walker id
of -1 (a padding row) reads as 0xFFFFFFFF.

Walk histories are int64 on the host path; distributed_walks computes in
cfg.vertex_dtype (int32) and refuses a graph whose ids overflow it.
Tokenization: token = vertex % vocab.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.blockstore import IOLedger, MemoryGauge
from ..core.corpus import ShardedWalks
from ..core.hostgen import _GOLDEN, MASK32, walk_rand_np, walk_start_np
from ..core.phases import (
    _KERNELS,
    PhaseOrchestrator,
    PlainCfg,
    WalkCfg,
    drive_walks,
    plain_config,
    result_config_key,
)
from ..core.trace import count, counting, device_span
from ..core.transport import make_transport
from ..core.types import GraphConfig, owner_of
from ..distributed.collectives import JUNK_ROWS, capacity_all_to_all
from ..kernels.ref import mix32


def walk_rand(seed: int, walker: torch.Tensor, step: int) -> torch.Tensor:
    """Torch twin of `walk_rand_np`: int64 in [0, 2^32); `walker` is read as
    uint32 (its low 32 bits)."""
    s = seed & MASK32
    return mix32((mix32((walker.to(torch.int64) & MASK32) ^ s) + ((step * _GOLDEN) & MASK32))
                 & MASK32)


def start_vertex(seed: int, walker, n_or_B: int, base=0, dtype=None):
    """Deterministic start vertex of a walker (shared by all samplers).
    Numpy walkers give int64 numpy (the host contract); tensors give a tensor
    of `dtype` (default int32, the device vertex dtype)."""
    if isinstance(walker, np.ndarray):
        return walk_start_np(seed, walker, n_or_B, base)
    dtype = torch.int32 if dtype is None else dtype
    if isinstance(base, torch.Tensor):
        base = base.to(torch.int64)
    return (base + walk_rand(seed ^ 0xA5A5, walker, 0) % n_or_B).to(dtype)


# ---------------------------------------------------------------------------
# host oracle and its tensor twin
# ---------------------------------------------------------------------------


def host_walks(offv: np.ndarray, adjv: np.ndarray, starts: np.ndarray,
               length: int, seed: int, n: Optional[int] = None,
               walker_ids: Optional[np.ndarray] = None) -> np.ndarray:
    """[W, length+1] vertex walks.  starts [W]."""
    n = n if n is not None else offv.shape[0] - 1
    W = starts.shape[0]
    wid = (walker_ids if walker_ids is not None
           else np.arange(W)).astype(np.uint32)
    pos = starts.astype(np.int64).copy()
    hist = np.zeros((W, length + 1), np.int64)
    hist[:, 0] = pos
    for t in range(length):
        deg = (offv[pos + 1] - offv[pos]).astype(np.int64)
        r = walk_rand_np(seed, wid, t + 1).astype(np.int64)
        sink = deg == 0
        idx = offv[pos] + np.where(sink, 0, r % np.maximum(deg, 1))
        nxt = np.where(sink, r % n, adjv[np.minimum(idx, adjv.shape[0] - 1)])
        pos = nxt.astype(np.int64)
        hist[:, t + 1] = pos
    return hist


def csr_walks(offv: torch.Tensor, adjv: torch.Tensor, starts: torch.Tensor, length: int,
              seed: int, n: Optional[int] = None,
              walker_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`host_walks` on tensors, on their device: int64 [W, length+1] walks
    over one CSR (offv [n+1], adjv [m])."""
    n = n if n is not None else offv.shape[0] - 1
    W = starts.shape[0]
    wid = walker_ids if walker_ids is not None else torch.arange(W, device=starts.device)
    pos = starts.to(torch.int64)
    offv = offv.to(torch.int64)
    hist = torch.empty((W, length + 1), dtype=torch.int64, device=starts.device)
    hist[:, 0] = pos
    for t in range(length):
        start = offv[pos]
        deg = offv[pos + 1] - start
        r = walk_rand(seed, wid, t + 1)
        sink = deg == 0
        idx = start + torch.where(sink, 0, r % deg.clamp(min=1))
        pos = torch.where(sink, r % n, adjv[idx.clamp(max=adjv.shape[0] - 1)].to(torch.int64))
        hist[:, t + 1] = pos
    return hist


# ---------------------------------------------------------------------------
# distributed sampler (walker redistribution = the paper's scatter-gather)
# ---------------------------------------------------------------------------


def distributed_walks(cfg: GraphConfig, offv: torch.Tensor, adjv: torch.Tensor, *,
                      length: int, seed: int = 0, walkers_per_shard: int = 64,
                      capacity_factor: float = 4.0):
    """Walk histories [nb*cap, length+1], validity [nb*cap], walker ids
    [nb*cap] and the global dropped count, in the reference's row order.

    `offv` [nb*(B+1)] and `adjv` [nb*cap_m] are the per-shard CSR as
    `CSRShards` holds it.  Shard i starts walkers i*W .. i*W+W-1 at vertices
    it owns; before every hop each walker's state (position, walker id) goes
    to the owner of its current vertex with `capacity_all_to_all` (capacity
    cp = ceil(W * factor / nb) per shard pair, cap = cp * nb rows per
    shard), so each hop reads local CSR rows only.  A receiver's rows are
    sender-major, and a row is live where the exchange gave it a slot.
    Walkers past a pair's capacity are dropped and counted; their rows end
    invalid.  The history never moves: each hop's live rows write their new
    vertex into a table by walker id, and the table's rows are laid out in
    the final row order once, after the last hop (a row no walker holds is
    all zeros).  Each hop is two device spans (`core/trace.py`),
    "walks.exchange" and "walks.advance"; the exchange counts "row_bytes",
    the bytes of the state rows it is offered.
    """
    nb, B, n, W = cfg.nb, cfg.bucket_size, cfg.n, walkers_per_shard
    vdt = cfg.vertex_dtype
    # histories are computed in the vertex dtype: refuse a graph whose ids overflow it
    if n - 1 > torch.iinfo(vdt).max:
        raise ValueError(f"n={n} overflows vertex_dtype={vdt}")
    cp = max(1, int(math.ceil(W * capacity_factor / nb)))
    cap = cp * nb
    if cap < W:
        raise ValueError(f"capacity_factor={capacity_factor} gives {cap} rows per shard for "
                         f"{W} walkers per shard")
    dev = offv.device
    offv_s = offv.reshape(nb, B + 1).to(torch.int64)
    adjv_s = adjv.reshape(nb, -1)
    shard = torch.arange(nb, dtype=torch.int64, device=dev)[:, None]
    base = shard * B
    wid = shard * W + torch.arange(W, dtype=torch.int64, device=dev)
    pos = start_vertex(seed, wid, B, base, dtype=vdt)
    # the history table: walker w's vertices in row w, and row nb*W all
    # zeros for the rows no walker holds; the JUNK_ROWS entries past it take
    # the writes of those rows, spread over them since the card serialises
    # writes to one address
    walkers, width = nb * W, length + 1
    flat = torch.zeros((walkers + 1) * width + JUNK_ROWS, dtype=vdt, device=dev)
    table = flat[:(walkers + 1) * width].view(walkers + 1, width)
    table[:walkers, 0] = pos.reshape(-1)
    # each shard's rows: [pos, wid]; padding rows carry pos 0, wid -1 and are not alive
    state = torch.zeros((nb, cap, 2), dtype=vdt, device=dev)
    state[:, :W, 0] = pos
    state[:, :, 1] = -1
    state[:, :W, 1] = wid.to(vdt)
    alive = torch.zeros((nb, cap), dtype=torch.bool, device=dev)
    alive[:, :W] = True
    del wid, pos
    junk = (walkers + 1) * width + (torch.arange(nb * cap, device=dev) & (JUNK_ROWS - 1))
    junk = junk.reshape(nb, cap)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(length):
        with device_span("walks.exchange", dev):
            ex = capacity_all_to_all(state, owner_of(state[..., 0], B), capacity=cp, valid=alive)
            if counting():
                count("row_bytes", state.numel() * state.element_size())
            dropped += ex.dropped
            # [receiver, sender, cp, .] -> each receiver's rows, sender-major
            state = ex.data.reshape(nb, cap, 2)
            alive = ex.valid.reshape(nb, cap)
            del ex
        with device_span("walks.advance", dev):
            # advance one hop from local CSR rows
            row = (state[..., 0].to(torch.int64) - base).clamp(0, B - 1)
            start = torch.gather(offv_s, 1, row)
            deg = torch.gather(offv_s, 1, row + 1) - start
            del row
            r = walk_rand(seed, state[..., 1], t + 1)
            sink = deg <= 0
            idx = start + torch.where(sink, 0, r % deg.clamp(min=1))
            del start, deg
            nxt = torch.gather(adjv_s, 1, idx.clamp(0, adjv_s.shape[1] - 1)).to(torch.int64)
            nxt = torch.where(sink, r % n, nxt).to(vdt)
            del idx, r, sink
            state[..., 0] = nxt
            at = torch.where(alive, state[..., 1].to(torch.int64) * width + (t + 1), junk)
            flat[at] = nxt
            del nxt, at
    valid, wid = alive.reshape(-1), state[..., 1].reshape(-1)
    return table[torch.where(valid, wid.to(torch.int64), walkers)], valid, wid, dropped


def walks_to_tokens(walks, vocab: int) -> Tuple:
    """Vertex walks [W, L+1] -> (tokens [W, L], labels [W, L]) next-token LM
    pairs; token = vertex % vocab (int32).  Numpy in, numpy out; a tensor
    gives tensors on its device."""
    if isinstance(walks, np.ndarray):
        toks = (walks % vocab).astype(np.int32)
        return toks[:, :-1], toks[:, 1:].copy()
    toks = (walks % vocab).to(torch.int32)
    return toks[:, :-1], toks[:, 1:].clone()


# ---------------------------------------------------------------------------
# external sampler (the redistribute phase re-run once per hop, on disk)
# ---------------------------------------------------------------------------


class ExternalWalkResult(NamedTuple):
    """external_walks output: the sharded corpus plus the accounting objects
    tests and benchmarks assert against."""

    walks: "ShardedWalks"        # [W, length+1] int64 array-like (disk-backed
                                 # per-bucket shards + manifest, core/corpus.py)
    ledger: IOLedger
    gauge: MemoryGauge
    orchestrator: PhaseOrchestrator


def external_walks(cfg, workdir: str, *, num_walkers: int, length: int,
                   seed: int = 0, ledger: Optional[IOLedger] = None,
                   gauge: Optional[MemoryGauge] = None,
                   checkpoint: bool = False,
                   out_name: str = "walks.npy",
                   device="cuda") -> ExternalWalkResult:
    """Out-of-core walk corpus [num_walkers, length+1] over the CSR bucket
    files in `workdir` (written by StreamingGenerator / PartitionedGenerator's
    CSR phase) — the graph never materializes in RAM, and neither does the
    corpus: the collect phase is SHARDED (one `{out}_b{j}.npy` per bucket +
    a manifest, core/corpus.py), and `result.walks` is an array-like view
    over the shards.

    Each hop is the paper's redistribute phase applied to walkers: sort the
    per-bucket frontier by current vertex, sort-merge-join it against the
    owned offv/adjv runs, partition advanced walkers to their new owner
    (core/phases.py walk kernels).  Bit-identical to host_walks on the
    assembled bucket CSR (concat_bucket_csr) with walker_ids arange(W) and
    the standard start_vertex starts.  With checkpoint=True each hop is a
    resumable phase (state in <workdir>/walk_phases.json, independent of the
    generator's checkpoint); phase-level ledger deltas and peak resident
    rows come back in the result.

    Runs the bucket kernels in-process; for real process parallelism use
    PartitionedGenerator.walk_corpus, which drives the same kernels through
    its worker pool.  The frontier partitions run on `device` (a PlainCfg
    passed as `cfg` keeps its own).

    Every per-hop frontier sort and the history gather merge through
    cfg.merge_fanin-bounded cascades (blockstore.merge_runs via PlainCfg),
    so walking a store with millions of frontier runs never exceeds the
    open-file budget — identical corpus at any fan-in.
    """
    pcfg = cfg if isinstance(cfg, PlainCfg) else plain_config(cfg, device)
    ledger = IOLedger() if ledger is None else ledger
    gauge = MemoryGauge(budget_rows=pcfg.chunk_edges) if gauge is None else gauge
    wcfg = WalkCfg(num_walkers=num_walkers, length=length, seed=seed,
                   out_name=out_name)
    orch = PhaseOrchestrator(workdir, ledger, checkpoint=checkpoint,
                             state_name="walk_phases.json",
                             config_key=repr((result_config_key(pcfg), wcfg)),
                             keep_all=bool(getattr(cfg, "keep_phase_stores",
                                                   False)))

    # One transport for the whole corpus: the kernels' exchange AND the
    # drivers' pre-senders inbox sweeps go through it (fs by default;
    # a socket config with live peer_addrs works too — the partitioned
    # driver is the usual owner of that mode).
    with make_transport(pcfg, workdir, ledger, gauge) as tr:

        def inline_map(kernel: str, argss):
            # Outputs matter: the pooled-cascade hop plans its merge levels
            # from the counts the sort kernels return.
            return [_KERNELS[kernel](pcfg, workdir, *args, ledger=ledger,
                                     gauge=gauge, transport=tr)
                    for args in argss]

        path = drive_walks(pcfg, workdir, wcfg, inline_map, orch, transport=tr)
    return ExternalWalkResult(ShardedWalks(path), ledger, gauge, orch)


def concat_bucket_csr(csr) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble per-bucket CSR [(offv_i, adjv_i)] into one host (offv, adjv).

    Oracle-side helper: within-row adjacency order is part of the walk
    contract, so host_walks must read the SAME layout external_walks joins
    against.  Materializes the CSR — tests and small graphs only.
    """
    parts = [np.zeros(1, np.int64)]
    total = 0
    for offv, _ in csr:
        offv = np.asarray(offv, np.int64)
        parts.append(offv[1:] + total)
        total += int(offv[-1])
    adjv = np.concatenate([np.asarray(a, np.int64) for _, a in csr])
    return np.concatenate(parts), adjv
