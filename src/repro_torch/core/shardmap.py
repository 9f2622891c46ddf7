"""Versioned directory shard map: bucket -> (host, split-generation)
(twin of `repro.core.shardmap`).

ClusterSpec's closed-form contiguous split (``range(h*nb//H, (h+1)*nb//H)``)
fixes placement for the lifetime of a run, so RMAT degree skew turns the
hosts owning hot buckets into stragglers.  The ShardMap replaces that
closed form with an explicit directory the controller may rewrite **at
phase barriers only**:

  * ``owners[b]`` is the host that owns bucket ``b`` right now — every
    ownership lookup (task placement, exchange routing, shard manifests,
    lease planning) goes through the map instead of the closed form.
  * ``gens[b]`` is the bucket's split generation: bumped on every
    reassignment so a migration of bucket ``b`` at generation ``g`` can be
    told apart from a later one, and so resumable migration micro-phases
    key on ``(bucket, gen)`` rather than wall-clock identity.
  * ``version`` is a map-wide monotone counter.  Frames routed under an
    old map carry their sender's ``mapv``; receivers refuse anything below
    their ratcheted minimum (see :func:`frame_version_ok`), so a host that
    missed a barrier cannot deliver bytes to a stale owner.

The map is pure data + pure planning.  Mutation of live cluster state
(queues, exchange addresses, transports) stays in core/cluster.py; moving
the bytes stays in core/transport.py (MIGRATE frames).  Keeping this
module dependency-free makes the rebalancing laws property-testable in
isolation (tests/test_cluster_property.py).

``contiguous(nb, num_hosts)`` reproduces ClusterSpec's historical split
exactly, so a cluster that never rebalances is bit-for-bit the static
map — the map changes *where* bytes live, never *what* they are.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple


class ShardMapError(RuntimeError):
    pass


@dataclasses.dataclass
class ShardMap:
    """Directory of bucket ownership.  Mutable on purpose: the controller
    owns the single live instance and rewrites it under its lock; every
    mutation bumps ``version`` so stale routes are detectable."""

    nb: int
    num_hosts: int
    owners: List[int]
    gens: List[int]
    version: int = 0

    # -- construction -------------------------------------------------

    @classmethod
    def contiguous(cls, nb: int, num_hosts: int) -> "ShardMap":
        """The historical static split, verbatim: host h owns
        ``range(h*nb//H, (h+1)*nb//H)``.  Version 0, all gens 0."""
        if num_hosts < 1 or nb < num_hosts:
            raise ShardMapError(f"need nb >= num_hosts >= 1, got nb={nb} "
                                f"num_hosts={num_hosts}")
        owners = [0] * nb
        for h in range(num_hosts):
            for b in range(h * nb // num_hosts, (h + 1) * nb // num_hosts):
                owners[b] = h
        return cls(nb=nb, num_hosts=num_hosts, owners=owners,
                   gens=[0] * nb, version=0)

    def __post_init__(self) -> None:
        self.validate()

    # -- lookups ------------------------------------------------------

    def owner_of(self, bucket: int) -> int:
        return self.owners[self._check_bucket(bucket)]

    def gen_of(self, bucket: int) -> int:
        return self.gens[self._check_bucket(bucket)]

    def buckets_of(self, host: int) -> List[int]:
        """All buckets owned by ``host``, ascending (the static map's
        ``range`` order, so callers iterating it are order-stable)."""
        return [b for b in range(self.nb) if self.owners[b] == host]

    def _check_bucket(self, bucket: int) -> int:
        b = int(bucket)
        if not 0 <= b < self.nb:
            raise ShardMapError(f"bucket {b} out of range [0, {self.nb})")
        return b

    # -- mutation (controller-side, at phase barriers only) -----------

    def assign(self, bucket: int, host: int) -> None:
        """Reassign ``bucket`` to ``host``; bumps the bucket's split
        generation and the map version.  No-op reassignments are
        rejected — every version bump must mean a real route change."""
        b = self._check_bucket(bucket)
        h = int(host)
        if not 0 <= h < self.num_hosts:
            raise ShardMapError(f"host {h} out of range [0, {self.num_hosts})")
        if self.owners[b] == h:
            raise ShardMapError(f"bucket {b} already owned by host {h}")
        self.owners[b] = h
        self.gens[b] += 1
        self.version += 1
        self.validate()

    def admit_host(self) -> int:
        """Admit a late-joining host.  It owns nothing until a rebalance
        assigns it buckets; returns the new host id (== old num_hosts).
        Bumps the version: peers must learn the enlarged host set."""
        hid = self.num_hosts
        self.num_hosts += 1
        self.version += 1
        return hid

    # -- invariants ---------------------------------------------------

    def validate(self) -> None:
        """Ownership must stay a partition of ``range(nb)`` over known
        hosts (hosts MAY own zero buckets: a just-admitted host does)."""
        if len(self.owners) != self.nb or len(self.gens) != self.nb:
            raise ShardMapError("owners/gens length != nb")
        for b, h in enumerate(self.owners):
            if not 0 <= h < self.num_hosts:
                raise ShardMapError(f"bucket {b} owned by unknown host {h}")
        for b, g in enumerate(self.gens):
            if g < 0:
                raise ShardMapError(f"bucket {b} has negative gen {g}")
        if self.version < 0:
            raise ShardMapError(f"negative version {self.version}")

    # -- serialization ------------------------------------------------

    def to_json(self) -> Dict[str, object]:
        return {"nb": self.nb, "num_hosts": self.num_hosts,
                "owners": list(self.owners), "gens": list(self.gens),
                "version": self.version}

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "ShardMap":
        return cls(nb=int(d["nb"]), num_hosts=int(d["num_hosts"]),
                   owners=[int(x) for x in d["owners"]],
                   gens=[int(x) for x in d["gens"]],
                   version=int(d["version"]))

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ShardMap":
        with open(path) as f:
            return cls.from_json(json.load(f))


def frame_version_ok(frame_mapv: Optional[int], min_version: int) -> bool:
    """Should a receiver accept a frame routed under map version
    ``frame_mapv``?  ``None`` means the sender predates map versioning
    (or versioning is off) — always accepted for compatibility; otherwise
    the frame must be at or past the receiver's ratcheted minimum."""
    if frame_mapv is None:
        return True
    return int(frame_mapv) >= int(min_version)


def plan_rebalance(smap: ShardMap, loads: Dict[int, float],
                   max_moves: int = 0) -> List[Tuple[int, int, int]]:
    """Deterministic greedy rebalance plan: ``[(bucket, src, dst), ...]``.

    ``loads`` maps bucket -> observed cost (bytes or rows from the
    IOLedger's per-bucket counters).  Repeatedly move the hottest bucket
    from the most-loaded host to the least-loaded host while that
    strictly improves the imbalance; a host with no recorded load (a
    late joiner) naturally attracts moves.  Ties break on lowest id, so
    the plan is a pure function of (map, loads) — a resumed rebalance
    replays the identical plan from the same snapshot.

    The plan is advisory: it never splits below one bucket per move and
    terminates because each accepted move strictly lowers the sum of
    squared host loads (``new_dst < old_src`` implies the exchanged load
    shrinks the spread).
    """
    nb, H = smap.nb, smap.num_hosts
    if H < 2:
        return []
    load = {b: float(v) for b, v in loads.items()
            if 0 <= int(b) < nb and float(v) > 0.0}
    owner = list(smap.owners)
    host_load = [0.0] * H
    for b, v in load.items():
        host_load[owner[int(b)]] += v
    cap = int(max_moves) if max_moves else nb
    moves: List[Tuple[int, int, int]] = []
    # Each bucket moves AT MOST once per plan: all of a plan's migrations
    # run in one barrier, and two moves of the same bucket would race.
    already = set()
    while len(moves) < cap:
        src = max(range(H), key=lambda h: (host_load[h], -h))
        dst = min(range(H), key=lambda h: (host_load[h], -h))
        # src ties break to the lowest id, dst ties to the highest id —
        # a freshly admitted (empty) host wins so late joiners fill first
        if src == dst or host_load[src] <= host_load[dst]:
            break
        moved = False
        for b in sorted((b for b in load
                         if owner[int(b)] == src and b not in already),
                        key=lambda b: (-load[b], b)):
            w = load[b]
            # strict improvement: after the move the destination must
            # still sit below the source's old level
            if host_load[dst] + w < host_load[src]:
                moves.append((int(b), src, dst))
                already.add(b)
                owner[int(b)] = dst
                host_load[src] -= w
                host_load[dst] += w
                moved = True
                break
        if not moved:
            break
    return moves


def apply_moves(smap: ShardMap,
                moves: Sequence[Tuple[int, int, int]]) -> None:
    """Apply a plan from :func:`plan_rebalance` to the map.  Each move's
    ``src`` must still be the current owner (the plan was computed under
    this exact map — a mismatch means a concurrent rewrite happened and
    the plan is void)."""
    for (b, src, dst) in moves:
        if smap.owner_of(b) != int(src):
            raise ShardMapError(
                f"stale plan: bucket {b} owned by {smap.owner_of(b)}, "
                f"plan expected {src}")
        smap.assign(b, dst)
