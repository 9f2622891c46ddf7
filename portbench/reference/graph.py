"""Plain reference of the generator: the Graph500 Kronecker (R-MAT) edges,
the paper's distributed shuffle, the keyed Feistel permutation, and the
relabel, redistribute and CSR that follow them.

Written from the semantics alone, in plain PyTorch on any device: it shares
no code with the program under test.  uint32 values live in int64 tensors
in [0, 2**32); a product is reduced mod 2**32 at once, and the one
multiplier above 2**31 is used as its negative twin mod 2**32, so that no
int64 product overflows.

Sizes follow one spec (`GraphSpec`): n = 2**scale vertices, m = n *
edge_factor edges, nb shards.  Shard b generates the edges with global ids
[b * m/nb, (b+1) * m/nb) and owns the vertices [b * n/nb, (b+1) * n/nb).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_M1 = 0x7FEB352D                     # < 2**31: x * _M1 fits int64
_M2_NEG = 0x846CA68B - (1 << 32)     # 0x846CA68B mod 2**32, negative: fits int64
FEISTEL_STREAM = 0xFE157E11          # the permutation key is seed ^ this
EDGE_BLOCK = 1 << 25                 # edges generated per block on the card


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """One graph as a configuration file states it."""

    scale: int
    edge_factor: int
    nb: int
    a: float
    b: float
    c: float
    d: float
    permutation: str            # "paper" (the shuffle) or "feistel"
    feistel_rounds: int
    capacity_factor: float      # redistribute's per-pair capacity, x the even share
    seed: int = 0
    ties_by_dst: bool = False   # equal sources ordered by destination: a control, not the spec

    @property
    def n(self) -> int:
        return 1 << self.scale

    @property
    def m(self) -> int:
        return self.n * self.edge_factor

    @property
    def owned(self) -> int:
        """Vertices a shard owns (B)."""
        return self.n // self.nb

    @property
    def generated(self) -> int:
        """Edges a shard generates."""
        return self.m // self.nb

    @property
    def capacity(self) -> int:
        """Slots a sender has for each receiver in redistribute."""
        return int(self.capacity_factor * self.generated / self.nb) + 8

    @property
    def shuffle_rounds(self) -> int:
        """The paper's ceil(log_nb n): the least r with nb**r >= n."""
        r, reach = 0, 1
        while reach < self.n:
            reach *= self.nb
            r += 1
        return max(r, 1)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finaliser on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK32
    x = x ^ (x >> 15)
    x = (x * _M2_NEG) & MASK32
    return x ^ (x >> 16)


def mix32_int(x: int) -> int:
    x &= MASK32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def counter_uniform(seed: int, index: torch.Tensor, stream: int) -> torch.Tensor:
    """The uint32 drawn for counter `index` of `stream`."""
    s = (seed ^ (stream * GOLDEN)) & MASK32
    return mix32(mix32((index + s) & MASK32) ^ s)


def thresholds(spec: GraphSpec) -> Tuple[int, int, int]:
    """Cut points on the uint32 lattice: P(source bit 1) = c + d, and
    P(destination bit 1) = b / (a + b) after a 0, d / (c + d) after a 1."""
    two32 = float(1 << 32)
    return (int((spec.c + spec.d) * two32), int((spec.b / (spec.a + spec.b)) * two32),
            int((spec.d / (spec.c + spec.d)) * two32))


def rmat_block(spec: GraphSpec, start: int, count: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 (src, dst) of the edges with global ids [start, start + count):
    one quadrant a level, most significant bit first."""
    t_src, t_dst0, t_dst1 = thresholds(spec)
    idx = (torch.arange(count, dtype=torch.int64, device=device) + start) & MASK32
    src = torch.zeros(count, dtype=torch.int64, device=device)
    dst = torch.zeros(count, dtype=torch.int64, device=device)
    for level in range(spec.scale):
        src_bit = counter_uniform(spec.seed, idx, 2 * level) < t_src
        cut = torch.where(src_bit, t_dst1, t_dst0)
        dst_bit = counter_uniform(spec.seed, idx, 2 * level + 1) < cut
        src = (src << 1) | src_bit.to(torch.int64)
        dst = (dst << 1) | dst_bit.to(torch.int64)
    return src.to(torch.int32), dst.to(torch.int32)


def edge_blocks(spec: GraphSpec, block: int = EDGE_BLOCK) -> Iterator[Tuple[int, int]]:
    """(start, count) of the blocks that cover the m edges in order."""
    for start in range(0, spec.m, block):
        yield start, min(block, spec.m - start)


def paper_shuffle(spec: GraphSpec, device) -> torch.Tensor:
    """pv [n] int32 of the paper's shuffle: each round every shard orders its
    ids by mix32(id ^ salt_r), then sends slice j of its row to shard j."""
    nb, B = spec.nb, spec.owned
    buf = torch.arange(spec.n, dtype=torch.int64, device=device).reshape(nb, B)
    for r in range(spec.shuffle_rounds):
        salt = mix32_int((spec.seed + r * GOLDEN) & MASK32)
        buf = torch.gather(buf, 1, torch.argsort(mix32(buf ^ salt), dim=1))
        if nb > 1:
            buf = buf.reshape(nb, nb, B // nb).transpose(0, 1).reshape(nb, B)
    return buf.reshape(-1).to(torch.int32)


def feistel(x: torch.Tensor, key: int, nbits: int, rounds: int) -> torch.Tensor:
    """Keyed unbalanced Feistel bijection on [0, 2**nbits): the high half L
    and low half R; a round sets (L, R) = (R, (L ^ mix32(R ^ k_i)) masked to
    L's width)."""
    lo = nbits // 2
    v = x.to(torch.int64)
    L, R = v >> lo, v & ((1 << lo) - 1)
    wL, wR = nbits - lo, lo
    for i in range(rounds):
        k = mix32_int((key + (i + 1) * GOLDEN) & MASK32)
        L, R, wL, wR = R, (L ^ mix32(R ^ k)) & ((1 << wL) - 1), wR, wL
    return ((L << lo) | R).to(torch.int32)


def feistel_relabel(spec: GraphSpec, x: torch.Tensor) -> torch.Tensor:
    """The communication-free relabel of ids in [0, n), n a power of two."""
    nbits = max(1, (spec.n - 1).bit_length())
    return feistel(x, (spec.seed ^ FEISTEL_STREAM) & MASK32, nbits, spec.feistel_rounds)


def permutation(spec: GraphSpec, device) -> torch.Tensor:
    """pv [n] int32: vertex v is relabelled pv[v]."""
    if spec.permutation == "paper":
        return paper_shuffle(spec, device)
    if spec.permutation == "feistel":
        return feistel_relabel(spec, torch.arange(spec.n, dtype=torch.int32, device=device))
    raise ValueError(spec.permutation)


def relabelled_edges(spec: GraphSpec, pv: torch.Tensor,
                     block: int = EDGE_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """All m edges, relabelled through pv, int32 in generation order."""
    src = torch.empty(spec.m, dtype=torch.int32, device=pv.device)
    dst = torch.empty(spec.m, dtype=torch.int32, device=pv.device)
    for start, count in edge_blocks(spec, block):
        s, d = rmat_block(spec, start, count, pv.device)
        src[start:start + count] = pv[s.to(torch.int64)]
        dst[start:start + count] = pv[d.to(torch.int64)]
    return src, dst


def owned_by(spec: GraphSpec, src: torch.Tensor, dst: torch.Tensor,
             r: int) -> Dict[str, torch.Tensor]:
    """Shard r's owned edges after redistribute: each sender keeps, for each
    receiver, the first `capacity` of its edges in (source, generation)
    order and drops the rest; the receiver holds the kept edges sorted by
    source, equal sources in generation order.

    Returns its sorted sources and destinations, int32 [count], and the
    edges its senders dropped (int64 0-d).  With `spec.ties_by_dst` equal
    sources are ordered by destination instead: a control, not the spec."""
    B, eps, cap = spec.owned, spec.generated, spec.capacity
    mine = torch.nonzero((src >= r * B) & (src < (r + 1) * B)).reshape(-1)   # generation order
    s = src[mine].to(torch.int64)
    sender = mine // eps
    order = torch.sort(sender * spec.n + s, stable=True).indices
    per_sender = torch.bincount(sender, minlength=spec.nb)
    first = torch.cumsum(per_sender, 0) - per_sender
    rank = torch.arange(order.numel(), device=src.device) - first[sender[order]]
    keep = torch.zeros(order.numel(), dtype=torch.bool, device=src.device)
    keep[order] = rank < cap
    dropped = (~keep).sum()
    mine = mine[keep]
    del s, sender, order, rank, keep
    s = src[mine].to(torch.int64)
    d = dst[mine].to(torch.int64)
    key = s * spec.n + d if spec.ties_by_dst else s
    order = torch.sort(key, stable=True).indices
    return {"src": s[order].to(torch.int32), "dst": d[order].to(torch.int32), "dropped": dropped}


def csr_offsets(spec: GraphSpec, sorted_src: torch.Tensor, r: int) -> torch.Tensor:
    """Shard r's CSR offsets [B + 1]: row j starts after the edges whose
    local source is below j."""
    deg = torch.bincount(sorted_src.to(torch.int64) - r * spec.owned, minlength=spec.owned)
    return torch.cat([deg.new_zeros(1), torch.cumsum(deg, 0)]).to(torch.int32)


def global_csr(spec: GraphSpec, device,
               block: int = EDGE_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offv [n+1] int64, adjv [kept edges] int32) of the whole graph, rows
    in vertex order and each row's edges in the order redistribute keeps."""
    pv = permutation(spec, device)
    src, dst = relabelled_edges(spec, pv, block)
    del pv
    offv, adjv, base = [torch.zeros(1, dtype=torch.int64, device=device)], [], 0
    for r in range(spec.nb):
        own = owned_by(spec, src, dst, r)
        offv.append(csr_offsets(spec, own["src"], r)[1:].to(torch.int64) + base)
        base += own["dst"].numel()
        adjv.append(own["dst"])
        del own
    return torch.cat(offv), torch.cat(adjv)
