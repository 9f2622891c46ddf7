"""The work each roofline and each `mfu` share is held to, counted from a
cell's sizes alone (`Window.sizes`), so that it reads the same whatever
implements the kernel: each input byte read once, each output byte written
once, and the integer operations of the plain reference's arithmetic
(`portbench/reference/graph.py`, `walks.py`) on uint32 values.

Operations are counted by the pipe that can execute them (`peaks.json`):
logic, compares and selects only on the ALU pipe, multiplies only on the
FMA pipe (IMAD), and adds and shifts on either (IADD3, SHF; IMAD.IADD,
IMAD.SHL, IMAD.HI by a power of two).  Each pipe does 64 a clock on an SM,
and the SM issues at most 128 a clock, so the least clocks of (alu, fma,
either) are max(alu / 64, fma / 64, (alu + fma + either) / 128).  Where one
instruction does two of the reference's steps, they count once: a
three-input LOP3 xors three values, and a predicated instruction sets one
bit of an endpoint.

Operation counts, once, as (alu, fma, either):
- mix32: three xors, two multiplies, three right shifts: (3, 2, 3).
- a counter uniform, mix32(mix32(index + salt) ^ salt): the add, two mix32,
  the salt's xor folded into the first mix32's last one: (6, 4, 7).
- one R-MAT level of one edge: two uniforms, the source compare, the select
  of the destination's cut point and its compare, and the bit set in each
  endpoint: (15, 8, 16), 39 in all.
- one Feistel round, (L, R) -> (R, (L ^ mix32(R ^ k)) & mask): the key's
  xor, mix32, and its last xor, L and the mask in two LOP3: (5, 2, 3);
  splitting an id into halves (shift, mask) and joining them: (1, 0, 2).
- one id into a histogram of k bins: the range compare, the count: (1, 0, 1).
- one key through the relabel gather: subtract the base, the range
  compare, the select: (2, 0, 1).
Every id, vertex and edge endpoint is an int32 (4 bytes).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class Ops(NamedTuple):
    """Integer operations by pipe: ALU only, FMA only, and either."""

    alu: float = 0
    fma: float = 0
    either: float = 0

    def __add__(self, other):
        return Ops(*(a + b for a, b in zip(self, other)))

    def __mul__(self, k):
        return Ops(*(k * a for a in self))

    __rmul__ = __mul__

    @property
    def total(self) -> float:
        return self.alu + self.fma + self.either


MIX32 = Ops(3, 2, 3)
UNIFORM = 2 * MIX32 + Ops(0, 0, 1)            # the add; the salt's xor folded in
RMAT_LEVEL = 2 * UNIFORM + Ops(3, 0, 2)
FEISTEL_ROUND = MIX32 + Ops(2, 0, 0)          # the key's xor; L and the mask: one more LOP3
FEISTEL_ENDS = Ops(1, 0, 2)
HIST_ID = Ops(1, 0, 1)
GATHER_KEY = Ops(2, 0, 1)
NONE = Ops()
ID = 4

Work = Tuple[float, Ops]             # (bytes, integer operations) of one call


def least_seconds(work: Work, peaks: Dict[str, float]) -> float:
    """The least time the card needs for `work`: the larger of its bytes
    over the memory bandwidth and its operations' least clocks on the
    integer pipes."""
    nbytes, ops = work
    pipe = peaks["int32_ops_per_s_per_pipe"]
    return max(nbytes / peaks["mem_bytes_per_s"],
               max(ops.alu, ops.fma, ops.total / 2) / pipe)


def share(work: Work, calls: int, measured_s: float, peaks: Dict[str, float]):
    """Per cent of the least time in the measured time, or None where
    nothing was measured."""
    if not measured_s or measured_s <= 0 or calls <= 0:
        return None
    return 100.0 * calls * least_seconds(work, peaks) / measured_s


def rmat_edges(sizes: dict) -> Work:
    """All m edges of a graph: 8 bytes written and scale levels each."""
    m = sizes["m"]
    return 2 * ID * m, RMAT_LEVEL * (sizes["scale"] * m)


def feistel_perm(sizes: dict) -> Work:
    """The communication-free permutation: pv's n ids and both endpoints
    of the m edges, each read and written once."""
    ids = sizes["n"] + 2 * sizes["m"]
    return 2 * ID * ids, (FEISTEL_ROUND * sizes["feistel_rounds"] + FEISTEL_ENDS) * ids


def relabel_gather(sizes: dict) -> Work:
    """The ring relabel of both fields: each of the 2m keys read and its
    label written, and pv (n ids) read once for each field."""
    m, n = sizes["m"], sizes["n"]
    return 2 * (2 * ID * m + ID * n), GATHER_KEY * (2 * m)


def bucket_hist_generate(sizes: dict) -> Work:
    """Redistribute's plan: the owner of each of the m edges counted once
    into nb bins, per sender nb counts written."""
    m, nb = sizes["m"], sizes["nb"]
    return ID * m + ID * nb * nb, HIST_ID * m


def bucket_hist_walks(sizes: dict) -> Work:
    """Each hop's plan: the owner of each live walker counted once into nb
    bins, per sender nb counts written."""
    ids = sizes["walkers"] * sizes["length"]
    nb = sizes["nb"]
    return ID * ids + ID * nb * nb * sizes["length"], HIST_ID * ids


def generate_returned(sizes: dict) -> Work:
    """Everything `generate` returns, each entry written once: pv (n), the
    relabelled edges (2m), the owned edges (m sources, m destinations, m
    validity bytes), the CSR (n + nb offsets, m adjacencies, nb counts)."""
    n, m, nb = sizes["n"], sizes["m"], sizes["nb"]
    nbytes = ID * n + 2 * ID * m + (2 * ID + 1) * m + ID * (n + nb) + ID * m + ID * nb
    return nbytes, NONE


def walks_least(sizes: dict) -> Work:
    """A walk's least traffic: each returned row written once (length + 1
    vertices, the id, the validity byte) for every walker, and per hop and
    walker the two offsets and the one adjacency entry it must read."""
    w, length = sizes["walkers"], sizes["length"]
    rows = w * (ID * (length + 1) + ID + 1)
    return rows + w * length * 3 * ID, NONE
