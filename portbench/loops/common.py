"""What the loops share: the program's `GraphConfig` and the reference's
`GraphSpec` built from one configuration file, and the piece-by-piece
comparison of a generated graph with the reference's."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from portbench.reference import graph as G


def permutation_of(config: dict) -> str:
    return "paper" if config["program"]["shuffle_variant"] == "paper" else "feistel"


def spec(config: dict, seed: int, **changed) -> G.GraphSpec:
    g, p = config["graph"], config["program"]
    fields = dict(scale=g["scale"], edge_factor=g["edge_factor"], nb=g["nb"], a=g["a"], b=g["b"],
                  c=g["c"], d=g["d"], permutation=permutation_of(config),
                  feistel_rounds=p["feistel_rounds"], capacity_factor=p["capacity_factor"],
                  seed=seed)
    fields.update(changed)
    return G.GraphSpec(**fields)


def graph_config(config: dict, seed: int):
    """The program's configuration of the graph with seed `seed`."""
    from repro_torch.core.types import GraphConfig

    g, p = config["graph"], config["program"]
    return GraphConfig(scale=g["scale"], edge_factor=g["edge_factor"], nb=g["nb"], a=g["a"],
                       b=g["b"], c=g["c"], d=g["d"], capacity_factor=p["capacity_factor"],
                       shuffle_rounds=p["shuffle_rounds"], relabel_variant=p["relabel_variant"],
                       csr_variant=p["csr_variant"], feistel_rounds=p["feistel_rounds"], seed=seed)


def graph_sizes(config: dict) -> dict:
    s = spec(config, 0)
    return {"scale": s.scale, "n": s.n, "m": s.m, "nb": s.nb, "capacity": s.capacity,
            "permutation": s.permutation, "feistel_rounds": s.feistel_rounds,
            "shuffle_rounds": s.shuffle_rounds}


Piece = Tuple[str, torch.Tensor]


def reference_pieces(s: G.GraphSpec, device) -> Iterator[Piece]:
    """The reference's graph, in the order and layout of `program_pieces`:
    pv, the relabelled edges, then per shard its owned edges (sources,
    destinations, validity, over nb * capacity slots) and CSR (offsets,
    adjacency over the same slots, edge count), then the dropped count."""
    pv = G.permutation(s, device)
    yield "pv", pv
    src, dst = G.relabelled_edges(s, pv)
    del pv
    yield "src", src
    yield "dst", dst
    slots = s.nb * s.capacity
    dropped = 0
    for r in range(s.nb):
        own = G.owned_by(s, src, dst, r)
        count = own["src"].numel()
        pad = torch.zeros(slots - count, dtype=torch.int32, device=device)
        yield "owned_src", torch.cat([own["src"], pad])
        yield "owned_dst", torch.cat([own["dst"], pad])
        yield "owned_valid", torch.arange(slots, device=device) < count
        yield "offv", G.csr_offsets(s, own["src"], r)
        yield "adjv", torch.cat([own["dst"], pad])
        yield "num_edges", torch.tensor([count], dtype=torch.int32, device=device)
        dropped += int(own["dropped"])
        del own, pad
    yield "dropped", torch.tensor([dropped], dtype=torch.int32, device=device)


def program_pieces(res, nb: int) -> Iterator[Piece]:
    """The program's `GraphResult` as `reference_pieces` lays it out."""
    yield "pv", res.pv
    yield "src", res.src
    yield "dst", res.dst
    rows = [t.reshape(nb, -1) for t in (res.owned.src, res.owned.dst, res.owned.valid,
                                        res.csr.offv, res.csr.adjv)]
    for r in range(nb):
        for name, t in zip(("owned_src", "owned_dst", "owned_valid", "offv", "adjv"), rows):
            yield name, t[r]
        yield "num_edges", res.csr.num_edges[r:r + 1]
    yield "dropped", (res.dropped_relabel + res.dropped_redistribute).reshape(1)


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Entries of `got` that differ from `want`; all of them where the
    shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return max(got.numel(), want.numel())
    return int((got.to(want.device) != want).sum())


def compare(got: Iterator[Piece], want: Iterator[Piece]) -> Dict[str, int]:
    """Mismatched entries by piece name, summed over the shards."""
    out: Dict[str, int] = {}
    for (name, a), (name_b, b) in zip(got, want):
        if name != name_b:
            raise ValueError(f"pieces out of step: {name} against {name_b}")
        out[name] = out.get(name, 0) + mismatches(a, b)
        del a, b
    return out


def exact(numbers: Dict[str, int]) -> Dict[str, dict]:
    """Each number with its limit: every comparison here is exact."""
    return {name: {"value": value, "limit": 0} for name, value in numbers.items()}
