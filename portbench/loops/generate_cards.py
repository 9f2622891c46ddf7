"""Closed loop over `repro_torch.core.pipeline.generate` with the graph's nb
shards placed on the cell's cards: one caller, each call a new graph of the
configuration's size with a seed drawn from the run's, each call waited for
on every card before the next.  The work of a call is its m edges.  The
last call's output is compared with the reference shard by shard, each
card's pieces computed on that card (`portbench/reference/graph_cards.py`);
a piece that does not lie on its shard's card counts as all mismatched.

The cards are cuda:0 .. cuda:D-1, D the configuration's `placement`
(the cell's chips).  Where fewer are present (a test on a
smaller machine; `run.py` refuses such a run) they are reused in turn, each
block still held apart.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterator, List

import torch

from portbench.harness import derive
from portbench.loops import common
from portbench.reference import graph_cards as GC


class State:
    seed = None           # graph seed of the last call
    devices: List[torch.device] = []


def cards(ctx) -> List[torch.device]:
    chips = ctx.config["placement"]["cards"]
    if ctx.device.type != "cuda":
        return [ctx.device] * chips
    present = torch.cuda.device_count()
    return [torch.device("cuda", i % present) for i in range(chips)]


def sizes(ctx) -> dict:
    out = common.graph_sizes(ctx.config)
    out["cards"] = ctx.config["placement"]["cards"]
    return out


def _sync(devices) -> None:
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _generate(ctx, devices, seed, hook=None):
    from repro_torch.core.pipeline import generate

    cfg = common.graph_config(ctx.config, seed)
    res = generate(cfg, shuffle_variant=ctx.config["program"]["shuffle_variant"],
                   device=devices, phase_hook=hook)
    return cfg, res


def setup(ctx) -> State:
    """One call of the cell's size on its cards warms up every shape the
    window uses; then each card's peak memory starts anew."""
    state = State()
    state.devices = cards(ctx)
    _, res = _generate(ctx, state.devices, derive(ctx.seed, "warmup", 0))
    del res
    _sync(state.devices)
    for dev in dict.fromkeys(state.devices):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
    return state


def call(ctx, state: State, i: int):
    state.seed = derive(ctx.seed, "graph", i)
    cfg, res = _generate(ctx, state.devices, state.seed, ctx.mark)
    _sync(state.devices)
    lost = int(res.dropped_relabel) + int(res.dropped_redistribute)
    return res, {"edges": cfg.m}, lost > 0


def program_pieces(res, nb: int) -> Iterator:
    """(card, name, piece) of the program's `GraphResult`, as
    `graph_cards.card_pieces` lays them out."""
    D = len(res.pv)
    S = nb // D
    for c in range(D):
        yield c, "pv", res.pv[c]
        yield c, "src", res.src[c]
        yield c, "dst", res.dst[c]
    for c in range(D):
        rows = [t[c].reshape(S, -1) for t in (res.owned.src, res.owned.dst, res.owned.valid,
                                              res.csr.offv, res.csr.adjv)]
        for i in range(S):
            for name, t in zip(("owned_src", "owned_dst", "owned_valid", "offv", "adjv"), rows):
                yield c, name, t[i]
            yield c, "num_edges", res.csr.num_edges[c][i:i + 1]
    yield 0, "dropped", (res.dropped_relabel + res.dropped_redistribute).reshape(1)


CHUNK = 1 << 26           # entries compared at a time, so that a comparison holds little memory


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Entries of `got` that differ from `want`; all of them where the
    shapes or the devices differ."""
    if tuple(got.shape) != tuple(want.shape) or got.device != want.device:
        return max(got.numel(), want.numel())
    a, b = got.reshape(-1), want.reshape(-1)
    return sum(int((a[i:i + CHUNK] != b[i:i + CHUNK]).sum()) for i in range(0, a.numel(), CHUNK))


def compare(got: Iterator, want: Iterator) -> Dict[str, int]:
    """Mismatched entries by piece name, summed over the cards; a piece on
    another device than the reference's counts whole."""
    out: Dict[str, int] = {}
    for (card, name, a), (card_b, name_b, b) in zip(got, want):
        if (card, name) != (card_b, name_b):
            raise ValueError(f"pieces out of step: {card} {name} against {card_b} {name_b}")
        out[name] = out.get(name, 0) + mismatches(a, b)
        del a, b
    return out


def _on_program_streams(devices):
    """The streams the program runs its cards' work on, so that the check
    reuses the memory a call leaves cached there."""
    from repro_torch.distributed.collectives import card_streams, place

    return card_streams(place(len(devices), devices))


def _spec(ctx, seed: int, **changed):
    changed = dict(changed)
    placement = changed.pop("placement", "consecutive")
    return common.spec(ctx.config, seed, **changed), placement


def check(ctx, state: State, res) -> dict:
    for c, dev in enumerate(state.devices):
        if dev.type == "cuda":
            print(f"portbench: card {c} ({dev}) peak {torch.cuda.max_memory_allocated(dev) / 2**30:.3f}"
                  f" GiB, allocator retries {torch.cuda.memory_stats(dev)['num_alloc_retries']}",
                  file=sys.stderr, flush=True)
    s, placement = _spec(ctx, state.seed)
    with _on_program_streams(state.devices):
        return common.exact(compare(program_pieces(res, s.nb),
                                    GC.card_pieces(s, state.devices, placement)))


def control(ctx, seed: int) -> dict:
    """The reference in the program's place with the guarantee that the
    configuration's `control` breaks (its `reference` fields replace the
    graph's), judged as a run is."""
    devices = cards(ctx)
    s, placement = _spec(ctx, seed)
    broken, broken_placement = _spec(ctx, seed, **ctx.config["control"]["reference"])
    with _on_program_streams(devices):
        return common.exact(compare(GC.card_pieces(broken, devices, broken_placement),
                                    GC.card_pieces(s, devices, placement)))
