"""Closed loop over `repro_torch.core.pipeline.generate`: one caller, each
call a new graph of the configuration's size with a seed drawn from the
run's, each call waited for before the next.  The work of a call is its m
edges.  The last call's whole output is compared with the reference."""

from __future__ import annotations

from portbench.harness import derive
from portbench.loops import common


class State:
    seed = None           # graph seed of the last call


def sizes(ctx) -> dict:
    return common.graph_sizes(ctx.config)


def setup(ctx) -> State:
    """One call of the cell's size warms up every shape the window uses."""
    from repro_torch.core.pipeline import generate

    cfg = common.graph_config(ctx.config, derive(ctx.seed, "warmup", 0))
    res = generate(cfg, shuffle_variant=ctx.config["program"]["shuffle_variant"],
                   device=ctx.device)
    ctx.sync()
    del res
    return State()


def call(ctx, state: State, i: int):
    from repro_torch.core.pipeline import generate

    state.seed = derive(ctx.seed, "graph", i)
    cfg = common.graph_config(ctx.config, state.seed)
    res = generate(cfg, shuffle_variant=ctx.config["program"]["shuffle_variant"],
                   device=ctx.device, phase_hook=ctx.mark)
    lost = int(res.dropped_relabel) + int(res.dropped_redistribute)
    return res, {"edges": cfg.m}, lost > 0


def check(ctx, state: State, res) -> dict:
    s = common.spec(ctx.config, state.seed)
    return common.exact(common.compare(common.program_pieces(res, s.nb),
                                       common.reference_pieces(s, ctx.device)))


def control(ctx, seed: int) -> dict:
    """The reference in the program's place with the guarantee that the
    configuration's `control` breaks (its `reference` fields replace the
    graph's), judged as a run is."""
    s = common.spec(ctx.config, seed)
    broken = common.spec(ctx.config, seed, **ctx.config["control"]["reference"])
    return common.exact(common.compare(common.reference_pieces(broken, ctx.device),
                                       common.reference_pieces(s, ctx.device)))
