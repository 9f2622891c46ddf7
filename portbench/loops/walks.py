"""Closed loop over `repro_torch.data.walks.distributed_walks` on one graph:
set-up generates the graph from the run's seed and keeps its CSR on the
device; each call walks the traffic's walkers over it with a new walk seed
drawn from the run's, and is waited for before the next.  The work of a
call is its live walkers times the walk length.  The last call's rows
(every walker's history, validity and id) are compared with the reference,
which builds the graph again from the seed."""

from __future__ import annotations

import torch

from portbench.harness import derive
from portbench.loops import common
from portbench.reference import graph as G
from portbench.reference import walks as W

BLOCK_ROWS = 1 << 22          # rows compared at once where no walker should be


class State:
    graph_seed = None
    walk_seed = None          # of the last call
    cfg = offv = adjv = None


def sizes(ctx) -> dict:
    t, nb = ctx.traffic, ctx.config["graph"]["nb"]
    return dict(common.graph_sizes(ctx.config), walkers_per_shard=t["walkers_per_shard"],
                walkers=nb * t["walkers_per_shard"], length=t["length"],
                capacity_factor=t["capacity_factor"])


def _walk(ctx, state: State, length: int, seed: int):
    from repro_torch.data.walks import distributed_walks

    t = ctx.traffic
    return distributed_walks(state.cfg, state.offv, state.adjv, length=length, seed=seed,
                             walkers_per_shard=t["walkers_per_shard"],
                             capacity_factor=t["capacity_factor"])


def setup(ctx) -> State:
    """The graph and its CSR, a short walk at the cell's walker count (every
    kernel and shape of a hop), and the window's two largest buffers (the
    rows [nb, nb * cp, length + 4] of the vertex type, and their exchanged
    copy) allocated and freed, so that the caching allocator holds them and
    the window's first call allocates as the later ones do."""
    from repro_torch.core.pipeline import generate

    state = State()
    state.graph_seed = derive(ctx.seed, "graph")
    state.cfg = common.graph_config(ctx.config, state.graph_seed)
    res = generate(state.cfg, shuffle_variant=ctx.config["program"]["shuffle_variant"],
                   device=ctx.device)
    state.offv, state.adjv = res.csr.offv, res.csr.adjv
    del res
    out = _walk(ctx, state, ctx.traffic["warmup_length"], derive(ctx.seed, "warmup"))
    del out
    t, nb = ctx.traffic, state.cfg.nb
    _, rows = W.rows(nb, t["walkers_per_shard"], t["capacity_factor"])
    shape = (nb, rows, t["length"] + 4)
    held = [torch.empty(shape, dtype=state.cfg.vertex_dtype, device=ctx.device) for _ in range(2)]
    ctx.sync()
    del held
    return state


def call(ctx, state: State, i: int):
    state.walk_seed = derive(ctx.seed, "walk", i)
    out = _walk(ctx, state, ctx.traffic["length"], state.walk_seed)
    live = int(out[1].sum())
    return out, {"hops": live * ctx.traffic["length"]}, int(out[3]) > 0


def reference(ctx, state: State, csr=None, **rule) -> dict:
    """The reference's walk of the state's seeds; `csr` is the reference's
    global CSR of that graph, built when not given; `rule` changes the
    walk's rule (a control)."""
    t = ctx.traffic
    s = common.spec(ctx.config, state.graph_seed)
    offv, adjv = csr or G.global_csr(s, ctx.device)
    return W.walks(offv, adjv, n=s.n, nb=s.nb, walkers=t["walkers_per_shard"], length=t["length"],
                   seed=state.walk_seed, capacity_factor=t["capacity_factor"], **rule)


def compare(got, want: dict) -> dict:
    """Mismatches of the rows (hist, valid, wid, dropped) against the
    reference's live walkers; a row no walker holds must be all zeros."""
    hist, valid, wid, dropped = got
    total, rows = want["total_rows"], want["rows"]
    want_valid = torch.zeros(total, dtype=torch.bool, device=rows.device)
    want_valid[rows] = True
    want_wid = torch.zeros(total, dtype=torch.int32, device=rows.device)
    want_wid[rows] = want["wid"]
    out = {"valid": common.mismatches(valid, want_valid), "wid": common.mismatches(wid, want_wid)}
    if tuple(hist.shape) != (total, want["hist"].shape[1]):
        out["hist"] = max(hist.numel(), total * want["hist"].shape[1])
    else:
        n = common.mismatches(hist[rows.to(hist.device)], want["hist"])
        blank = ~want_valid
        for lo in range(0, total, BLOCK_ROWS):
            n += int((hist[lo:lo + BLOCK_ROWS][blank[lo:lo + BLOCK_ROWS]] != 0).sum())
        out["hist"] = n
    out["dropped"] = abs(int(dropped) - int(want["dropped"]))
    return common.exact(out)


def check(ctx, state: State, out) -> dict:
    state.offv = state.adjv = None          # the program's graph goes before the reference's
    return compare(out, reference(ctx, state))


def control(ctx, seed: int) -> dict:
    """The reference in the program's place with the walk rule that the
    traffic's `control` breaks (its `reference` arguments), judged as a run
    is."""
    state = State()
    state.graph_seed, state.walk_seed = derive(seed, "graph"), derive(seed, "walk", 0)
    csr = G.global_csr(common.spec(ctx.config, state.graph_seed), ctx.device)
    ctl = reference(ctx, state, csr, **ctx.traffic["control"]["reference"])
    rows = W.as_rows(ctl)
    got = (rows["hist"], rows["valid"], rows["wid"], ctl["dropped"])
    del ctl, rows
    return compare(got, reference(ctx, state, csr))
