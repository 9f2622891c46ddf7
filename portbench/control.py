"""The readings that the limits of `correct` are set from, on the card:

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--program]

For each seed it prints one JSON line with the numbers that a run compares
(`portbench/loops/<loop>.py::check`): under "control" those of the
reference put in the program's place with one guarantee broken (the
`control` of the configuration, or of the walk mix), and with
`--program` under "program" those of the program itself, after one call of
the cell's own size and set-up.  A sound program reads 0 on every number;
the control has to read above 0 on at least one.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(CHECKOUT), str(CHECKOUT / "src")]


def readings(cell, seed: int, device, program: bool) -> dict:
    from portbench import harness

    ctx = harness.Context(cell, device, seed, trace=False)
    out = {"seed": seed}
    if program:
        t = time.perf_counter()
        state = cell.loop.setup(ctx)
        res, _, _ = cell.loop.call(ctx, state, 0)
        ctx.sync()
        out["program"] = {k: c["value"] for k, c in cell.loop.check(ctx, state, res).items()}
        del res, state
        out["program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["control"] = {k: c["value"] for k, c in cell.loop.control(ctx, seed).items()}
    out["control_s"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from portbench import harness

    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, torch.device("cuda"), args.program)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
