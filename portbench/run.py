"""Run one cell of the benchmark once, on the card, and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`, and last `checks`: each number compared with
the reference beside its limit); the same numbers close standard error.
With `--trace 0` the metrics are the cell's end-to-end ones, with
`--trace 1` its per-layer ones, read from a profiled window.

Without a CUDA device, with fewer devices than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a nonzero code.  The kernels build into
`build/kernels/` inside the checkout on its first run.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# the checkout's root (for `portbench`) and `src` (for the program), in place
# of this directory, whose module names would shadow the standard library's
sys.path[0:1] = [str(CHECKOUT), str(CHECKOUT / "src")]


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    stamps = [("import torch", time.perf_counter())]
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    stamps.append(("driver", time.perf_counter()))
    from portbench import harness

    cell = harness.load_cell(args.workload)
    stamps.append(("harness", time.perf_counter()))
    if torch.cuda.device_count() < cell.entry["chips"]:
        log(f"{args.workload} needs {cell.entry['chips']} devices, "
            f"{torch.cuda.device_count()} present")
        return 2
    torch.empty(1, device="cuda")
    stamps.append(("context", time.perf_counter()))
    log("start: " + ", ".join(f"{name} {b - a:.3f} s" for (name, b), a in
                               zip(stamps, [STARTED] + [t for _, t in stamps])))
    line, checks = harness.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                               device="cuda", started=STARTED, log=log)
    loaded = harness.forbidden_modules()
    if loaded:
        log(f"JAX or the JAX package was loaded: {', '.join(loaded)}")
        return 3
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
