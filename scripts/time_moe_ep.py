#!/usr/bin/env python3
"""Times of one full-width MoE layer of `chip_smoke.py`'s serve_moe_ep
(deepseek-v2-lite-16b, bf16, seeded random weights) under the port's
expert-parallel dispatch over `chip_smoke.MOE_EP_MESH`, beside dense
dispatch, at an admission's prefill (1 x 2048 tokens: all_to_all, bf16 and
int8 payload) and at a decode wave (8 slots x 1 token: gather).

    python3 scripts/time_moe_ep.py [--src DIR] [--label NAME] [--reps N]

Imports `repro_torch` from DIR (default: `src/` of this checkout), so the same
script times the dispatch of another checkout unpacked into a git-ignored
directory: run one, the other, the other, the one in one call to compare two
versions on one card.  Inputs, weights and timing are this script's, whatever
DIR is.  For each case: the median over N calls (after 3 warm-up calls) of
the host's wall time of a call with a synchronisation after it, and of its
CUDA-event time, with the `bucket_hist` launches of one call.  A call is
host-bound where its wall time exceeds its event time by much.  Prints the
card's name and power limit, then one JSON line per case.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402

CASES = (("prefill, 1 x 2048 tokens", 1, 2048), ("decode wave, 8 slots", smoke.SERVE_SLOTS, 1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_moe_ep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_dist
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.nn import ParamFactory

    dev = torch.device("cuda", 0)
    print(smoke.nvidia_smi("name,power.limit"), flush=True)
    base = get_config(smoke.MOE_ARCH)
    g = torch.Generator(device=dev).manual_seed(smoke.SERVE_SEED)
    p = moe.init_moe(ParamFactory(g, dev, base.torch_dtype), base)

    def timed(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        before = ops.LAUNCHES["bucket_hist"]
        wall, events = [], []
        for _ in range(args.reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
            events.append(a.elapsed_time(b))
        return {"wall_ms": statistics.median(wall), "event_ms": statistics.median(events),
                "bucket_hist_launches": (ops.LAUNCHES["bucket_hist"] - before) / args.reps}

    for case, B, S in CASES:
        x = torch.randn(B, S, base.d_model, generator=g, device=dev).to(base.torch_dtype)
        for dispatch, int8 in (("dense", False), ("alltoall", False), ("alltoall", True)):
            if int8 and S % smoke.MOE_EP_MESH["model"]:
                continue                  # gather sends no payload
            cfg = base.with_(moe_dispatch_int8=int8)
            dist = None if dispatch == "dense" else make_dist(cfg, smoke.MOE_EP_MESH)
            row = timed(lambda: moe.moe_ffn(p, cfg, x, dist))
            print(json.dumps({"label": args.label, "case": case, "dispatch": dispatch,
                              "int8_payload": int8, **row}), flush=True)
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
