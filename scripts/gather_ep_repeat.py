#!/usr/bin/env python3
"""Is the expert-parallel gather route repeatable on the card?  One
full-width MoE layer of deepseek-v2-lite-16b (bf16, seeded random weights)
under the port's dispatch over `chip_smoke.MOE_EP_MESH`, on a decode wave
(`chip_smoke.SERVE_SLOTS` tokens x 1: the gather route), run N times.

    python3 scripts/gather_ep_repeat.py [--src DIR] [--label NAME] [--reps N]

Imports `repro_torch` from DIR (default: `src/` of this checkout), so it
checks another checkout unpacked into a git-ignored directory beside this
one.  Six experts over four shards put at least two of every token's experts
on one shard, whose partial row then sums several records.  Prints the
card's name and power limit, then one JSON line: how many tokens have two
experts on a shard, the runs whose output differs from the first run's, and
the first element that differs (row, column, both values).  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gather_ep_repeat: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_dist
    from repro_torch.models import moe
    from repro_torch.models.nn import ParamFactory

    dev = torch.device("cuda", 0)
    print(smoke.nvidia_smi("name,power.limit"), flush=True)
    cfg = get_config(smoke.MOE_ARCH)
    dist = make_dist(cfg, smoke.MOE_EP_MESH)
    g = torch.Generator(device=dev).manual_seed(smoke.SERVE_SEED)
    p = moe.init_moe(ParamFactory(g, dev, cfg.torch_dtype), cfg)
    x = torch.randn(smoke.SERVE_SLOTS, 1, cfg.d_model, generator=g, device=dev).to(cfg.torch_dtype)
    with torch.no_grad():
        owners = torch.sort(moe.route(p, cfg, x.reshape(-1, cfg.d_model))[1]
                            // (cfg.num_experts // dist.ep), dim=1).values
        ys = [moe.moe_ffn(p, cfg, x, dist)[0].reshape(-1, cfg.d_model) for _ in range(args.reps)]
    differing = [i for i, y in enumerate(ys) if not torch.equal(y, ys[0])]
    first = None
    if differing:
        y = ys[differing[0]]
        row, col = (y != ys[0]).nonzero()[0].tolist()
        first = {"run": differing[0], "row": row, "column": col,
                 "first_run": float(ys[0][row, col]), "that_run": float(y[row, col])}
    print(json.dumps({"label": args.label, "reps": args.reps, "tokens": x.shape[0],
                      "tokens_with_two_experts_on_a_shard":
                          int((owners[:, 1:] == owners[:, :-1]).any(dim=1).sum()),
                      "runs_differing_from_first": len(differing),
                      "first_difference": first}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
