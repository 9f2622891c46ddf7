"""Serving driver (twin of `repro/launch/serve.py`): the continuous-batching
engine over a freshly initialised LM, fed a stream of random requests.

    PYTHONPATH=src python -m repro_torch.launch.serve [--device cpu]

Takes the reference's arguments plus `--device` (default `cuda`); `--arch`
names an architecture of a family the engine serves, dense, moe, ssm or
hybrid (its smoke configuration is served), e.g. `--arch mamba2-780m
--device cpu` or `--arch zamba2-2.7b --device cpu`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs.base import get_smoke_config
from ..models.registry import init_all
from ..serve import Engine, Request, SamplingParams


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    params = init_all(cfg, seed=args.seed, device=args.device)
    engine = Engine(cfg, params, max_batch=args.max_batch,
                    max_len=args.max_len, device=args.device)

    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(1, 12))
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        reqs.append(Request(
            uid=i, prompt=prompt, max_new_tokens=args.max_new,
            sampling=SamplingParams(temperature=args.temperature, seed=i)))

    t0 = time.time()
    out = engine.run(reqs)
    dt = time.time() - t0
    total_new = sum(len(v) for v in out.values())
    print(f"served {len(out)} requests, {total_new} tokens, "
          f"{engine.steps} engine steps, {dt:.1f}s "
          f"({total_new / max(dt, 1e-9):.1f} tok/s)")
    print(f"prefill tokens {engine.prefill_tokens}, "
          f"decode tokens {engine.decode_tokens}, "
          f"slot utilization {engine.decode_tokens / max(1, engine.steps * args.max_batch):.2f}")
    for uid in sorted(out)[:4]:
        print(f"  req {uid}: {out[uid][:12]}")
    return out


if __name__ == "__main__":
    main()
