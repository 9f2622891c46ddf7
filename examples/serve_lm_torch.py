"""Serve a small LM with the PyTorch port's continuous-batching engine (twin
of examples/serve_lm.py): mixed prompt lengths, slot reuse, greedy + sampled
requests.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

`--device` defaults to cuda (and raises without it); `--device cpu` runs the
plain PyTorch path.
"""

import argparse

import numpy as np

from repro_torch.configs.base import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import init_all
from repro_torch.serve import Engine, Request, SamplingParams, generate_reference

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = resolve_device(ap.parse_args().device)

cfg = get_smoke_config("internlm2-1.8b")
params = init_all(cfg, device=device)
engine = Engine(cfg, params, max_batch=4, max_len=128, device=device)

rng = np.random.default_rng(0)
requests = []
for i in range(12):
    plen = int(rng.integers(1, 16))
    requests.append(Request(
        uid=i,
        prompt=rng.integers(0, cfg.vocab_size, plen).tolist(),
        max_new_tokens=16,
        sampling=SamplingParams(temperature=0.7 if i % 2 else 0.0,
                                top_k=20, seed=i),
    ))

out = engine.run(requests)
print(f"{len(out)} requests served in {engine.steps} engine steps on {device} "
      f"({engine.decode_tokens} decode tokens, "
      f"slot util {engine.decode_tokens / (engine.steps * 4):.2f})")

# spot-check continuous batching == sequential decoding
ref = generate_reference(cfg, params, requests[0], max_len=128, device=device)
assert out[0] == ref, "engine must match the single-request oracle"
print("req 0 (greedy):", out[0])
print("req 1 (t=0.7):", out[1])
print("engine == oracle ✓")
