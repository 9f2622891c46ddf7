"""Token sampling: greedy / temperature / top-k, deterministic per request.

Host-side numpy (engine samples a handful of scalars per step; keeping it off
the device lets the jitted decode step stay sampling-agnostic and reusable
across requests with different sampling params).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 -> greedy
    top_k: int = 0             # 0 -> no top-k filter
    seed: int = 0


def sample(logits: np.ndarray, params: SamplingParams, step: int) -> int:
    """One token from unnormalized logits [V]."""
    logits = np.asarray(logits, np.float64)
    if params.temperature <= 0.0:
        return int(np.argmax(logits))
    logits = logits / params.temperature
    if params.top_k > 0 and params.top_k < logits.shape[0]:
        kth = np.partition(logits, -params.top_k)[-params.top_k]
        logits = np.where(logits >= kth, logits, -np.inf)
    logits -= logits.max()
    p = np.exp(logits)
    p /= p.sum()
    rng = np.random.default_rng((params.seed * 1_000_003 + step) & 0x7FFFFFFF)
    return int(rng.choice(logits.shape[0], p=p))
