"""Fault tolerance + straggler mitigation for the training runtime (twin of
`repro/train/fault.py`: plain Python and numpy apart from checkpointing).

Mechanisms (each unit-tested with simulated failures, tests/test_torch_fault.py):

  * run_with_restarts  — supervisor loop: run the train function; on any
    WorkerFailure (or crash exception from user code), restore the newest
    valid checkpoint and continue.  Survives corrupt-latest checkpoints
    (falls back one step) and mid-save crashes (tmp dirs never trusted).
  * HeartbeatMonitor   — per-worker heartbeat timestamps; workers silent for
    > timeout are declared dead; on death the caller restores the newest
    checkpoint (whole logical arrays: any device takes them).
  * StragglerPolicy    — per-step worker timings -> microbatch reassignment
    plan: workers slower than `slow_factor` x median shed microbatches to the
    fastest workers (the grad-accum loop consumes the plan; data order is
    deterministic because assignment is a pure function of the timing vector).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import checkpoint as ckpt_lib


class WorkerFailure(RuntimeError):
    """Raised (or injected by tests) when a worker dies mid-step."""


# ---------------------------------------------------------------------------
# Restart supervision
# ---------------------------------------------------------------------------


def run_with_restarts(
    train_fn: Callable[[object, int], object],
    *,
    ckpt_dir: str,
    init_state,
    total_steps: int,
    save_every: int,
    max_restarts: int = 10,
    keep: int = 3,
    on_restart: Optional[Callable[[int, Exception], None]] = None,
):
    """Run `state = train_fn(state, step)` for steps [resume..total_steps).

    Checkpoints every `save_every`; on failure restores the newest valid
    checkpoint and retries from its step.  Returns the final state.  (The
    reference's `shardings` argument has no counterpart on one card.)
    """
    state, start = ckpt_lib.restore_latest(ckpt_dir, init_state)
    if state is None:
        state, start = init_state, -1
    step = start + 1
    restarts = 0
    while step < total_steps:
        try:
            state = train_fn(state, step)
            if (step + 1) % save_every == 0 or step + 1 == total_steps:
                ckpt_lib.save(ckpt_dir, step, state, keep=keep)
            step += 1
        except WorkerFailure as e:  # pragma: no cover - exercised via tests
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart:
                on_restart(step, e)
            state, last = ckpt_lib.restore_latest(ckpt_dir, init_state)
            if state is None:
                state, last = init_state, -1
            step = last + 1
    return state


# ---------------------------------------------------------------------------
# Heartbeats
# ---------------------------------------------------------------------------


class HeartbeatMonitor:
    """Tracks worker liveness from heartbeat timestamps.

    On a real cluster each worker posts heartbeats to shared storage / the
    coordinator; here it is an in-process registry with an injectable clock
    so tests can advance time deterministically.
    """

    def __init__(self, workers: Sequence[int], timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self._clock = clock
        self._last: Dict[int, float] = {w: clock() for w in workers}

    def beat(self, worker: int):
        self._last[worker] = self._clock()

    def dead(self) -> List[int]:
        now = self._clock()
        return [w for w, t in sorted(self._last.items()) if now - t > self.timeout]

    def alive(self) -> List[int]:
        now = self._clock()
        return [w for w, t in sorted(self._last.items()) if now - t <= self.timeout]


# ---------------------------------------------------------------------------
# Straggler mitigation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    slow_factor: float = 1.5      # slower than this x median => straggler
    min_share: int = 1            # stragglers keep at least this many microbatches

    def plan(self, step_times: Sequence[float], microbatches: int) -> List[int]:
        """Per-worker microbatch counts for the NEXT step.

        Work is shifted from stragglers to the fastest workers proportionally
        to measured throughput (1/time); totals always sum to `microbatches`.
        """
        t = np.asarray(step_times, dtype=np.float64)
        n = len(t)
        assert microbatches >= n * self.min_share
        med = np.median(t)
        straggler = t > self.slow_factor * med
        if not straggler.any():
            base = microbatches // n
            plan = [base] * n
            for i in range(microbatches - base * n):
                plan[i] += 1
            return plan
        # throughput-proportional assignment, floor at min_share for stragglers
        speed = 1.0 / np.maximum(t, 1e-9)
        raw = speed / speed.sum() * microbatches
        plan = np.maximum(np.floor(raw).astype(int), self.min_share)
        # fix the total: give leftovers to the fastest, take from the slowest
        order_fast = list(np.argsort(t))
        i = 0
        while plan.sum() < microbatches:
            plan[order_fast[i % n]] += 1
            i += 1
        order_slow = order_fast[::-1]
        i = 0
        while plan.sum() > microbatches:
            w = order_slow[i % n]
            if plan[w] > self.min_share:
                plan[w] -= 1
            i += 1
        return [int(x) for x in plan]
