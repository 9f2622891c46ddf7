"""Roofline terms of a step, and the least time of a kernel's work, on one
H100 (counterpart of `repro/launch/roofline.py`).

Per (arch x shape) cell on one card:

  compute term    = flops of one step / the bf16 tensor-core peak
  memory term     = the least bytes one step must move / HBM bandwidth
  collective term = 0: one card has no link between chips (launch/mesh.py)

The reference reads flops and bytes from XLA's compiled module
(`from_compiled`, `collective_bytes_from_hlo`, through `hlo_cost.py`).
Eager PyTorch has no compiled module, so `from_measured` counts the flops of
one real step with `torch.utils.flop_counter.FlopCounterMode` (matrix
products, convolutions and attention; elementwise work is not counted) and
takes as bytes the least the step must move (`min_step_bytes`): every
parameter read once; for train also the gradients written and read once,
and AdamW's reads and writes of the master copy, both moments and the
parameters; for prefill the cache written once; for decode the cache read
once.  Activations are not counted: the bound is a floor, not a model.

`model_flops_for_cell` is the reference's, unchanged.  `kernel_bound` and
`flash_bound` are the bounds of `chip_smoke.py`'s kernel lines: the larger
of the bytes over the memory rate and the operations over their peak.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..train import tree
from .mesh import BF16_OPS_PER_S, INT_OPS_PER_SM_CLK, MEM_BYTES_PER_S


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_by_kind: Dict[str, int]
    chips: int
    model_flops: float              # 6*N*D (train) / 2*N_active*tokens (serve)
    peak_flops: float = BF16_OPS_PER_S
    hbm_bw: float = MEM_BYTES_PER_S
    ici_bw: Optional[float] = None  # no link on one card

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / self.ici_bw if self.ici_bw else 0.0

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step-time model: overlapped terms -> max() is the bound."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / the step's counted flops: the waste of capacity
        padding, dense dispatch and recomputation."""
        tot = self.flops_per_chip * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-flops utilization at the roofline bound."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * self.peak_flops * t)

    def as_dict(self) -> Dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_by_kind": self.coll_by_kind,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_bound_s": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops_for_cell(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D prefill, 2*N*B decode (active
    params for MoE)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq


def tree_bytes(t) -> int:
    """Bytes of every tensor leaf of a tree (meta tensors included)."""
    return sum(x.numel() * x.element_size() for x in tree.leaves(t) if torch.is_tensor(x))


def min_step_bytes(kind: str, params, opt=None, cache=None) -> float:
    """The least bytes one step moves (module docstring): train needs `opt`
    (an `optim.OptState`), prefill and decode `cache`."""
    p = tree_bytes(params)
    if kind == "train":
        # params read by the forward and written by AdamW; grads (the params'
        # dtype) written and read; master, mu, nu read and written
        return float(2 * p + 2 * p + 2 * (tree_bytes(opt.master) + tree_bytes(opt.mu)
                                           + tree_bytes(opt.nu)))
    if kind in ("prefill", "decode"):
        return float(p + tree_bytes(cache))
    raise ValueError(f"kind {kind!r}: train, prefill or decode")


def from_measured(step: Callable, args: Sequence, *, model_flops: float, kind: str,
                  chips: int = 1) -> Tuple[Roofline, Any]:
    """Run `step(*args)` once under FlopCounterMode and return (its Roofline,
    the step's output).  Flops are those counted; bytes `min_step_bytes` of
    the step's params, optimizer state (train: args[0] is a TrainState) or
    cache (prefill and decode: args[0] the params, args[2] the cache), taken
    before the step runs."""
    from torch.utils.flop_counter import FlopCounterMode

    if kind == "train":
        n_bytes = min_step_bytes(kind, args[0].params, opt=args[0].opt)
    else:
        n_bytes = min_step_bytes(kind, args[0], cache=args[2])
    with FlopCounterMode(display=False) as counter:
        out = step(*args)
    roof = Roofline(flops_per_chip=float(counter.get_total_flops()), bytes_per_chip=n_bytes,
                    coll_bytes_per_chip=0.0, coll_by_kind={}, chips=chips,
                    model_flops=model_flops)
    return roof, out


# ---------------------------------------------------------------------------
# kernel bounds (chip_smoke.py's kernel lines)
# ---------------------------------------------------------------------------


def int_ops_per_s(sms: int, clock_mhz: float) -> float:
    """The card's integer peak: SMs x INT_OPS_PER_SM_CLK x the SM clock."""
    return sms * INT_OPS_PER_SM_CLK * clock_mhz * 1e6


def kernel_bound(n_bytes: float, n_ops: float, ops_per_s: float) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of n_bytes over the memory
    rate and n_ops over `ops_per_s`."""
    t_bytes, t_ops = n_bytes / MEM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, offsets: torch.Tensor,
                causal: bool) -> Tuple[float, str]:
    """(ms, "bytes" or "operations") of the least time of flash attention on
    these inputs: each q and output element once, the K/V rows some query
    sees once; 2 (D + Dv) Hq operations per visible (query, key) pair at the
    bf16 tensor-core peak (q.k over D, p.v over Dv)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if causal:
        i = offsets.cpu().long()[:, None] + 1 + torch.arange(Sq)[None, :]
        pairs = int(i.clamp(0, Skv).sum())
        kv_rows = int((offsets.cpu().long() + Sq).clamp(0, Skv).sum())
    else:
        pairs, kv_rows = B * Sq * Skv, B * Skv
    n_bytes = q.element_size() * (B * Hq * Sq * (D + Dv) + Hkv * (D + Dv) * kv_rows)
    return kernel_bound(n_bytes, 2 * (D + Dv) * Hq * pairs, BF16_OPS_PER_S)
