"""Continuous-batching serving engine (twin of `repro/serve/engine.py`): the
dense, moe, ssm and hybrid families, the reference's list.

Iteration-level scheduling on a fixed slot grid, as in the reference:

  * the decode cache is batched [L, max_batch, ...] with per-slot lengths
    (an int32 [max_batch] tensor), so sequences of different lengths decode
    in one wave;
  * a finished slot is reused at once: the next waiting request's prompt is
    prefilled into that slot's rows of the cache, zeroed first, so K/V and
    the conv and ssm states start from zero (the reference prefills a fresh
    one-slot cache and splices it in; every cache leaf here has its batch
    on dimension 1, so the splice is a slice);
  * prefill takes the first P-1 prompt tokens; the last one enters through
    the shared decode wave, which gives the logits of the first sampled
    token;
  * for the attention families (dense, moe) prefill lengths are bucketed
    to powers of two (as the reference does to bound recompilation):
    right-padding is safe because the slot's length is reset to the true
    prompt length afterwards, and each decode writes position `length`
    before it attends.  SSM state integrates every token it sees, so the
    ssm and hybrid families prefill at the exact length.

Every decode wave runs all max_batch slots, idle ones included; their
lengths grow past max_len and their cache writes clamp to the last position,
as the reference's do (see `models/layers.py`).

`dist` (a `DistContext`, `distributed/sharding.py::make_dist`) goes to every
prefill and decode wave, as in the reference: with moe_dispatch "alltoall"
a MoE model's experts are dispatched over dist.ep expert shards (a prefill
of S % ep == 0 and S >= ep tokens by all_to_all, a decode wave by gather).
The batch is split over dist.dp data shards, which must divide max_batch
and the one-sequence prefill, so the Engine serves at dp 1.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.nn import DistContext
from ..models.registry import ModelApi, get_model
from .sampling import SamplingParams, sample

SUPPORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pending: int = 0          # next token to feed through decode
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def free(self) -> bool:
        return self.req is None


def _make_cache(cfg, batch: int, max_len: int, device):
    """Decode cache with per-sequence lengths [batch]."""
    cache = get_model(cfg).init_cache(cfg, batch, max_len, device)
    cache["length"] = torch.zeros(batch, dtype=torch.int32, device=device)
    return cache


def _bind(api: ModelApi, dist: Optional[DistContext]) -> ModelApi:
    """The model's prefill and decode_step with `dist` bound, as the
    reference's jitted calls bind it."""
    if dist is None:
        return api
    return api._replace(prefill=functools.partial(api.prefill, dist=dist),
                        decode_step=functools.partial(api.decode_step, dist=dist))


def _tokens(rows, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(rows, np.int32)).to(device)


class Engine:
    def __init__(self, cfg, params, *, max_batch: int = 8, max_len: int = 512,
                 bucket_prefill: bool = True, device="cuda",
                 dist: Optional[DistContext] = None):
        if cfg.family not in SUPPORTED_FAMILIES:
            raise ValueError(f"Engine serves the families {SUPPORTED_FAMILIES}, "
                             f"not {cfg.family!r}")
        if dist is not None and dist.dp != 1:
            raise ValueError(f"{dist.dp} data shards must divide max_batch {max_batch} and "
                             f"the one-sequence prefill: the Engine serves at dp 1")
        self.device = resolve_device(device)
        self.dist = dist
        self.cfg = cfg
        self.params = params
        self.api = _bind(get_model(cfg), dist)
        self.max_batch = max_batch
        self.max_len = max_len
        # SSM state integrates pad tokens -> exact-length prefill there
        self.bucket_prefill = bucket_prefill and cfg.family in ("dense", "moe")
        self.cache = _make_cache(cfg, max_batch, max_len, self.device)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.waiting: List[Request] = []
        self.finished: Dict[int, List[int]] = {}
        self.steps = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0

    # -- request intake ----------------------------------------------------

    def add_request(self, req: Request):
        if len(req.prompt) < 1:
            raise ValueError("empty prompt")
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(f"prompt {len(req.prompt)} + max_new_tokens {req.max_new_tokens} "
                             f"> max_len {self.max_len}")
        self.waiting.append(req)

    # -- scheduling --------------------------------------------------------

    def _prefill_len(self, n: int) -> int:
        if not self.bucket_prefill:
            return n
        p = 1
        while p < n:
            p <<= 1
        return min(p, self.max_len)

    def _admit(self, slot_idx: int, req: Request):
        slot = self.slots[slot_idx]
        slot.req = req
        slot.generated = []
        prompt = list(req.prompt)
        n_pre = len(prompt) - 1            # last prompt token goes through decode
        rows = slice(slot_idx, slot_idx + 1)
        # every leaf's slot rows (batch axis 1 of [L, B, ...] or [sites, B, ...];
        # 0 of length [B])
        one = {name: buf[rows] if name == "length" else buf[:, rows]
               for name, buf in self.cache.items()}
        for buf in one.values():
            buf.zero_()
        if n_pre > 0:
            plen = self._prefill_len(n_pre)
            toks = np.zeros((1, plen), np.int32)
            toks[0, :n_pre] = prompt[:n_pre]
            self.api.prefill(self.cfg, self.params, {"tokens": _tokens(toks, self.device)}, one)
            one["length"].fill_(n_pre)     # the true length masks the right-padding
            self.prefill_tokens += n_pre
        slot.pending = prompt[-1]

    def _retire(self, slot_idx: int):
        slot = self.slots[slot_idx]
        self.finished[slot.req.uid] = slot.generated
        slot.req = None

    # -- one engine iteration ----------------------------------------------

    def step(self) -> bool:
        """Admit what fits, run one decode wave.  False when fully idle."""
        for i, slot in enumerate(self.slots):
            if slot.free and self.waiting:
                self._admit(i, self.waiting.pop(0))
        active = [i for i, s in enumerate(self.slots) if not s.free]
        if not active:
            return False

        tokens = np.zeros((self.max_batch, 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slots[i].pending
        logits, self.cache = self.api.decode_step(
            self.cfg, self.params, _tokens(tokens, self.device), self.cache)
        logits = logits[:, -1].float().cpu().numpy()

        for i in active:
            slot = self.slots[i]
            req = slot.req
            tok = sample(logits[i], req.sampling, step=len(slot.generated))
            slot.generated.append(tok)
            slot.pending = tok
            done = (len(slot.generated) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id))
            if done:
                self._retire(i)
        self.steps += 1
        self.decode_tokens += len(active)
        return True

    def run(self, requests: Optional[List[Request]] = None) -> Dict[int, List[int]]:
        for r in requests or []:
            self.add_request(r)
        while self.step():
            pass
        out, self.finished = self.finished, {}
        return out


def generate_reference(cfg, params, req: Request, *, max_len: int = 512,
                       device="cuda", dist: Optional[DistContext] = None) -> List[int]:
    """One request, one slot, no batching: the engine must match this."""
    dev = resolve_device(device)
    api = _bind(get_model(cfg), dist)
    cache = _make_cache(cfg, 1, max_len, dev)
    prompt = list(req.prompt)
    if len(prompt) > 1:
        _, cache = api.prefill(cfg, params, {"tokens": _tokens([prompt[:-1]], dev)}, cache)
    pending = prompt[-1]
    out: List[int] = []
    for _ in range(req.max_new_tokens):
        logits, cache = api.decode_step(cfg, params, _tokens([[pending]], dev), cache)
        tok = sample(logits[0, -1].float().cpu().numpy(), req.sampling, step=len(out))
        out.append(tok)
        pending = tok
        if req.eos_id is not None and tok == req.eos_id:
            break
    return out
