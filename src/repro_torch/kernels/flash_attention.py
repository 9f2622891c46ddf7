"""GQA flash attention of the LM serving path: CUDA kernel + plain version.

Replaces `repro/kernels/flash_attention.py::flash_attention_pallas` and
computes the function of `repro/models/layers.py::_chunked_attention`, the
attention the serving path runs: q [B, Hq, Sq, D] and k [B, Hkv, Skv, D]
against v [B, Hkv, Skv, Dv], query head h reading kv head h // (Hq / Hkv),
softmax in f32, output [B, Hq, Sq, Dv] in q's dtype.  Dv is D but for MLA,
whose queries and keys carry a rope part that the values lack.  Query i
sits at absolute position offset + i and, when causal, sees the keys
j <= offset + i.  `offset` is an int, a 0-d tensor or an int32 [B] tensor
(one per sequence: the serve engine's slot lengths); its default Skv - Sq
is the Pallas kernel's own (queries are the last Sq positions).  The keys
past the valid prefix of a cache buffer are masked by the same inequality,
so k and v may be a layer's whole [B, Hkv, max_len, D] cache.  A row with
every key masked gives 0, as the Pallas kernel does.

The kernels (`csrc/attention_kernels.cu`) take f32 or bf16 with (D, Dv) in
HEAD_DIMS: D = Dv in {16, 32, 64, 80, 128} (80: zamba2's heads), and MLA's
(192, 128).  bf16 with at
least 16 queries and (D, Dv) in PREFILL_HEAD_DIMS, the pairs with D >= 64
(prefill), runs the wgmma + TMA kernel; everything else (decode, f32, bf16
with D < 64) runs the split-KV decode kernel, which takes any Sq.  That is
a dispatch by shape (`plan`), not a fallback.  The decode kernel's query
tiles, key chunks and scratch come from `plan` too (a 192-wide q row takes
at most 8 rows a block); its chunk merge happens inside the same launch.
Each call counts as one launch of `flash_attention`.

The kernels compute the forward only, as the Pallas kernel does: on CUDA
the wrapper raises for inputs that need a gradient (grad mode on and q, k
or v requiring grad) rather than return an output that autograd cannot
differentiate.  Training takes `models/layers.py`'s train route, the
reference's `_chunked_attention`, which is `flash_attention_plain` here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build

# (D, Dv) of the kernels
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (80, 80), (128, 128), (192, 128))
KERNEL_ROWS = 16                   # (query head, query) rows of one decode block
DECODE_TILE_KEYS = 32              # keys of one decode tile (kDecKeys in the source)
DECODE_BLOCKS_PER_SM = 4           # decode blocks per SM if every cache were full
PREFILL_MIN_QUERIES = 16           # bf16 with this many queries takes the prefill kernel
PREFILL_HEAD_DIMS = ((64, 64), (80, 80), (128, 128), (192, 128))   # the prefill kernel's (D, Dv)
PLAIN_Q_CHUNK = 1024               # queries per chunk of the plain version (its memory bound)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Limits of `row_error` for the kernel against its plain version.  f32: the
# sum order differs.  bf16: both round each output to bf16, and the plain
# version also rounds the softmax weights, so one output may differ by an
# ulp, up to 2^-7 of its row's largest value; the limit is two such ulps.
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention takes q [B,Hq,Sq,D], k [B,Hkv,Skv,D], v [B,Hkv,Skv,Dv] "
                         f"(k = v but for the head width); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[1] < 1 or Hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair for GQA")
    return B, Hq, k.shape[1], Sq, k.shape[2], D, v.shape[3]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale=None, offset=None) -> torch.Tensor:
    """Plain version, the reference's `_chunked_attention`: the grouped product
    per query chunk, full-row softmax in f32, the weights cast to v's dtype
    before the product with v (accumulated in f32)."""
    B, Hq, Sq, Hkv, Skv, D = *q.shape[:3], k.shape[1], k.shape[2], q.shape[3]
    Dv = v.shape[3]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if offset is None:
        offset = Skv - Sq
    offset = torch.as_tensor(offset, device=q.device)
    qg = q.reshape(B, Hkv, g, Sq, D).float()
    kf, vf = k.float(), v.float()
    kpos = torch.arange(Skv, device=q.device)
    chunks = []
    for c0 in range(0, Sq, PLAIN_Q_CHUNK):
        qc = qg[:, :, :, c0:c0 + PLAIN_Q_CHUNK]
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qc, kf) * scale
        if causal:
            base = torch.arange(c0, c0 + qc.shape[3], device=q.device)
            if offset.dim() == 0:
                mask = kpos[None, :] <= (base + offset)[:, None]                 # [bq, Skv]
            else:
                qpos = offset[:, None] + base[None, :]                           # [B, bq]
                mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None, None]  # [B,1,1,bq,Skv]
            logits = logits.masked_fill(~mask, float("-inf"))
            w = torch.softmax(logits, dim=-1)
            w = torch.where(mask.any(dim=-1, keepdim=True), w, 0.0)   # fully masked rows: 0
        else:
            w = torch.softmax(logits, dim=-1)
        w = w.to(v.dtype).float()
        chunks.append(torch.einsum("bhgqk,bhkd->bhgqd", w, vf).to(q.dtype))
    return torch.cat(chunks, dim=3).reshape(B, Hq, Sq, Dv)


def row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of an output row relative to that row's size:
    max over rows of max_d |got - want| / max_d |want| (0 for rows equal
    to want, inf for a wrong row where want is 0).  Each row is held to its
    own size, so the long rows of a prefill or a decode wave, whose outputs
    are small, are held as tightly as the short ones."""
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    size = want.float().abs().amax(dim=-1)
    rel = torch.where(diff > 0, diff / size, torch.zeros_like(diff))
    return float(rel.max()) if rel.numel() else 0.0


class Plan(NamedTuple):
    """How one kernel call is laid out (pure shape arithmetic, no device)."""
    kernel: str        # "prefill" or "decode"
    bq: int            # decode: queries per block (g * bq <= KERNEL_ROWS)
    splits: int        # decode: key chunks per (sequence, kv head, query tile)
    chunk: int         # decode: keys per chunk, a multiple of DECODE_TILE_KEYS
    groups: int        # decode: (sequence, kv head, query tile) triples
    rows: int          # decode: rows of a group, g * bq

    @property
    def scratch_rows(self) -> int:
        """Rows of the decode scratch: part_acc [rows, Dv] and part_ml [rows, 2]
        in f32 (0 when no chunk merge is needed)."""
        return self.groups * self.splits * self.rows if self.splits > 1 else 0


def kernel_rows(D: int) -> int:
    """The most (query head, query) rows of one decode block for q/k width D
    (`dec_max_rows` in the source): the per-row registers of <f32, 128, 16>
    already fill 254 of 255, so MLA's 192-wide rows stop at 8."""
    return 8 if D == 192 else KERNEL_ROWS


def plan(dtype: torch.dtype, B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int, Dv: int,
         sms: int) -> Plan:
    """The kernel and decode layout of a call.  Prefill: bf16,
    at least PREFILL_MIN_QUERIES queries, (D, Dv) in PREFILL_HEAD_DIMS, some
    key.  Decode: the rest, at most kernel_rows(D) rows a block, with the
    keys split so that about DECODE_BLOCKS_PER_SM blocks per SM would exist
    if every cache were full (blocks past a slot's frontier exit at once, so
    a half-full wave keeps about 2 per SM); the host never reads the
    offsets."""
    g = Hq // Hkv
    bq = max(1, min(kernel_rows(D) // g, Sq))
    qtiles = -(-Sq // bq)
    groups = B * Hkv * qtiles
    if dtype == torch.bfloat16 and Sq >= PREFILL_MIN_QUERIES \
            and (D, Dv) in PREFILL_HEAD_DIMS and Skv > 0:
        return Plan("prefill", bq, 1, 0, groups, g * bq)
    tiles = max(1, -(-Skv // DECODE_TILE_KEYS))
    splits = min(tiles, max(1, -(-DECODE_BLOCKS_PER_SM * sms // groups)))
    chunk = DECODE_TILE_KEYS * -(-tiles // splits)
    splits = max(1, -(-Skv // chunk))
    return Plan("decode", bq, splits, chunk, groups, g * bq)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale=None, offset=None) -> torch.Tensor:
    """GQA attention [B, Hq, Sq, Dv]: the plain version for CPU tensors, the
    kernel for CUDA tensors (it raises on what the kernel does not take)."""
    B, Hq, Hkv, Sq, Skv, D, Dv = _shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale, offset=offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention kernel has no backward: its inputs require grad "
                           "under grad mode (train through models.layers.train_attention, "
                           "or run under torch.no_grad)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes f32 or bf16 alike, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims (D, Dv) in {HEAD_DIMS}, "
                         f"got {(D, Dv)}")
    g = Hq // Hkv
    if g > kernel_rows(D):
        raise ValueError(f"flash_attention kernel takes at most {kernel_rows(D)} query heads "
                         f"per kv head at D {D}, got {g}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel takes contiguous 16-byte aligned "
                             f"tensors; {name} is not")
    if Sq == 0:
        return q.new_empty((B, Hq, 0, Dv))
    offsets, offset_scalar = None, Skv - Sq
    if isinstance(offset, torch.Tensor):
        if offset.dtype != torch.int32 or offset.device != q.device or offset.dim() > 1 \
                or (offset.dim() == 1 and offset.shape[0] != B):
            raise ValueError(f"offset must be an int32 scalar or [B] tensor on {q.device}, got "
                             f"{offset.dtype} {tuple(offset.shape)} on {offset.device}")
        offsets = offset.expand(B).contiguous()
    elif offset is not None:
        offset_scalar = int(offset)
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    p = plan(q.dtype, B, Hq, Hkv, Sq, Skv, D, Dv, sms)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part_acc = part_ml = counters = None
    n_acc = p.scratch_rows
    if n_acc:
        part_acc = torch.empty((n_acc, Dv), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((n_acc, 2), dtype=torch.float32, device=q.device)
        counters = build.counters(q.device, stream, p.groups)
    out = q.new_empty((B, Hq, Sq, Dv))
    with torch.cuda.device(q.device):
        err = build.library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            part_acc.data_ptr() if n_acc else None, part_ml.data_ptr() if n_acc else None,
            counters.data_ptr() if n_acc else None,
            offsets.data_ptr() if offsets is not None else None, offset_scalar,
            B, Hq, Hkv, Sq, Skv, D, Dv, p.bq, p.splits, p.chunk, _DTYPES[q.dtype],
            int(p.kernel == "prefill"), int(causal), float(scale), stream)
    build.check(err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    build.LAUNCHES[f"flash_attention_{p.kernel}"] += 1
    return out
