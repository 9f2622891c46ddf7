"""Shared layers of the LM (twin of `repro/models/layers.py`): RMSNorm, RoPE,
SwiGLU MLP, GQA attention (+bias), MLA.

Activations [B, S, d]; attention tensors [B, H, S, hd]; weights in the
reference's [in, out] layout, applied as `x @ w`.  Every attention call goes
through `attend`, which takes one of two routes:

  * serving (the default): `kernels/flash_attention.py::flash_attention`,
    the hand-written kernel for CUDA tensors, its plain version for CPU
    tensors;
  * training, inside `with train_attention():` (the train step enters it
    around its forward): the reference's `_chunked_attention` itself
    (`flash_attention_plain`), differentiated by autograd on every device.
    The reference trains through that function (its `make_train_step` runs
    with `dist=None`, and `_chunked_attention` reaches the Pallas kernel
    only when a `DistContext` asks for it), and its kernel has no backward.
    The flash wrapper refuses CUDA inputs that need a gradient, so a forward
    under autograd outside this route raises instead of silently losing
    the attention's gradient.

A GQA layer's cache is {"k", "v": [B, Hkv, max_len, hd], "length": int32
0-d or [B]}; an MLA layer's {"c_kv": [B, max_len, kv_lora_rank], "k_rope":
[B, 1, max_len, qk_rope_dim], "length"}.  Both attentions write the new
entries into the cache's buffers in place (the reference returns updated
copies; in place saves copying a layer's cache every step) and return the
same buffers with "length": length + S.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention, flash_attention_plain

# f32 products (the f32 logits, the f32 smoke configs) run in full f32, not
# TF32: PyTorch's default, set here because parity with the reference needs it.
torch.backends.cuda.matmul.allow_tf32 = False


_TRAIN_ROUTE = contextvars.ContextVar("train_attention", default=False)


@contextlib.contextmanager
def train_attention():
    """Attention calls inside the block take the train route (see above)."""
    token = _TRAIN_ROUTE.set(True)
    try:
        yield
    finally:
        _TRAIN_ROUTE.reset(token)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
           offset=None) -> torch.Tensor:
    """GQA attention [B, Hq, Sq, Dv] by the route in force (see above)."""
    if _TRAIN_ROUTE.get():
        return flash_attention_plain(q, k, v, causal=causal, offset=offset)
    return flash_attention(q, k, v, causal=causal, offset=offset)


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * p["scale"].float()).to(dt)


def decode_positions(length: torch.Tensor, S: int) -> torch.Tensor:
    """Absolute positions of S new tokens given cache length (0-d or [B])."""
    steps = torch.arange(S, device=length.device, dtype=length.dtype)
    if length.dim() == 1:
        return length[:, None] + steps[None, :]
    return length + steps


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """NeoX/llama half-rotation RoPE in f32.  x [B, H, S, hd], positions [S] or [B, S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs        # [..., S, hd/2]
    angles = angles[None, None] if angles.dim() == 2 else angles[:, None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def _write_cache(buf: torch.Tensor, new: torch.Tensor, length: torch.Tensor) -> None:
    """buf[:, :, length:length+S] = new, per sequence when length is [B].  The
    start is clamped to [0, max_len - S], as JAX's dynamic_update_slice does:
    the engine decodes idle slots too, and their lengths outgrow the buffer."""
    S, max_len = new.shape[2], buf.shape[2]
    start = length.clamp(0, max_len - S).long()
    steps = torch.arange(S, device=buf.device)
    if length.dim() == 1:
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[rows, :, start[:, None] + steps[None, :]] = new.transpose(1, 2)
    else:
        buf[:, :, start + steps] = new


def attention(p, cfg, x: torch.Tensor, positions: torch.Tensor, *, kv_cache=None,
              causal: bool = True):
    """Full attention sublayer.  x [B, S, d].

    kv_cache: None (no cache) or a layer's cache: the new K/V are written at
    [length, length + S) and the queries attend over the whole buffer, the
    unwritten tail masked by offset = length.
    Returns (out [B, S, d], updated cache or None).
    """
    B, S, _ = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, Hq, hd).transpose(1, 2)
    k = k.reshape(B, S, Hkv, hd).transpose(1, 2)
    v = v.reshape(B, S, Hkv, hd).transpose(1, 2)
    q = apply_rope(q, positions, cfg.rope_theta).contiguous()   # the kernel's layout
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
        length = kv_cache["length"]
        _write_cache(kv_cache["k"], k, length)
        _write_cache(kv_cache["v"], v, length)
        new_cache = {"k": kv_cache["k"], "v": kv_cache["v"], "length": length + S}
        out = attend(q, kv_cache["k"], kv_cache["v"], causal=True, offset=length)
    else:
        out = attend(q, k.contiguous(), v.contiguous(), causal=causal)
    out = out.transpose(1, 2).reshape(B, S, Hq * hd)
    return out @ p["wo"], new_cache


def init_mla(f, cfg):
    d, H, R = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": f.param((d, H * qk)),
        "w_dkv": f.param((d, R)),
        "w_kr": f.param((d, cfg.qk_rope_dim)),
        "kv_norm": f.param((R,), "ones"),
        "w_uk": f.param((R, H * cfg.qk_nope_dim)),
        "w_uv": f.param((R, H * cfg.v_head_dim)),
        "wo": f.param((H * cfg.v_head_dim, d)),
    }


def mla_attention(p, cfg, x: torch.Tensor, positions: torch.Tensor, *, kv_cache=None):
    """MLA: K/V compressed to c_kv [B, S, kv_lora_rank] and one rope key
    [B, 1, S, qk_rope_dim] shared by the heads; the cache keeps only those.
    Decompressed per call over the whole buffer, as the reference does (no
    absorbed-matmul variant): k = [c_kv w_uk, k_rope] is qk_nope + qk_rope
    wide, v = c_kv w_uv is v_head_dim wide, so the attention's q/k and v
    widths differ ((192, 128) for deepseek-v2).  Returns (out [B, S, d],
    updated cache or None)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope_d, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, nope + rope_d).transpose(1, 2)
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)], dim=-1)
    c_kv = rmsnorm({"scale": p["kv_norm"]}, x @ p["w_dkv"], cfg.norm_eps)      # [B, S, R]
    k_rope = apply_rope((x @ p["w_kr"])[:, None], positions, cfg.rope_theta)   # [B, 1, S, rope]

    new_cache, offset = None, None
    if kv_cache is not None:
        length = kv_cache["length"]
        _write_cache(kv_cache["c_kv"][:, None], c_kv[:, None], length)
        _write_cache(kv_cache["k_rope"], k_rope, length)
        c_kv, k_rope = kv_cache["c_kv"], kv_cache["k_rope"]
        new_cache = {"c_kv": c_kv, "k_rope": k_rope, "length": length + S}
        offset = length            # attend over the whole buffer, the unwritten tail masked

    Sk = c_kv.shape[1]
    k_nope = (c_kv @ p["w_uk"]).reshape(B, Sk, H, nope).transpose(1, 2)
    v = (c_kv @ p["w_uv"]).reshape(B, Sk, H, vh).transpose(1, 2).contiguous()
    k = torch.cat([k_nope, k_rope.expand(B, H, Sk, rope_d)], dim=-1)
    out = attend(q, k, v, causal=True, offset=offset)
    out = out.transpose(1, 2).reshape(B, S, H * vh)
    return out @ p["wo"], new_cache


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tokens"][tokens]


def unembed(p, x: torch.Tensor, fp32: bool = True, valid_vocab: int = 0) -> torch.Tensor:
    w = p["w"]
    if fp32:
        x, w = x.float(), w.float()
    logits = x @ w
    if valid_vocab and valid_vocab < w.shape[-1]:
        logits[..., valid_vocab:] = -1e9       # vocab-padding mask
    return logits
