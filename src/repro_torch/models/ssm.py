"""Mamba2 block, chunked SSD (twin of `repro/models/ssm.py`).

The sequence is cut into chunks of Q positions (`_pick_chunk`: the largest
divisor of S that is at most `cfg.ssm_chunk`, as the reference picks it);
within a chunk the recurrence is masked matrix products, across chunks a
loop carries the [B, H, P, N] state (the reference's `lax.scan`).  Decays
and states are f32; the returned `ssm_state` is cast to the activation
dtype, as the reference's is.  A prime S gives Q = 1: S chunks, S steps of
the loop per layer.

Decode state: conv [B, conv_ch, w - 1] (the last w - 1 inputs of the
depthwise conv) and ssm [B, H, P, N]; one step is O(d_in (N + w)), whatever
the context length.  The depthwise causal conv is `F.conv1d` with one group
per channel: the reference computes it outside any Pallas kernel too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import rmsnorm


def _pick_chunk(S: int, Q: int) -> int:
    """Largest divisor of S that is <= Q (any divisor partitions the
    recurrence exactly)."""
    if S % Q == 0:
        return Q
    for q in range(min(Q, S), 0, -1):
        if S % q == 0:
            return q
    return S


def ssm_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_in, H, conv_ch


def init_mamba2(f, cfg):
    d = cfg.d_model
    d_in, H, conv_ch = ssm_dims(cfg)
    N, w = cfg.ssm_state, cfg.ssm_conv
    proj_out = 2 * d_in + 2 * cfg.ssm_groups * N + H
    return {
        "w_in": f.param((d, proj_out)),
        "conv_w": f.param((conv_ch, w), scale=0.5),
        "conv_b": f.param((conv_ch,), "zeros"),
        "dt_bias": f.param((H,), "zeros"),
        "A_log": f.param((H,), "zeros"),
        "D": f.param((H,), "ones"),
        "norm": f.param((d_in,), "ones"),
        "w_out": f.param((d_in, d)),
    }


def _split_proj(cfg, zxbcdt):
    d_in, _, _ = ssm_dims(cfg)
    GN = cfg.ssm_groups * cfg.ssm_state
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * GN],
            zxbcdt[..., 2 * d_in + 2 * GN:])


def _causal_conv(xBC, conv_w, conv_b, state=None):
    """Depthwise causal conv along S.  xBC [B, S, C], conv_w [C, w]; state
    [B, C, w - 1] (the previous inputs) or None (zeros).  Returns
    (silu(out) [B, S, C], new state [B, C, w - 1])."""
    B, S, C = xBC.shape
    w = conv_w.shape[-1]
    xt = xBC.transpose(1, 2)                                  # [B, C, S]
    pad = (torch.zeros((B, C, w - 1), dtype=xt.dtype, device=xt.device) if state is None
           else state.to(xt.dtype))
    full = torch.cat([pad, xt], dim=-1)                        # [B, C, S + w - 1]
    out = F.conv1d(full, conv_w[:, None, :].to(xt.dtype), groups=C)
    out = out + conv_b[None, :, None].to(xt.dtype)
    return F.silu(out).transpose(1, 2), full[..., -(w - 1):]


def _gate_norm_out(p, cfg, y, z, dtype):
    y = y * F.silu(z.float())                                 # gated
    y = rmsnorm({"scale": p["norm"]}, y.to(dtype), cfg.norm_eps)
    return y @ p["w_out"]


def mamba2_forward(p, cfg, x: torch.Tensor, *, initial_state=None, return_state: bool = False):
    """x [B, S, d] -> y [B, S, d]; with return_state also (conv_state,
    ssm_state), the latter in x's dtype."""
    B, S, _ = x.shape
    d_in, H, _ = ssm_dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    Q = _pick_chunk(S, cfg.ssm_chunk)
    nC = S // Q

    z, xBC, dt = _split_proj(cfg, x @ p["w_in"])
    conv_in = initial_state[0] if initial_state is not None else None
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_in)
    xh = xBC[..., :d_in].reshape(B, S, H, P)
    Bm = xBC[..., d_in:d_in + N]                               # [B, S, N] (one group)
    Cm = xBC[..., d_in + N:]

    dt = F.softplus(dt.float() + p["dt_bias"].float())         # [B, S, H]
    A = -torch.exp(p["A_log"].float())                        # [H]
    dA = dt * A                                               # <= 0

    xc = xh.reshape(B, nC, Q, H, P).float()
    Bc = Bm.reshape(B, nC, Q, N).float()
    Cc = Cm.reshape(B, nC, Q, N).float()
    dtc = dt.reshape(B, nC, Q, H)
    cum = torch.cumsum(dA.reshape(B, nC, Q, H), dim=2)        # [B, c, Q, H]

    # intra-chunk (quadratic within Q)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])     # [B, c, i, j, H]
    ii = torch.arange(Q, device=x.device)
    mask = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    att = CB[..., None] * torch.where(mask, decay, 0.0)
    xdt = xc * dtc[..., None]                                  # [B, c, Q, H, P]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xdt)

    # each chunk's state, from its inputs decayed to the chunk's end
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # [B, c, Q, H]
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc, xdt * decay_to_end[..., None])

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # [B, c, H]
    s = (initial_state[1].float() if initial_state is not None
         else torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))
    s_prev = []
    for c in range(nC):
        s_prev.append(s)
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    s_prevs = torch.stack(s_prev, dim=1)                       # [B, c, H, P, N]
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, s_prevs) * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(B, S, H, P) + xh.float() * p["D"].float()[None, None, :, None]
    out = _gate_norm_out(p, cfg, y.reshape(B, S, d_in), z, x.dtype)
    if return_state:
        return out, (conv_state, s.to(x.dtype))
    return out


def mamba2_step(p, cfg, x: torch.Tensor, state) -> Tuple[torch.Tensor, Tuple]:
    """One decode step.  x [B, 1, d]; state = (conv [B, C, w - 1], ssm
    [B, H, P, N]).  Returns (y [B, 1, d], new state, ssm in x's dtype)."""
    B = x.shape[0]
    d_in, H, _ = ssm_dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    conv_state, s = state

    z, xBC, dt = _split_proj(cfg, x @ p["w_in"])
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xh = xBC[:, 0, :d_in].reshape(B, H, P).float()
    Bm = xBC[:, 0, d_in:d_in + N].float()                     # [B, N]
    Cm = xBC[:, 0, d_in + N:].float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())   # [B, H]
    dA = torch.exp(dt * -torch.exp(p["A_log"].float()))

    s_new = dA[..., None, None] * s.float() + torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bm)
    y = torch.einsum("bn,bhpn->bhp", Cm, s_new) + xh * p["D"].float()[None, :, None]
    out = _gate_norm_out(p, cfg, y.reshape(B, 1, d_in), z, x.dtype)
    return out, (conv_state, s_new.to(x.dtype))


def init_ssm_state(cfg, batch: int, device, dtype: Optional[torch.dtype] = None):
    """Zero (conv [batch, conv_ch, w - 1], ssm [batch, H, P, N]) in `dtype`
    (default the config's)."""
    _, H, conv_ch = ssm_dims(cfg)
    dtype = dtype or cfg.torch_dtype
    return (torch.zeros((batch, conv_ch, cfg.ssm_conv - 1), dtype=dtype, device=device),
            torch.zeros((batch, H, cfg.ssm_head_dim, cfg.ssm_state), dtype=dtype, device=device))


def init_layer_states(cfg, batch: int, device):
    """Zero states of all L layers: {"conv": [L, batch, conv_ch, w - 1],
    "ssm": [L, batch, H, P, N]}, the config's dtype."""
    conv, ssm = init_ssm_state(cfg, batch, device)
    L = cfg.num_layers
    return {"conv": conv.expand(L, *conv.shape).contiguous(),
            "ssm": ssm.expand(L, *ssm.shape).contiguous()}


def mamba2_cached(p, cfg, x: torch.Tensor, cache, layer: int, step: bool) -> torch.Tensor:
    """Layer `layer`'s block on x [B, S, d] from the states cache["conv"][layer]
    and cache["ssm"][layer], which it overwrites in place with the new ones:
    one decode step (`step`, S = 1) or a forward.  Returns the block's output."""
    state = (cache["conv"][layer], cache["ssm"][layer])
    if step:
        out, (conv, ssm) = mamba2_step(p, cfg, x, state)
    else:
        out, (conv, ssm) = mamba2_forward(p, cfg, x, initial_state=state, return_state=True)
    cache["conv"][layer].copy_(conv)
    cache["ssm"][layer].copy_(ssm)
    return out
