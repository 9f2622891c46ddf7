"""The port's Mamba2 block (`repro_torch.models.ssm`, on the CPU) against the
reference's `repro.models.ssm`.

The reference runs once per file in a subprocess (tests/torch_parity.py).
Both sides take the same parameters and inputs, drawn with numpy from
seeds: the mamba2 smoke's widths (d 64, 8 heads of 16, state 16, conv 4),
with dt_bias, A_log, D and the norm drawn around their initial values so
that every decay and gate is exercised.  Cases:

  * `mamba2_forward` at lengths that the chunk divides (64 with chunk 32:
    two chunks; 48 with chunk 8: six), at primes below the chunk (17, 29:
    one chunk of S) and above it (37 with chunk 32, 29 with chunk 8: chunk 1,
    one loop step per position, the reference's `_pick_chunk`), each from
    zero state and from a given (conv, ssm) state, with the returned state;
  * `mamba2_step` chained over 9 tokens from a prefix's state, against the
    reference's steps and against one forward over the whole sequence.

Tolerance: f32 1e-5 absolute on outputs and states (values up to ~3; sums
in another order, exp and softplus rounded differently; the largest
difference seen is 2.2e-6).  bf16 cases round every activation to 8
bits at other places in XLA and PyTorch: 1e-1.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm
from torch_parity import run_reference

TOL = {"float32": 1e-5, "bfloat16": 1e-1}
B = 2
# name: (S, ssm_chunk, with initial state, dtype)
FORWARD = {
    "divisible_s64_q32": (64, 32, False, "float32"),
    "divisible_s48_q8": (48, 8, True, "float32"),
    "prime_s17": (17, 32, False, "float32"),
    "prime_s29_state": (29, 32, True, "float32"),
    "prime_s37_chunk1": (37, 32, False, "float32"),
    "prime_s29_chunk1_state": (29, 8, True, "float32"),
    "bf16_s64_state": (64, 32, True, "bfloat16"),
}
STEP_PREFIX, STEP_TOKENS = 7, 9


def _cfg(chunk=32, dtype="float32"):
    return get_smoke_config("mamba2-780m").with_(ssm_chunk=chunk, dtype=dtype)


def _params(cfg, seed=0):
    """The block's parameters as numpy f32, the reference's shapes."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    N, w = cfg.ssm_state, cfg.ssm_conv
    conv_ch = d_in + 2 * N
    return {
        "w_in": rng.standard_normal((d, 2 * d_in + 2 * N + H)) / np.sqrt(d),
        "conv_w": rng.standard_normal((conv_ch, w)) * 0.5 / np.sqrt(w),
        "conv_b": rng.standard_normal(conv_ch) * 0.1,
        "dt_bias": rng.standard_normal(H) * 0.5,
        "A_log": rng.uniform(-1.0, 1.0, H),
        "D": 1.0 + rng.standard_normal(H) * 0.1,
        "norm": 1.0 + rng.standard_normal(d_in) * 0.1,
        "w_out": rng.standard_normal((d_in, d)) / np.sqrt(d_in),
    }


def _inputs(cfg, S, seed):
    """x [B, S, d] and a (conv, ssm) state, numpy f64."""
    rng = np.random.default_rng(seed)
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    conv = rng.standard_normal((B, d_in + 2 * cfg.ssm_state, cfg.ssm_conv - 1))
    state = rng.standard_normal((B, H, cfg.ssm_head_dim, cfg.ssm_state)) * 0.5
    return rng.standard_normal((B, S, cfg.d_model)), conv, state


@pytest.fixture(scope="module")
def reference():
    import inspect
    body = f"""
import jax.numpy as jnp
from repro.configs.base import get_smoke_config
from repro.models import ssm
FORWARD = {FORWARD!r}
B = {B}
{inspect.getsource(_cfg)}
{inspect.getsource(_params)}
{inspect.getsource(_inputs)}

def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))

def j(x, dt):   # through f32, as the port's side takes it
    return jnp.asarray(np.asarray(x, np.float32), dt)

for name, (S, chunk, with_state, dt) in FORWARD.items():
    cfg = _cfg(chunk, dt)
    p = {{k: j(v, dt) for k, v in _params(cfg).items()}}
    x, conv, state = (j(a, dt) for a in _inputs(cfg, S, S))
    init = (conv, state) if with_state else None
    y, (c, s) = ssm.mamba2_forward(p, cfg, x, None, initial_state=init, return_state=True)
    OUT[name + "/y"], OUT[name + "/conv"], OUT[name + "/ssm"] = f32(y), f32(c), f32(s)
    OUT[name + "/chunk"] = np.asarray(ssm._pick_chunk(S, chunk))

cfg = _cfg()
p = {{k: j(v, jnp.float32) for k, v in _params(cfg).items()}}
S = {STEP_PREFIX + STEP_TOKENS}
x = j(_inputs(cfg, S, 99)[0], jnp.float32)
OUT["step/full"] = f32(ssm.mamba2_forward(p, cfg, x, None))
_, st = ssm.mamba2_forward(p, cfg, x[:, :{STEP_PREFIX}], None, return_state=True)
for i in range({STEP_PREFIX}, S):
    y, st = ssm.mamba2_step(p, cfg, x[:, i:i + 1], st)
    OUT[f"step/y{{i}}"] = f32(y)
OUT["step/conv"], OUT["step/ssm"] = f32(st[0]), f32(st[1])
"""
    return run_reference(body)


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _close(got, want, tol, what):
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape), want.shape)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("name", list(FORWARD))
def test_mamba2_forward_matches_reference(reference, name):
    S, chunk, with_state, dt = FORWARD[name]
    cfg = _cfg(chunk, dt)
    p = {k: _t(v, dt) for k, v in _params(cfg).items()}
    x, conv, state = (_t(a, dt) for a in _inputs(cfg, S, S))
    assert ssm._pick_chunk(S, chunk) == int(reference[name + "/chunk"])
    y, (c, s) = ssm.mamba2_forward(p, cfg, x, initial_state=(conv, state) if with_state else None,
                                   return_state=True)
    assert y.dtype == c.dtype == s.dtype == getattr(torch, dt)
    tol = TOL[dt]
    _close(y, reference[name + "/y"], tol, "y")
    _close(c, reference[name + "/conv"], tol, "conv state")
    _close(s, reference[name + "/ssm"], tol, "ssm state")
    if not with_state:   # the state argument of zeros is the same as none
        zeros = ssm.init_ssm_state(cfg, B, "cpu")
        y0 = ssm.mamba2_forward(p, cfg, x, initial_state=zeros)
        assert torch.equal(y0, y)


def test_pick_chunk_is_the_largest_divisor():
    assert [ssm._pick_chunk(S, 256) for S in (2048, 2047, 2039, 1500, 100, 257)] == \
        [256, 89, 1, 250, 100, 1]


def test_mamba2_step_chain_matches_reference_and_forward(reference):
    cfg = _cfg()
    p = {k: _t(v, "float32") for k, v in _params(cfg).items()}
    x = _t(_inputs(cfg, STEP_PREFIX + STEP_TOKENS, 99)[0], "float32")
    full = ssm.mamba2_forward(p, cfg, x)
    _close(full, reference["step/full"], TOL["float32"], "full forward")
    _, st = ssm.mamba2_forward(p, cfg, x[:, :STEP_PREFIX], return_state=True)
    for i in range(STEP_PREFIX, x.shape[1]):
        y, st = ssm.mamba2_step(p, cfg, x[:, i:i + 1], st)
        _close(y, reference[f"step/y{i}"], TOL["float32"], f"step {i}")
        # a step continues the forward: the same output as the whole sequence's
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, i].numpy(), atol=TOL["float32"])
    _close(st[0], reference["step/conv"], TOL["float32"], "conv state")
    _close(st[1], reference["step/ssm"], TOL["float32"], "ssm state")
