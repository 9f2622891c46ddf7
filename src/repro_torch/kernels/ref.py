"""uint32 counter-hash math on int64 tensors (twin of `repro.core.rmat`).

PyTorch has no usable uint32 arithmetic on the CPU (`>>` and `<` raise on
`torch.uint32`, and on int32 `>>` is arithmetic), so every uint32 value lives
in an int64 tensor in [0, 2**32) and each product or sum is masked back to
32 bits.  A product is split into 16-bit halves so that no int64 product can
overflow: the result is the exact low 32 bits of the uint32 product, which is
what the reference (and the CUDA kernels) compute by wrapping.
"""

from __future__ import annotations

import torch

from ..core.hostgen import _GOLDEN, MASK32

_M1 = 0x7FEB352D
_M2 = 0x846CA68B


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) and a uint32 constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3-finalizer avalanche, bijective on uint32 (int64 in, int64 out)."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, _M1)
    x = x ^ (x >> 15)
    x = mul32(x, _M2)
    return x ^ (x >> 16)


def counter_uniform_u32(seed: int, index: torch.Tensor, stream: int) -> torch.Tensor:
    """One uint32 uniform per counter: h(seed, stream, index)."""
    s = (seed ^ (stream * _GOLDEN)) & MASK32
    return mix32(mix32((index + s) & MASK32) ^ s)
