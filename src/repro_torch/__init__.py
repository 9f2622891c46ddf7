"""PyTorch + CUDA port of the device graph generator (`repro`'s JAX package).

The reference's nb-shard mesh becomes a leading shard dimension on one
device: per-shard arrays are `[nb, ...]`, `lax.all_to_all` is a swap of the
first two dimensions, `ppermute` a roll and `psum` a sum.  Public results keep
the reference's global flattened shapes.

Every entry point takes `device` (default `"cuda"`) and raises when CUDA is
asked for and absent; it never falls back to the CPU.  On the CPU the four
hand-written kernels (`kernels/csrc/graph_kernels.cu`) are replaced by their
plain PyTorch versions, which is what the tests hold against the reference.
"""

from .core.types import GraphConfig  # noqa: F401
from .core.pipeline import GraphResult, generate, generate_baseline_hash  # noqa: F401
