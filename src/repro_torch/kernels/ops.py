"""Public entry points of the six hand-written kernels and their launch counts.

Each wrapper takes CPU or CUDA tensors: on the CPU it runs the kernel's plain
PyTorch version, on CUDA it launches the kernel or raises.
"""

from .build import KERNELS, LAUNCHES, reset_launches  # noqa: F401
from .bucket import bucket_hist, bucket_hist_plain  # noqa: F401
from .flash_attention import flash_attention, flash_attention_plain  # noqa: F401
from .merge import merge_runs, merge_runs_plain  # noqa: F401
from .relabel_gather import relabel_gather, relabel_gather_plain  # noqa: F401
from .rmat import feistel_perm, feistel_perm_plain, rmat_edges, rmat_edges_plain  # noqa: F401
