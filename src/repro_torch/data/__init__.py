"""The device walk corpus: walk samplers over the generated graph and the
LM-batch loader (twin of `repro.data`, without the out-of-core half)."""

from .loader import LoaderConfig, WalkLoader  # noqa: F401
from .walks import (  # noqa: F401
    csr_walks,
    distributed_walks,
    host_walks,
    start_vertex,
    walks_to_tokens,
)
