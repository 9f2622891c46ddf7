"""The walk corpus: walk samplers over the generated graph (device and
out-of-core) and the LM-batch loaders (twin of `repro.data`)."""

from .loader import ExternalWalkLoader, LoaderConfig, WalkLoader  # noqa: F401
from .walks import (  # noqa: F401
    ExternalWalkResult,
    concat_bucket_csr,
    csr_walks,
    distributed_walks,
    external_walks,
    host_walks,
    start_vertex,
    walks_to_tokens,
)
