"""The graph generator: the device pipeline (shuffle, R-MAT, relabel,
redistribute, CSR), the out-of-core disk tier that runs the same phases
over chunk-streamed host storage, its per-chunk hot loops on the kernels,
and the cluster runtime that spreads the disk tier over hosts."""

from .external import StreamingGenerator  # noqa: F401
from .phases import PartitionedGenerator  # noqa: F401
from .cluster import (  # noqa: F401
    ClusterController, ClusterGenerator, ClusterSpec, CommandTemplateBackend,
    HostRunner, HostSpec, LocalExecBackend,
)
