"""The graph generator: the device pipeline (shuffle, R-MAT, relabel,
redistribute, CSR) and the out-of-core disk tier that runs the same phases
over chunk-streamed host storage, its per-chunk hot loops on the kernels."""

from .external import StreamingGenerator  # noqa: F401
from .phases import PartitionedGenerator  # noqa: F401
