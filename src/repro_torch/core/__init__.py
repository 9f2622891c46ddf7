"""The graph generator: the device pipeline (shuffle, R-MAT, relabel,
redistribute, CSR), the out-of-core disk tier that runs the same phases
over chunk-streamed host storage, its per-chunk hot loops on the kernels,
and the cluster runtime that spreads the disk tier over hosts.

The exports are the reference's (`repro/core/__init__.py`), name for name."""

from .types import GraphConfig, owner_of, quadrant_thresholds  # noqa: F401
from .rmat import rmat_edge_block, mix32, counter_uniform_u32  # noqa: F401
from .blockstore import (  # noqa: F401
    BlockStore, IOLedger, MemoryGauge, MonotoneLookup,
    clean_cascade_stores, merge_runs, partition_runs, sort_runs,
)
from .phases import PhaseOrchestrator, PartitionedGenerator, plain_config  # noqa: F401
from .corpus import ShardedWalks  # noqa: F401
from .cluster import (  # noqa: F401
    ClusterController, ClusterGenerator, ClusterSpec, CommandTemplateBackend,
    HostRunner, HostSpec, LocalExecBackend,
)
from .transport import (  # noqa: F401
    ExchangeServer, FilesystemTransport, SocketTransport, Transport,
    TransportError, TransportStats, make_transport, sweep_partial_frames,
)
from .external import StreamingGenerator, RunStore, external_merge, external_sort_runs  # noqa: F401
from .hostgen import mix32_np, rmat_edges_np, rmat_edges_np_cfg  # noqa: F401
from .shuffle import distributed_shuffle, shuffle_argsort, pv_is_permutation  # noqa: F401
from .relabel import relabel_ring, relabel_alltoall  # noqa: F401
from .redistribute import redistribute, redistribute_sorted, OwnedEdges  # noqa: F401
from .csr import build_csr_scatter, build_csr_sorted, CSRShards, csr_neighbors  # noqa: F401
from .hashing import feistel_permute, hash_relabel, hash_permutation_vector  # noqa: F401
from .pipeline import generate, generate_edges, generate_baseline_hash, GraphResult  # noqa: F401
