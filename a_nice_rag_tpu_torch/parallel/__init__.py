"""Corpus sharding over a slot mesh (counterpart of
``a_nice_rag_tpu.parallel``).

The corpus is the scaling dimension: the dense matrices, the BM25
postings and the candidate masks are split along the document axis over
the mesh's ``corpus`` axis, and query batches over its ``dp`` axis. Each
shard ranks its rows with the port's kernels, and the per-shard top-k
lists are merged exactly on the group's lead device. One controller
dispatches every shard's work; a mesh's slots may share a device.
"""

from a_nice_rag_tpu_torch.parallel.health import (  # noqa: F401
    DeviceHealthMonitor,
    default_probe,
)
from a_nice_rag_tpu_torch.parallel.engine import ShardedSearchEngine  # noqa: F401
from a_nice_rag_tpu_torch.parallel.mesh import (  # noqa: F401
    DeviceMesh,
    Slot,
    make_mesh,
)
from a_nice_rag_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedIndex,
    ShardedRetriever,
    load_shard_ivf,
    reshard_surviving,
    save_shard_ivf,
    shard_index,
    shard_ivf,
    sharded_dense_top_k,
    sharded_hybrid_retrieve,
)
