"""Multi-GPU: the process group, the mesh and its collectives, and the
sequence-sharded scan. The counterpart of `wavemamba_tpu/parallel/`, with
its names except `batch_sharding` and `replicated`, which have no
tensor-level counterpart (`parallel/mesh.py`)."""

from wavemamba_torch.parallel.dist import (
    barrier,
    get_dist_info,
    initialize,
    is_master,
    master_only,
)
from wavemamba_torch.parallel.mesh import make_mesh, replicate, shard_batch

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "initialize",
    "get_dist_info",
    "is_master",
    "master_only",
    "barrier",
]
