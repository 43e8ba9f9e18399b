"""sgg_torch.dist — the data-parallel tier of ``sgg/dist/`` on ``torch.distributed``.

Meshes over the world of ranks or a process's devices (:mod:`.mesh`), and the
multi-process runtime: torchrun's process group, per-process data shards, the
broadcast of a replicated state and the gradients' mean (:mod:`.multihost`).
TP, FSDP, sequence, pipeline and expert parallelism are still to port
(ROADMAP A8b–A8e).
"""

from sgg_torch.dist.mesh import (
    MeshSpec,
    batch_sharding,
    local_batch_size,
    make_mesh,
    mesh_from_config,
    replicated_sharding,
)
from sgg_torch.dist.multihost import (
    host_local_to_global,
    initialize_multihost,
    pmean,
    process_shard_info,
)

__all__ = [
    "MeshSpec",
    "make_mesh",
    "mesh_from_config",
    "batch_sharding",
    "replicated_sharding",
    "local_batch_size",
    "initialize_multihost",
    "process_shard_info",
    "host_local_to_global",
    "pmean",
]
