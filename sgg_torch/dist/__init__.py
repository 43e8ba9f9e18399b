"""sgg_torch.dist — ``sgg/dist/``'s data, tensor, sequence, pipeline and
expert parallelism and FSDP on ``torch.distributed``.

Meshes over the world of ranks or a process's devices (:mod:`.mesh`); the
multi-process runtime: torchrun's process group, per-process data shards, the
broadcast of a replicated state, the gradients' mean and the subgroup
collectives (:mod:`.multihost`); the train state's placement over a
``('data'[, 'seq'][, 'expert'], 'model')`` mesh, the experts over 'expert',
TP over the vocabulary and FSDP/ZeRO over 'data' (:mod:`.sharding`); ring and
Ulysses sequence parallelism over the ViT's patch axis
(:mod:`.sequence_parallel`); the GPipe pipeline over the ViT's block stack
(:mod:`.pipeline_parallel`); and the MoE layer over the 'expert' axis
(:mod:`.expert_parallel`).
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
