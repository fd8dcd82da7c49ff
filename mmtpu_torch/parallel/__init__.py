"""Data parallelism over several devices (counterpart of `mmtpu/parallel/`):
the mesh and its collectives (`mesh.py`) and the ranks' processes
(`launch.py`)."""

from mmtpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshConfig,
    NamedSharding,
    active_mesh,
    batch_sharding,
    create_mesh,
    get_default_mesh,
    put_global,
    replicate,
    set_default_mesh,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "MeshConfig",
    "NamedSharding",
    "active_mesh",
    "batch_sharding",
    "create_mesh",
    "get_default_mesh",
    "put_global",
    "replicate",
    "set_default_mesh",
    "shard_batch",
]
