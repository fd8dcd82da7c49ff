"""Data parallelism over several devices (counterpart of `mmtpu/parallel/`):
the mesh and its collectives (`mesh.py`) and the ranks' processes
(`launch.py`)."""

from mmtpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    active_mesh,
    create_mesh,
    get_default_mesh,
    replicate,
    set_default_mesh,
    shard_batch,
)

__all__ = [
    "Mesh",
    "MeshConfig",
    "active_mesh",
    "create_mesh",
    "get_default_mesh",
    "replicate",
    "set_default_mesh",
    "shard_batch",
]
