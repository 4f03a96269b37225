"""Data parallelism: in-process device meshes for inference, torch.distributed ranks for training."""

from yololite_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    launch,
    make_mesh,
    mesh_size,
    replicate_tree,
    replicated,
    resolve_devices,
    select_device,
    shard_batch,
)

__all__ = ("Mesh", "batch_sharding", "launch", "make_mesh", "mesh_size", "replicate_tree", "replicated",
           "resolve_devices", "select_device", "shard_batch")
