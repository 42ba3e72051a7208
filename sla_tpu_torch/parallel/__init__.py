"""The mesh backend: the filter stages sharded over a mesh of torch devices
(counterpart of sla_tpu/parallel/)."""

from .sharding import (  # noqa: F401
    BLOCK_AXIS,
    CHANNEL_AXIS,
    Mesh,
    Sharded,
    gather,
    gather_to,
    make_mesh,
    mesh_devices,
    shard_batch,
    sharded_decode_step,
    sharded_encode_stage1,
    sharded_encode_stage2,
    sharded_encode_step,
)
