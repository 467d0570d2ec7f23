from .mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    make_parallel_train_step,
    replicate_state,
    shard_batch,
    spawn,
)
from .render import make_view_parallel_render

__all__ = [
    "Mesh",
    "batch_sharding",
    "make_mesh",
    "make_parallel_train_step",
    "make_view_parallel_render",
    "replicate_state",
    "shard_batch",
    "spawn",
]
