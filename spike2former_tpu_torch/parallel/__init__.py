from .mesh import (Mesh, all_reduce_grads, all_reduce_metrics, barrier,
                   batch_moments, current_mesh, distributed_init, free_port,
                   gather_rows, global_any, global_batch, global_block,
                   global_draw, global_sum, make_mesh, replicate,
                   shard_batch, shutdown,
                   synced, world)
from .spatial import gather_rows_h, shard_rows, spatial_sharding
from .tp import gather_params_tp, shard_params_tp, tp_pspec

__all__ = [
    "Mesh", "all_reduce_grads", "all_reduce_metrics", "barrier",
    "batch_moments", "current_mesh", "distributed_init", "free_port",
    "gather_params_tp", "gather_rows", "gather_rows_h", "global_any",
    "global_batch", "global_block", "global_draw", "global_sum",
    "make_mesh", "replicate",
    "shard_batch", "shard_params_tp", "shard_rows", "shutdown",
    "spatial_sharding", "synced", "tp_pspec", "world",
]
