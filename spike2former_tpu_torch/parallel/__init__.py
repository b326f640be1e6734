from .mesh import (all_reduce_grads, all_reduce_metrics, barrier,
                   batch_moments, distributed_init, free_port, gather_rows,
                   global_any, global_batch, global_draw, global_sum,
                   replicate, shard_batch, shutdown, synced, world)

__all__ = [
    "all_reduce_grads", "all_reduce_metrics", "barrier", "batch_moments",
    "distributed_init", "free_port", "gather_rows", "global_any",
    "global_batch", "global_draw", "global_sum", "replicate", "shard_batch",
    "shutdown", "synced", "world",
]
