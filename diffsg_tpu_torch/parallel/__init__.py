from .mesh import (Mesh, all_gather_rows, all_reduce_max, all_reduce_min, all_reduce_sum,
                   batch_sharding, current_mesh, init_process, make_mesh, param_shardings,
                   replicated, shard_batch, shard_params)
