"""Multi-chip parallelism: instance batching (dp), sample-axis sharding,
and constraint-row sharding (tp analog) over a `jax.sharding.Mesh`.

The reference is single-process, single-GPU (SURVEY.md §2.2); this
subpackage is new capability."""

from .mesh import make_mesh, batch_sharding, replicated
from .batch import solve_batch, solve_lasso_sharded, stack_problems
from .distributed import (
    initialize, row_sharded_lp_newton_step, shard_rows,
    solve_lp_row_sharded, solve_qp_row_sharded)
from .pd_dist import solve_pd_row_sharded
from .socp_dist import shard_cones, solve_socp_cone_sharded
from .socp_pd_dist import solve_socp_pd_cone_sharded

__all__ = [
    "make_mesh", "batch_sharding", "replicated",
    "solve_batch", "solve_lasso_sharded", "stack_problems",
    "initialize", "row_sharded_lp_newton_step", "shard_rows",
    "solve_lp_row_sharded", "solve_qp_row_sharded",
    "solve_pd_row_sharded",
    "shard_cones", "solve_socp_cone_sharded",
    "solve_socp_pd_cone_sharded",
]
