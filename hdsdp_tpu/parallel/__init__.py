"""Multi-chip distribution layer.

The reference is a single-process CPU solver (SURVEY.md section 2:
no MPI/NCCL anywhere); this layer is the genuinely new part.
The scalable dimensions of the workload are

  * m      constraint rows  -> rows of the Schur complement M
  * R, md  constraint-coefficient slots inside each cone block group
  * g      cone blocks of equal dimension

We shard the *work* of the hot loop — the O(g R^2 n + md n^3) Schur
assembly contractions — over a 1-D device mesh axis ``"row"`` and combine
per-device partial results with ``psum`` over ICI.  Constant problem data
(factors F, dense stacks Ad) is replicated: it is iteration-invariant, so
replication costs one broadcast at setup and removes all gathers from the
per-iteration path.  The m x m factorization is replicated below the
CG crossover and solved by row-sharded preconditioned CG above it
(hdsdp_tpu.parallel.cg).
"""

from hdsdp_tpu.parallel.mesh import make_mesh
from hdsdp_tpu.parallel.schur import ShardedConeSystem

__all__ = ["make_mesh", "ShardedConeSystem"]
