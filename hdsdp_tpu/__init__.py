"""hdsdp_tpu: a homogeneous dual-scaling interior-point SDP solver in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of HDSDP
(reference: interface/hdsdp.h:108-120):

  min <C, X>  s.t.  A(X) = b,  X in (product of SDP / LP / bound cones)

solved by a three-phase dual interior-point method:

  Phase A  infeasible-start dual IPM        (ref interface/hdsdp_algo.c:960)
  Phase A' homogeneous self-dual embedding  (ref interface/hdsdp_algo.c:355)
  Phase B  dual potential reduction         (ref interface/hdsdp_algo.c:1658)

Design notes (NOT a port):
  * The reference dispatches five per-row Schur strategies (M1-M5) over five
    coefficient-matrix types through C vtables.  Here every coefficient matrix
    is eigen-decomposed once at presolve (restricted to its sparsity support,
    the SPEIGS trick) and constraints are bucketed into a *low-rank* bucket
    (factors F:[R,n], weights lam:[R]) and a *dense* bucket ([md,n,n]).  The
    Schur complement M_ij = tr(A_i S^-1 A_j S^-1) then becomes a handful of
    large batched f64 contractions.
  * Dual matrices S are kept masked-dense per block; blocks of equal dimension
    are batched; Cholesky/eigh are batched XLA ops.
  * Multi-device scaling shards constraint rows of M and cone blocks over a
    jax.sharding.Mesh (see hdsdp_tpu.parallel).
"""

import jax

# The interior-point method uses Cholesky success/failure as a PSD predicate
# and drives duality gaps to 1e-8: double precision is required, exactly as
# the reference is double-only (ref CMakeLists.txt: ANSI C + BLAS/LAPACK).
jax.config.update("jax_enable_x64", True)
# Every f32 product stays a true f32 product: GPUs otherwise run f32
# matmuls in TF32 (~3 decimal digits) by default.
jax.config.update("jax_default_matmul_precision", "highest")

from hdsdp_tpu.io.sdpa import read_sdpa  # noqa: E402
from hdsdp_tpu.models.problem import SDPProblem  # noqa: E402
from hdsdp_tpu.solver.batch import solve_batch  # noqa: E402
from hdsdp_tpu.solver.solver import HDSDPSolver, solve_sdpa_file  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "read_sdpa",
    "SDPProblem",
    "HDSDPSolver",
    "solve_batch",
    "solve_sdpa_file",
]
