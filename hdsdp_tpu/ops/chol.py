"""Cholesky-based primitives: PSD check, inverse, logdet, triangular solves.

Parity: the reference's linear-system vtable (ref linalg/hdsdp_linsolver.c)
uses dpotrf success/failure as the PSD predicate
(lapackLinSolverPsdCheck, hdsdp_linsolver.c:1112-1144).  XLA's Cholesky
produces NaNs for non-PSD inputs, giving the same predicate batched.

All functions accept batched inputs [..., n, n].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def cholesky(S: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.cholesky(S)


def chol_ok(L: jnp.ndarray) -> jnp.ndarray:
    """True iff the factorization succeeded (matrix was PD).

    Implemented arithmetically (sum of L - L is NaN iff any entry is
    NaN/Inf): one reduction, no [n, n] boolean intermediate inside the
    ``lax.cond`` branches that call it.
    """
    s = jnp.sum(L - L)
    return s == 0.0


def psd_check(S: jnp.ndarray):
    """(is_interior, L). Mirrors HFpLinsysPsdCheck semantics."""
    L = cholesky(S)
    return chol_ok(L), L


def chol_logdet(L: jnp.ndarray) -> jnp.ndarray:
    """log det(S) = 2 sum log diag(L) (ref sdpDenseConeGetBarrier,
    hdsdp_conic_sdp.c:2279-2287), summed over the batch."""
    d = jnp.diagonal(L, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(d))


def chol_inverse(L: jnp.ndarray) -> jnp.ndarray:
    """S^{-1} from the Cholesky factor (ref HFpLinsysInvert -> dpotri)."""
    n = L.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=L.dtype), L.shape)
    Linv = solve_triangular(L, eye, lower=True)
    return jnp.einsum("...ki,...kj->...ij", Linv, Linv)


def chol_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    y = solve_triangular(L, b, lower=True)
    return solve_triangular(L, y, lower=True, trans=1)


def congruence(L: jnp.ndarray, W: jnp.ndarray) -> jnp.ndarray:
    """L^{-1} W L^{-T} for symmetric W, batched.

    Used by the ratio test: S + a*dS >= 0 iff I + a L^{-1} dS L^{-T} >= 0
    (ref sdpDenseConeILanczosMultiply, hdsdp_conic_sdp.c:462-505).
    """
    X = solve_triangular(L, W, lower=True)
    X = solve_triangular(L, jnp.swapaxes(X, -1, -2), lower=True)
    return X


def factor_kkt(M: jnp.ndarray, reg: float = 0.0):
    """Factor the Schur complement with a small regularization ladder.

    The reference escalates CG -> dense LDL on Cholesky failure
    (ref hdsdp_linsolver.c:1827-1857, 2030-2045).  Dense-first here: try
    Cholesky; the solver driver retries with diagonal regularization and
    finally an LU solve if needed.
    """
    if reg:
        M = M + reg * jnp.eye(M.shape[-1], dtype=M.dtype)
    L = cholesky(M)
    return L, chol_ok(L)
