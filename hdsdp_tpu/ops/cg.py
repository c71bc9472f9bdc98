"""Preconditioned conjugate gradients for the Schur system.

Mirrors the reference's default Schur-complement backend
(HDSDP_LINSYS_DENSE_ITERATIVE, ref linalg/hdsdp_linsolver.c:1289-1660 and
interface/hdsdp_schur.c:19): Jacobi-preconditioned CG with periodic
restarts, an early bail-out when convergence stalls, and escalation to a
Cholesky preconditioner (== direct solve for dense M) on failure.  The
ADPCG side-car (ref derivative/ADPCG/src/adpcg.c) generalizes the same
rule-based preconditioner-refresh policy; `AdaptiveCG` carries its
analogue across IPM iterations: the Cholesky preconditioner may be REUSED
(stale) for several consecutive KKT systems, refreshed only when the
iteration count degrades.

The CG loop itself is one jitted ``lax.while_loop`` (single dispatch).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hdsdp_tpu.ops import chol as chol_ops

STATUS_OK = 0
STATUS_MAXITER = 1
STATUS_NUMERICAL = 2


class CGResult(NamedTuple):
    x: jnp.ndarray
    status: jnp.ndarray  # int32
    iters: jnp.ndarray  # int32
    resi_norm: jnp.ndarray


@partial(jax.jit, static_argnames=("max_iter", "restart_freq", "use_chol"))
def pcg(
    M,
    rhs,
    precond,  # diag vector (Jacobi) or Cholesky factor L (use_chol=True)
    max_iter: int,
    restart_freq: int = 20,
    abs_tol: float = 1e-06,
    rel_tol: float = 1e-06,
    use_chol: bool = False,
):
    """Single-RHS PCG on symmetric PD M (ref conjGradSolve, :1446-1588)."""

    def apply_p(v):
        if use_chol:
            return chol_ops.chol_solve(precond, v)
        return v / precond

    rhs_norm = jnp.linalg.norm(rhs)
    tol = jnp.maximum(
        jnp.minimum(abs_tol, rhs_norm * rel_tol), 0.1 * abs_tol
    )

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    d0 = apply_p(r0)
    z0 = d0
    Md0 = M @ d0

    def cond(c):
        x, r, d, z, Md, it, status = c
        return status < 0

    def body(c):
        x, r, d, z, Md, it, status = c
        rz = z @ r
        dMd = d @ Md
        alpha = rz / dMd
        x = x + alpha * d

        def restart(args):
            x, r, d, z, Md = args
            r = rhs - M @ x
            d = apply_p(r)
            Md = M @ d
            z = apply_p(r)
            return x, r, d, z, Md

        def advance(args):
            x, r, d, z, Md = args
            r_new = r - alpha * Md
            z_new = apply_p(r_new)
            beta = (r_new @ z_new) / rz
            d_new = z_new + beta * d
            return x, r_new, d_new, z_new, M @ d_new

        do_restart = jnp.logical_and(
            jnp.asarray(not use_chol), (it % restart_freq) == 5
        )
        x, r, d, z, Md = jax.lax.cond(do_restart, restart, advance, (x, r, d, z, Md))

        rn = jnp.linalg.norm(r)
        status = jnp.where(rn != rn, STATUS_NUMERICAL, status)  # NaN
        status = jnp.where(
            jnp.logical_and(status < 0, rn < tol), STATUS_OK, status
        )
        # stall bail-out (ref :1543-1546)
        status = jnp.where(
            jnp.logical_and(
                status < 0,
                jnp.logical_and(it > 20, rn > 0.01 * rhs_norm),
            ),
            STATUS_MAXITER,
            status,
        )
        status = jnp.where(
            jnp.logical_and(status < 0, it + 1 >= max_iter),
            STATUS_MAXITER,
            status,
        )
        return x, r, d, z, Md, it + 1, status

    init_status = jnp.where(
        jnp.linalg.norm(r0) < tol, STATUS_OK, jnp.asarray(-1, jnp.int32)
    )
    x, r, d, z, Md, it, status = jax.lax.while_loop(
        cond, body, (x0, r0, d0, z0, Md0, jnp.asarray(0, jnp.int32), init_status)
    )
    return CGResult(
        x=x, status=status.astype(jnp.int32), iters=it,
        resi_norm=jnp.linalg.norm(r),
    )


@partial(jax.jit, static_argnames=("f32",))
def _equilibrated_factor(M, f32: bool = True):
    """Jacobi-equilibrated Cholesky preconditioner of an f64 SPD M.

    D^-1/2 M D^-1/2 has unit diagonal and entries in [-1, 1] (SPD), so
    an f32 cast can neither overflow nor lose the scale information;
    the equilibration is also the optimal diagonal preconditioning up to
    a factor n.  Returns (L, s, ok) with s = 1/sqrt(diag(M)); L is f32
    (the fast path) or f64 (the escalation tier for kappa > 1/eps_f32).
    """
    d = jnp.diag(M)
    s = jax.lax.rsqrt(jnp.where(d > 0.0, d, 1.0))
    Ms = M * s[:, None] * s[None, :]
    if f32:
        Ms = Ms.astype(jnp.float32)
    L = jnp.linalg.cholesky(Ms)
    ok = jnp.all(jnp.isfinite(L))
    return L, s, ok


@jax.jit
def factor_scaled_f32(Ms):
    """Cholesky factor of an ALREADY-equilibrated f32 SPD matrix (unit
    diagonal): returns (L, ok).  The operator-mode preconditioner path
    materializes M directly in equilibrated f32 chunks (no f64 m x m
    ever exists), so this is `_equilibrated_factor` minus the scaling."""
    L = jnp.linalg.cholesky(Ms)
    return L, jnp.all(jnp.isfinite(L))


@partial(jax.jit, static_argnames=("max_iter",))
def refine_solve(M, L32, s, B, max_iter: int = 40,
                 abs_tol: float = 1e-10, rel_tol: float = 1e-10):
    """Mixed-precision iterative refinement: f32 factor, f64 residuals.

    Solves M X = B [m, k] to f64 accuracy using only the f32 Cholesky
    preconditioner from :func:`_equilibrated_factor` (two triangular
    solves per apply) plus f64 matmuls:

        X += D^-1/2 (L32 L32^T)^-1 D^-1/2 R,   R = B - M X.

    Each sweep contracts the error by ~kappa(M) * eps_f32; near an IPM's
    endgame kappa can exceed 1/eps_f32, in which case the loop stalls
    and the caller escalates to a full-precision factorization.  This is
    the analogue of the reference's Cholesky-preconditioned CG with a
    *stale* factor (ref conjGradSolve hdsdp_linsolver.c:
    1446-1588 + the ADPCG refresh policy): the expensive O(m^3) work
    runs in fast native f32, the O(m^2 k) residuals keep f64.
    """

    bnorm = jnp.max(jnp.linalg.norm(B, axis=0))
    # infinity norm of M for the backward-stable acceptance level: a
    # residual below ~eps * (|B| + |M||X|) is what an exact f64 direct
    # solve would leave -- demanding less is unreachable at high kappa
    # (ref hdsdp_linsolver.c:1204-1236 semantics).
    mnorm = jnp.max(jnp.sum(jnp.abs(M), axis=1))
    eps64 = jnp.float64(2.220446049250313e-16)

    def apply_p(R):
        U = (s[:, None] * R).astype(L32.dtype)
        T = chol_ops.chol_solve(L32, U)
        return s[:, None] * T.astype(jnp.float64)

    def tol_for(X):
        xnorm = jnp.max(jnp.linalg.norm(X, axis=0))
        stable = 16.0 * eps64 * (bnorm + mnorm * xnorm)
        return jnp.maximum(jnp.maximum(abs_tol, rel_tol * bnorm), stable)

    X0 = apply_p(B)
    R0 = B - M @ X0
    rn0 = jnp.max(jnp.linalg.norm(R0, axis=0))

    def cond(c):
        X, R, rn_prev, it, status = c
        return status < 0

    def body(c):
        X, R, rn_prev, it, status = c
        X = X + apply_p(R)
        R = B - M @ X
        rn = jnp.max(jnp.linalg.norm(R, axis=0))
        status = jnp.where(rn != rn, STATUS_NUMERICAL, status)
        status = jnp.where(
            jnp.logical_and(status < 0, rn < tol_for(X)), STATUS_OK, status
        )
        # stalled contraction: a better factor is needed (ref CG stall
        # bail-out semantics, hdsdp_linsolver.c:1543-1546)
        status = jnp.where(
            jnp.logical_and(status < 0, rn > 0.9 * rn_prev),
            STATUS_MAXITER,
            status,
        )
        status = jnp.where(
            jnp.logical_and(status < 0, it + 1 >= max_iter),
            STATUS_MAXITER,
            status,
        )
        return X, R, rn, it + 1, status

    init_status = jnp.where(
        rn0 < tol_for(X0), STATUS_OK, jnp.asarray(-1, jnp.int32)
    )
    init_status = jnp.where(rn0 != rn0, STATUS_NUMERICAL, init_status)
    X, R, rn, it, status = jax.lax.while_loop(
        cond, body, (X0, R0, rn0, jnp.asarray(0, jnp.int32), init_status)
    )
    return X, status, it


class AdaptiveCG:
    """Host-side policy around the mixed-precision Schur solver.

    Carries a possibly STALE f32 preconditioner across consecutive KKT
    systems (the ADPCG idea, ref derivative/ADPCG/src/adpcg.c): the
    factor is refreshed only when refinement with the stale one stops
    converging quickly.  This is what makes an IPM endgame cheap: near
    convergence M changes slowly, so dozens of iterations reuse one
    factorization (the reference's phase-B behavior with its default
    HDSDP_LINSYS_DENSE_ITERATIVE backend).

    Callers must check ``last_status`` / the ``ok`` flag of the
    *_checked entry points: on failure (f32 factor cannot represent M's
    conditioning) the caller escalates to a full-precision direct
    factorization (ref HFpLinsysSwitchToIndefinite,
    hdsdp_linsolver.c:1827-1857) instead of iterating on NaNs.
    """

    def __init__(self, max_iter=40, restart_freq=20,
                 abs_tol=1e-10, rel_tol=1e-10, reuse_threshold=8):
        self.max_iter = max_iter
        self.restart_freq = restart_freq  # kept for API compat
        self.abs_tol = abs_tol
        self.rel_tol = rel_tol
        self.reuse_threshold = reuse_threshold
        self.chol_fac = None  # (L, s) stale preconditioner (f32 or f64)
        self._fresh = False  # factor computed for the current M
        self._f64_left = 0  # systems left before retrying the f32 tier
        self.n_factor = 0
        self.n_solve = 0
        self.last_iters = 0
        self.last_status = STATUS_OK
        self.history = []  # per-call ledger: (kind, detail, seconds)

    def update(self, M) -> None:
        """New KKT system: the stale factor stays unless flagged."""
        self._fresh = False
        if self._f64_left > 0:
            self._f64_left -= 1

    def _factor(self, M, f32: bool) -> bool:
        import time as _time

        t0 = _time.time()
        L, s, ok = _equilibrated_factor(M, f32=f32)
        self.n_factor += 1
        self._fresh = True
        if not bool(ok):
            self.chol_fac = None
            self.history.append(
                ("factor32" if f32 else "factor64", "fail",
                 _time.time() - t0)
            )
            return False
        self.chol_fac = (L, s)
        self.history.append(
            ("factor32" if f32 else "factor64", "ok", _time.time() - t0)
        )
        return True

    def _refine(self, M, rhs_mat):
        import time as _time

        t0 = _time.time()
        L, s = self.chol_fac
        X, status, iters = refine_solve(
            M, L, s, rhs_mat, max_iter=self.max_iter,
            abs_tol=self.abs_tol, rel_tol=self.rel_tol,
        )
        self.last_iters = int(iters)
        self.last_status = int(status)
        self.history.append(
            (
                "refine" + ("_stale" if not self._fresh else ""),
                f"st={self.last_status} it={self.last_iters}",
                _time.time() - t0,
            )
        )
        return X, self.last_status == STATUS_OK

    def summary(self) -> dict:
        """Aggregate the call ledger: where does the KKT-solve time go?"""
        agg: dict = {}
        for kind, detail, dt in self.history:
            e = agg.setdefault(kind, {"n": 0, "s": 0.0})
            e["n"] += 1
            e["s"] += dt
        for e in agg.values():
            e["s"] = round(e["s"], 2)
        refine_iters = [
            int(d.split("it=")[1])
            for k, d, _ in self.history
            if k.startswith("refine")
        ]
        if refine_iters:
            agg["refine_iters"] = {
                "mean": round(sum(refine_iters) / len(refine_iters), 1),
                "max": max(refine_iters),
            }
        return agg

    def solve_mat_checked(self, M, rhs_mat):
        """Solve M X = rhs_mat [m, k].  Returns (X [m, k], ok).

        Tiers: stale factor -> fresh f32 factor -> fresh f64 factor ->
        report failure (caller escalates to the direct ladder,
        ref hdsdp_linsolver.c:1827-1857).
        After an f32 fresh-factor failure the policy prefers f64 factors
        for the next few systems, then retries f32 (conditioning
        fluctuates across IPM iterations).

        The RHS block is padded to a fixed width so the jitted
        refinement compiles at most twice (one per factor dtype)."""
        k = rhs_mat.shape[1]
        self.n_solve += k
        if k < 4:
            rhs_mat = jnp.pad(rhs_mat, ((0, 0), (0, 4 - k)))
        out = self._solve_padded(M, rhs_mat)
        return out[0][:, :k], out[1]

    def _solve_padded(self, M, rhs_mat):

        if self.chol_fac is not None:
            X, ok = self._refine(M, rhs_mat)
            if ok:
                if self.last_iters > self.reuse_threshold:
                    self.chol_fac = None  # refresh on the next system
                return X, True
            full_tier = self.chol_fac[0].dtype == jnp.float64
            if self._fresh and full_tier:
                self.chol_fac = None
                return X, False  # fresh full-precision factor failed
            self.chol_fac = None  # stale (or fresh-f32): escalate below

        if self._f64_left == 0:
            if self._factor(M, f32=True):
                X, ok = self._refine(M, rhs_mat)
                if ok:
                    return X, True
            self._f64_left = 8  # prefer f64 for a while, then retry f32

        if not self._factor(M, f32=False):
            self.last_status = STATUS_NUMERICAL
            return rhs_mat, False
        X, ok = self._refine(M, rhs_mat)
        if not ok:
            self.chol_fac = None
        return X, ok

    def solve_checked(self, M, rhs):
        """Solve M x = rhs.  Returns (x, ok)."""
        x, ok = self.solve_mat_checked(M, rhs[:, None])
        return x[:, 0], ok

    def solve(self, M, rhs):
        """Solve M x = rhs (unchecked; prefer solve_checked)."""
        x, _ = self.solve_checked(M, rhs)
        return x
