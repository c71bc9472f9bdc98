"""Standalone LP interior-point solver (hybrid primal-dual / primal).

Batched re-derivation of the reference's specialized LP module
(ref interface/hdsdp_lpsolve.c + hdsdp_lpkkt.c):

  * Ruiz / geometric / L2 data scaling      (ref HLpSolverIScaleData, :280-311)
  * Mehrotra starting point                 (ref :313-382)
  * Mehrotra predictor-corrector steps on the normal equations
    A D^2 A' dy = rhs with D^2 = x/s        (ref HLpSolverITakePrimalDualStep,
                                             :558-681)
  * primal-only phase with one FIXED factorization used as preconditioner
    (ref HLpSolverIPreparePrimal :683-722, HLpSolverITakePrimalStep
     :949-1092; note the reference's inner CG short-circuits after the
     preconditioner application — hdsdp_lpsolve.c:1046 'goto exit_cleanup'
     right after the initial guess — so the direction is M0^{-1} rhs; we
     reproduce that default and expose real PCG iterations as an option)
  * primal convergence statistics driving the switch-over
    (ref HPrimalStatsUpdate :75-130, HLpSolverICheckPrimalStats :491-531)

Design: A is a dense [nrow, ncol] array; each IPM iteration is ONE
jitted dispatch that forms M = A D^2 A' (one matmul), factors it with
a dense Cholesky and performs both predictor and corrector solves.  The
outer loop runs on host (<=100 iterations).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from hdsdp_tpu.io.mps import MPSData, read_mps

INF = 1e30

# statuses shared with the SDP side
OPTIMAL = "PRIMAL_DUAL_OPTIMAL"
MAXITER = "MAXITER"
TIMELIMIT = "TIMELIMIT"
NUMERICAL = "NUMERICAL"
UNKNOWN = "UNKNOWN"


@dataclass
class LPParams:
    """Defaults mirror HLpSolverIGetDefaultParams (ref hdsdp_lpsolve.c:188-219)."""

    abs_opt_tol: float = 1.0
    abs_feas_tol: float = 1.0
    rel_opt_tol: float = 1e-10
    rel_feas_tol: float = 1e-10
    kkt_primal_reg: float = 1e-14
    kkt_dual_reg: float = 1e-12
    potential_rho: float = 2.0
    primal_update_step: float = 0.995
    dual_update_step: float = 0.995
    iterative_tol: float = 1e-12
    scaling_thresh_tol: float = 1e-04
    barrier_lower_coeff: float = 1e-03
    time_limit: float = 7200.0
    n_scal_iter: int = 10
    max_iter: int = 100
    scal_method: str = "geometric"  # ruiz | geometric | l2 | none
    primal_method: bool = True
    # measured factor:solve wall-time ratio above which the primal-only
    # phase may engage (ref hdsdp_lpsolve.c:501-503 uses 50.0)
    primal_switch_ratio: float = 50.0
    n_inner_cg: int = 0  # ref default: preconditioner-only (see module doc)
    verbose: bool = True


@dataclass
class LPResult:
    status: str
    p_obj: float
    d_obj: float
    x: np.ndarray
    y: np.ndarray
    s: np.ndarray
    n_iters: int
    solve_time: float
    p_infeas: float = 0.0
    d_infeas: float = 0.0


# ----------------------------------------------------------------------
# scaling (ref csp_ruizscal / csp_geoscal / csp_l2scal, linalg/sparse_opts.c)
# ----------------------------------------------------------------------


def scale_data(A: np.ndarray, method: str, n_iter: int):
    """Returns (row_scal, col_scal) with A_scaled = R^-1 A C^-1 semantics
    matching the reference (entries divided by the scalers)."""
    nrow, ncol = A.shape
    r = np.ones(nrow)
    c = np.ones(ncol)
    B = np.abs(A).astype(np.float64)
    if method == "ruiz":
        for _ in range(n_iter):
            rmax = np.sqrt(B.max(axis=1))
            rmax[rmax == 0] = 1.0
            B /= rmax[:, None]
            r *= rmax
            cmax = np.sqrt(B.max(axis=0))
            cmax[cmax == 0] = 1.0
            B /= cmax[None, :]
            c *= cmax
    elif method == "geometric":
        with np.errstate(divide="ignore"):
            for _ in range(2):
                nzmask = B > 0
                rmin = np.where(nzmask, B, np.inf).min(axis=1)
                rmax = B.max(axis=1)
                g = np.sqrt(rmin * rmax)
                g[~np.isfinite(g) | (g == 0)] = 1.0
                B /= g[:, None]
                r *= g
                cmin = np.where(B > 0, B, np.inf).min(axis=0)
                cmax = B.max(axis=0)
                g = np.sqrt(cmin * cmax)
                g[~np.isfinite(g) | (g == 0)] = 1.0
                B /= g[None, :]
                c *= g
    elif method == "l2":
        g = np.linalg.norm(B, axis=1)
        g[g == 0] = 1.0
        r *= g
        B /= g[:, None]
        g = np.linalg.norm(B, axis=0)
        g[g == 0] = 1.0
        c *= g
    return r, c


# ----------------------------------------------------------------------
# jitted kernels: one dispatch per IPM iteration
# ----------------------------------------------------------------------


def _ratio(v, dv):
    """Max step with v + a*dv >= 0, capped at 100
    (ref HLpSolverISingleRatioTest, :533-547)."""
    t = jnp.min(dv / v)
    return jnp.where(t >= 0.0, 100.0, 1.0 / jnp.abs(t))


def _chol_solve(L, r):
    t = jax.scipy.linalg.solve_triangular(L, r, lower=True)
    return jax.scipy.linalg.solve_triangular(L, t, lower=True, trans=1)


def _factor_ladder(M, k0=0):
    """Cholesky with an in-graph diagonal regularization ladder.

    Degenerate LPs (redundant equality rows: acc-tight*) make the normal
    equations A D^2 A' singular; the reference's LDL' backends absorb this
    with static regularization (ref hdsdp_lpkkt.c / qdldl).  Rung ``k``
    adds ``max(diag) * 1e-14 * 100^k`` to the diagonal (rung 0 = none);
    the first attempt starts at the carried rung ``k0`` so a persistently
    singular system pays the escalation once, not every iteration.
    Returns (L, ok, rung_used)."""
    k0 = jnp.asarray(k0, jnp.int32)
    base = jnp.max(jnp.diag(M)) * 1e-14 + 1e-300
    eye = jnp.eye(M.shape[0], dtype=M.dtype)

    def attempt(k):
        reg = jnp.where(k > 0, base * jnp.power(100.0, k.astype(M.dtype)), 0.0)
        L = jnp.linalg.cholesky(M + reg * eye)
        return L, jnp.sum(L - L) == 0.0  # NaN predicate (see ops.chol.chol_ok)

    L, ok = attempt(k0)

    def retry(L0):
        def try_reg(k, carry):
            Lc, okc, kc = carry
            Lr, okr = attempt(k)
            take = jnp.logical_and(jnp.logical_not(okc), okr)
            return (
                jnp.where(take, Lr, Lc),
                jnp.logical_or(okc, okr),
                jnp.where(take, k, kc),
            )

        return jax.lax.fori_loop(
            k0 + 1, k0 + 8, try_reg, (L0, jnp.asarray(False), k0)
        )

    return jax.lax.cond(ok, lambda L0: (L0, ok, k0), retry, L)


@partial(jax.jit, static_argnames=())
def _mehrotra_start(A, b, c, dual_reg):
    """ref HLpSolverIComputeMehrotraStartingPoint (:313-382)."""
    nrow, ncol = A.shape
    M = A @ A.T + dual_reg * jnp.eye(nrow, dtype=A.dtype)
    L, _, _ = _factor_ladder(M)
    x = A.T @ _chol_solve(L, b)
    y = _chol_solve(L, A @ c)
    s = c - A.T @ y
    s = jnp.where(jnp.sum(jnp.abs(s)) < 1e-08, s + 1.0, s)
    dx = jnp.maximum(-1.5 * jnp.min(x), 0.0)
    ds = jnp.maximum(-1.5 * jnp.min(s), 0.0)
    dxs = 0.5 * jnp.sum((x + dx) * (s + ds))
    dxc = dx + dxs / (jnp.sum(s) + ncol * ds)
    dsc = ds + dxs / (jnp.sum(x) + ncol * dx)
    x = x + dxc
    s = s + dsc
    mu = jnp.sum(x * s) / ncol
    return x, y, s, mu


@partial(jax.jit, static_argnames=())
def _pd_step(A, b, c, x, y, s, mu, barrier_lb, p_upd, d_upd, p_reg, d_reg, rung):
    """One Mehrotra predictor-corrector iteration in one dispatch
    (ref HLpSolverITakePrimalDualStep, :558-681)."""
    nrow, ncol = A.shape
    rp = A @ x - b  # primal residual vector (A x - b)
    rd = s + A.T @ y - c  # dual residual (A'y + s - c)

    d2 = x / s + p_reg
    M = (A * d2[None, :]) @ A.T + d_reg * jnp.eye(nrow, dtype=A.dtype)
    L, ok, rung = _factor_ladder(M, rung)

    def msolve(r):
        """Cholesky solve + one iterative-refinement sweep: stabilizes the
        late-IPM normal equations whose conditioning grows like mu^-2."""
        t = _chol_solve(L, r)
        return t + _chol_solve(L, r - M @ t)

    # predictor: dy = M \ (b - A*(d2 .* rd));  (rd enters with ref's sign)
    xsinv_rd = d2 * (-rd)
    rhs = b - A @ (-xsinv_rd)  # = b - A(d2 .* rd_ref), rd_ref = c - A'y - s
    dy_a = msolve(rhs)
    dx_a = -xsinv_rd - x + d2 * (A.T @ dy_a)
    ds_a = -s - dx_a / d2

    ap = jnp.minimum(_ratio(x, dx_a), 1.0)
    ad = jnp.minimum(_ratio(s, ds_a), 1.0)

    mu_aff = jnp.sum((x + ap * dx_a) * (s + ad * ds_a)) / ncol
    sigma3 = (mu_aff / mu) ** 3
    mu_t = jnp.minimum(jnp.maximum(mu * sigma3, barrier_lb), mu)

    # corrector
    rmu = x * s + dx_a * ds_a - mu_t
    rhs = A @ (rmu / s) - rp - A @ (-xsinv_rd)
    dy = msolve(rhs)
    dx = -xsinv_rd - rmu / s + d2 * (A.T @ dy)
    ds = -rmu / x - dx / d2

    ap = jnp.minimum(p_upd * _ratio(x, dx), 1.0)
    ad = jnp.minimum(d_upd * _ratio(s, ds), 1.0)

    x = x + ap * dx
    s = s + ad * ds
    y = y + ad * dy
    mu = jnp.maximum(jnp.sum(x * s) / ncol, barrier_lb)
    return x, y, s, mu, ap, ad, ok, rung


@partial(jax.jit, static_argnames=("n_inner",))
def _primal_step(
    A, b, c, x, y, s, mu, L0, d0, rho, thresh, p_upd, d_upd, d_reg, n_inner: int
):
    """Primal-only step with frozen preconditioner L0 of A diag(d0^2) A'
    (ref HLpSolverITakePrimalStep, :949-1092)."""
    nrow, ncol = A.shape
    rp = A @ x - b
    rd_ref = c - A.T @ y - s  # reference sign: rd = c - A'y - s... but the
    # reference stores dDualInfeasVec = A'y + s - c (ref :404-411); keep that
    rd = -rd_ref

    # shifted scaling matrix (ref :969-982)
    small = x < thresh
    v = jnp.where(small, x, d0)
    err = jnp.where(small, 1.0, v / x)
    v2 = v * v

    rhs = A @ (v * ((v * s) / mu - err))
    d_inf_rel = jnp.linalg.norm(rd) / (jnp.linalg.norm(c) + 1.0)
    rhs = rhs - jnp.where(d_inf_rel > 1e-12, 1.0, 0.0) * (A @ (v2 * rd / mu))
    rhs = rhs - rp

    # fixed-preconditioner solve (+ optional true PCG refinement)
    dy_over_mu = _chol_solve(L0, rhs)

    def matvec(p):
        return A @ (v2 * (A.T @ p)) + d_reg * p

    if n_inner > 0:
        def body(carry, _):
            sol, r, p, rz = carry
            Mp = matvec(p)
            alpha = rz / (p @ Mp)
            sol = sol + alpha * p
            r_new = r - alpha * Mp
            z = _chol_solve(L0, r_new)
            rz_new = r_new @ z
            beta = rz_new / rz
            p = z + beta * p
            return (sol, r_new, p, rz_new), None

        r0 = rhs - matvec(dy_over_mu)
        z0 = _chol_solve(L0, r0)
        (dy_over_mu, _, _, _), _ = jax.lax.scan(
            body, (dy_over_mu, r0, z0, r0 @ z0), None, length=n_inner
        )

    dy = mu * dy_over_mu
    ds = -rd - A.T @ dy
    dx = err * v - (v2 * (s + ds)) / mu

    ap = jnp.minimum(p_upd * _ratio(x, dx), 1.0)
    ad = jnp.minimum(d_upd * _ratio(s, ds), 1.0)

    x = x + ap * dx
    s_cand = s + ad * ds
    y_cand = y + ad * dy

    # additional dual ratio test (ref :1040-1054): accept the full dual
    # update only if c - A'y stays nonnegative
    s_full = c - A.T @ y_cand
    dual_feas = jnp.all(s_full >= 0.0)
    s_new = jnp.where(dual_feas, s_full, s_cand)

    compl = x * s_new
    gap = jnp.sum(compl) / ncol
    target_feas = jnp.minimum(jnp.sum(x * s_new) / (ncol * rho), mu)
    bstep = jnp.minimum(jnp.minimum(ap, ad), 0.6)
    target_infeas = mu * (1.0 - bstep)
    target = jnp.where(dual_feas, target_feas, target_infeas)
    target = jnp.maximum(target, gap / 10.0)

    prox = jnp.max(jnp.abs(compl / gap - 1.0))
    p_inf_rel = jnp.linalg.norm(A @ x - b) / (jnp.linalg.norm(b) + 1.0)
    target = jnp.where(prox < 1.0, target * 0.3, target)
    target = jnp.where(
        (prox > 100.0) & (p_inf_rel > 1e-10), jnp.minimum(mu, gap), target
    )
    return x, y_cand, s_new, target, ap, ad


@jax.jit
def _factor_normal(A, d2, reg):
    """Factor A diag(d2) A' + reg I (the measured 'factor' op)."""
    M = (A * d2[None, :]) @ A.T + reg * jnp.eye(A.shape[0], dtype=A.dtype)
    L, _, _ = _factor_ladder(M)
    return L


@jax.jit
def _solve_normal(L, r):
    """One triangular solve pair (the measured 'solve' op)."""
    return _chol_solve(L, r)


# ----------------------------------------------------------------------
# solver driver
# ----------------------------------------------------------------------


class LPSolver:
    """min c'x s.t. Ax = b, x >= 0 (dense A)."""

    def __init__(self, A: np.ndarray, b: np.ndarray, c: np.ndarray, params=None):
        self.params = params or LPParams()
        self.nrow, self.ncol = A.shape
        p = self.params

        method = p.scal_method
        if method not in ("ruiz", "geometric", "l2", "none"):
            raise ValueError(f"unknown scaling method {method}")
        self.rscal, self.cscal = (
            scale_data(A, method, p.n_scal_iter)
            if method != "none"
            else (np.ones(self.nrow), np.ones(self.ncol))
        )
        As = A / self.rscal[:, None] / self.cscal[None, :]
        bs = b / self.rscal
        cs = c / self.cscal

        # adaptive thresholds (ref HLpSolverICollectLpStats, :270-277)
        a_fro = float(np.linalg.norm(As))
        self.thresh = 1e-03 / max(a_fro, 1e-300)
        self.barrier_lower_coeff = p.barrier_lower_coeff
        if float(np.abs(cs).max(initial=0.0)) < 1e-08:
            self.thresh = 1e-03 / np.sqrt(self.ncol)
            self.barrier_lower_coeff = 1e-05

        self.A = jnp.asarray(As)
        self.b = jnp.asarray(bs)
        self.c = jnp.asarray(cs)
        self.b_norm = float(np.linalg.norm(bs))
        self.c_norm = float(np.linalg.norm(cs))

    def _stats(self, x, y, s):
        """Unscaled residual norms (ref HLpSolverIComputeSolutionStats)."""
        rp = np.asarray(self.A @ x - self.b) * self.rscal
        rd = np.asarray(s + self.A.T @ y - self.c) * self.cscal
        p_inf = float(np.linalg.norm(rp))
        d_inf = float(np.linalg.norm(rd))
        p_obj = float(self.c @ x)
        d_obj = float(self.b @ y)
        return p_inf, d_inf, p_obj, d_obj

    def optimize(self) -> LPResult:
        p = self.params
        t0 = time.time()
        n = self.ncol
        barrier_lb = p.rel_feas_tol * self.barrier_lower_coeff

        x, y, s, mu = _mehrotra_start(self.A, self.b, self.c, p.kkt_dual_reg)
        mu = float(mu)

        status = UNKNOWN
        method = "pd"
        L0 = None
        d0 = None
        prev_x = None
        ap = ad = 0.0
        n_iter = 0
        # best-iterate safeguard: the normal equations' conditioning grows
        # like mu^-2, so late iterations can regress; keep the best point
        # (analogue of the reference's primal-stats stall machinery,
        # ref HPrimalStatsSuperlinerTest / HLpSolverICheckPrimalStats)
        best_metric = np.inf
        best_point = None
        n_stall = 0
        # factor:solve WALL-TIME ratio, measured on the actual jitted ops
        # (ref uses measured times as the policy signal,
        # def_hdsdp_lpkkt.h:42-46, hdsdp_lpsolve.c:501-503); measured once
        # after warm-up at iteration 2
        from hdsdp_tpu.utils.profile import PhaseStats

        self.stats = PhaseStats()
        factor_solve_ratio = 0.0
        reg_rung = 0  # carried regularization-ladder rung (see _factor_ladder)

        if p.verbose:
            print(
                f"Optimizing an LP of {self.ncol} variables and "
                f"{self.nrow} constraints (hybrid primal-dual)"
            )
            print(
                f"    {'nIter':>5s} {'pObj':>15s} {'dObj':>15s} "
                f"{'pInf':>8s} {'dInf':>8s} {'Mu':>8s} {'P/D Step':>10s}"
            )

        for n_iter in range(1, p.max_iter + 1):
            if method == "primal":
                x_new, y_new, s_new, mu_new, ap, ad = _primal_step(
                    self.A, self.b, self.c, x, y, s, mu, L0, d0,
                    p.potential_rho, self.thresh, p.primal_update_step,
                    p.dual_update_step, p.kkt_dual_reg, p.n_inner_cg,
                )
            else:
                x_new, y_new, s_new, mu_new, ap, ad, ok, rung = _pd_step(
                    self.A, self.b, self.c, x, y, s, mu, barrier_lb,
                    p.primal_update_step, p.dual_update_step,
                    p.kkt_primal_reg, p.kkt_dual_reg, reg_rung,
                )
                reg_rung = min(int(rung), 8)
                if not bool(ok):
                    # even the regularization ladder failed: classify via
                    # the best iterate below
                    status = OPTIMAL if best_metric <= 1e-06 else NUMERICAL
                    break
            mu_new = float(mu_new)
            if not np.isfinite(mu_new):
                status = NUMERICAL
                break
            prev_x = np.asarray(x)
            x, y, s, mu = x_new, y_new, s_new, mu_new

            if n_iter == 2 and p.primal_method and factor_solve_ratio == 0.0:
                # one-time measurement of the factor:solve wall-time ratio
                # on the warm jitted ops
                from hdsdp_tpu.utils.profile import profile_fn

                d2m = x / s + p.kkt_primal_reg
                tf = profile_fn(
                    _factor_normal, self.A, d2m, p.kkt_dual_reg, n=2
                )
                Lm = _factor_normal(self.A, d2m, p.kkt_dual_reg)
                ts = profile_fn(_solve_normal, Lm, self.b, n=2)
                self.stats.factor_s += tf
                self.stats.solve_s += max(ts, 1e-12)
                self.stats.n_factor += 1
                self.stats.n_solve += 1
                factor_solve_ratio = self.stats.factor_solve_ratio

            p_inf, d_inf, p_obj, d_obj = self._stats(x, y, s)
            gap = abs(p_obj - d_obj)
            gap_rel = gap / (abs(p_obj) + abs(d_obj) + 1.0)
            p_inf_rel = p_inf / (self.b_norm + 1.0)
            d_inf_rel = d_inf / (self.c_norm + 1.0)

            if p.verbose:
                print(
                    f"    {n_iter:5d} {p_obj:+15.8e} {d_obj:+15.8e} "
                    f"{p_inf_rel:8.2e} {d_inf_rel:8.2e} {mu:8.2e} "
                    f"{float(ap):5.2f} {float(ad):5.2f}"
                )

            metric = max(gap_rel, p_inf_rel, d_inf_rel)
            if metric < best_metric:
                best_metric = metric
                best_point = (np.asarray(x), np.asarray(y), np.asarray(s))
                n_stall = 0
            else:
                n_stall += 1

            if (
                gap_rel <= p.rel_opt_tol
                and p_inf_rel <= p.rel_feas_tol
                and d_inf_rel <= p.rel_feas_tol
                and gap <= p.abs_opt_tol
                and p_inf <= p.abs_feas_tol
                and d_inf <= p.abs_feas_tol
            ):
                status = OPTIMAL
                break
            if n_stall >= 8 or metric > 1e+04 * best_metric:
                # no progress: restore the best point and classify (1e-6
                # relative acceptance; cf. the 1e-2 DIMACS gate on the SDP
                # side, ref hdsdp.c:905-921)
                status = OPTIMAL if best_metric <= 1e-06 else NUMERICAL
                if p.verbose:
                    print(
                        f"Stalling detected; returning best iterate "
                        f"(metric {best_metric:.2e})"
                    )
                break
            if not np.isfinite(gap):
                status = NUMERICAL
                break
            if time.time() - t0 > p.time_limit:
                status = TIMELIMIT
                break

            # switch-over test (ref HLpSolverICheckPrimalStats, :491-531)
            if method == "pd" and p.primal_method and prev_x is not None:
                xa = np.asarray(x)
                diff = np.abs(xa - prev_x)
                euclid = float(diff.max())
                scal_diff = diff / np.maximum(prev_x, 1e-300)
                thr = np.where(xa > self.thresh, scal_diff, diff)
                thr_metric = float(thr.max())
                cond_est = (
                    ((1 + thr_metric) / (1 - thr_metric)) ** 2
                    if thr_metric < 1.0
                    else np.inf
                )
                cond2 = (cond_est < 100.0 or euclid < 1e-05) and (
                    gap_rel < 1e-03 and gap_rel > p.rel_opt_tol * 1e+02
                )
                cond3 = euclid < 1e-05 and float(ap) >= 0.1
                if factor_solve_ratio >= p.primal_switch_ratio and (
                    cond2 or cond3
                ):
                    if p.verbose:
                        print("Primal interior point method starts")
                    d0 = jnp.asarray(np.asarray(x))
                    M0 = (self.A * (d0 * d0)[None, :]) @ self.A.T
                    M0 = M0 + p.kkt_dual_reg * jnp.eye(self.nrow, dtype=M0.dtype)
                    L0 = jnp.linalg.cholesky(M0)
                    method = "primal"
        else:
            status = MAXITER

        if best_point is not None:
            # report the best iterate seen, not the last one
            p_inf, d_inf, p_obj, d_obj = self._stats(x, y, s)
            cur_metric = max(
                abs(p_obj - d_obj) / (abs(p_obj) + abs(d_obj) + 1.0),
                p_inf / (self.b_norm + 1.0),
                d_inf / (self.c_norm + 1.0),
            )
            if best_metric < cur_metric:
                x, y, s = (jnp.asarray(v) for v in best_point)

        self.last_method = method  # "pd" or "primal" (which phase ended)
        p_inf, d_inf, p_obj, d_obj = self._stats(x, y, s)
        return LPResult(
            status=status,
            p_obj=p_obj,
            d_obj=d_obj,
            x=np.asarray(x) / self.cscal,
            y=np.asarray(y) / self.rscal,
            s=np.asarray(s) * self.cscal,
            n_iters=n_iter,
            solve_time=time.time() - t0,
            p_infeas=p_inf,
            d_infeas=d_inf,
        )


def solve_mps_file(path: str, **param_overrides) -> LPResult:
    """Extension-dispatch driver for .mps (ref tests/test_file_io.c:89-183)."""
    data = read_mps(path)
    A = np.zeros((data.nrow, data.ncol))
    for j in range(data.ncol):
        lo, hi = data.col_ptr[j], data.col_ptr[j + 1]
        A[data.row_idx[lo:hi], j] += data.val[lo:hi]
    params = LPParams(**param_overrides)
    solver = LPSolver(A, data.b, data.c, params)
    res = solver.optimize()
    # map back to the original objective space
    res.p_obj = data.objsense * res.p_obj + data.obj_shift
    res.d_obj = data.objsense * res.d_obj + data.obj_shift
    if params.verbose:
        print(f"\nLP Status: {res.status}")
        print(f"  pObj {res.p_obj:+15.10e}")
        print(f"  dObj {res.d_obj:+15.10e}")
    return res
