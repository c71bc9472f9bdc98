"""Primal recovery + DIMACS error check (ref HDSDPCheckSolution,
interface/hdsdp.c:771-933, and HConeGetPrimal / sdpDenseConeGetPrimal,
hdsdp_conic_sdp.c:2395-2446).

The primal matrix per cone is recovered from a recorded "maker"
(mu*, y*) as

    X = mu* ( Sbar^-1 + Sbar^-1 W Sbar^-1 ),   Sbar = C - A'y*,  W = A'(dy)

computed with batched Cholesky + congruence instead of the reference's
two triangular solve sweeps.  Unlike the reference (which reuses the
in-solve dy step), ``dy`` is RE-SOLVED at check time against M and
ASinv built from the SAME S^-1 used for the recovery congruence:

    (M(U) + D_bound) dy = b/mu* - (ASinv(U) + u^-1 - l^-1),  U = Sbar^-1.

This makes the triple (mu*, U, dy) exactly self-consistent, so
A(X) - b = mu* (solve residual + bound-cone terms) regardless of the
precision the SOLVE-time factors ran at: a dy recorded against a
*nearby* S-tilde would expose the kappa(S)-amplified gap when recovered
against the exact Sbar.

In operator mode (kkt_free, M never materialized) the re-solve runs the
same matrix-free Jacobi-PCG as the solve path.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hdsdp_tpu.ops import chol as chol_ops
from hdsdp_tpu.ops import schur as schur_ops
from hdsdp_tpu.solver import memory
from hdsdp_tpu.solver.cones import (
    _assemble,
    _atx,
    _ctx,
    _factor,
    _inverses,
    _kkt_diag,
    _kkt_matvec,
    _kkt_pcg,
    _kkt_pcg_chol,
)


# above this block dimension the f64 min-eigenvalue check switches from
# exact f64 eigh to f32 eigh + f64 Rayleigh refinement
_EXACT_EIG_DIM = 384

# above this block dimension no dense eigh runs at all (a dense eigh's
# O(n^2) temps ran a device out of memory at n = 10648).  The minimum
# eigenvalue is instead estimated by a reorthogonalized Lanczos sweep on
# -X + one f64 Rayleigh quotient — the extreme-eigenvalue machinery the
# reference itself uses for step lengths (ref
# linalg/hdsdp_lanczos.c:161-292), here pointed at the PSD check.
_LANCZOS_EIG_DIM = 8192


def _lanczos_min_one(X: jnp.ndarray, krylov: int = 64,
                     restarts: int = 3) -> jnp.ndarray:
    """lambda_min estimate of one symmetric [n, n] block: restarted
    Lanczos on -X (full reorthogonalization, v0 = previous Ritz vector)
    + f64 Rayleigh quotient.  O(r k n^2) flops, O(k n) memory — no dense
    eig at any n.  NOTE the risk direction: Lanczos approaches
    lambda_max(-X) from below, so an unconverged sweep makes X look
    MORE PSD than it is (a real negativity can be missed).  For that
    reason blocks this large are no longer accepted on the estimate
    alone — `_certified_block_min_eval` below adds the reference's
    try-Cholesky certificate (hdsdp_linsolver.c:1112-1144) on X + dI,
    and the REPORTED err2 comes from the certificate; this estimate is
    only the refiner."""
    n = X.shape[-1]

    def sweep(v):
        V = jnp.zeros((krylov + 1, n), X.dtype).at[0].set(v)
        alpha = jnp.zeros((krylov,), X.dtype)
        beta = jnp.zeros((krylov,), X.dtype)

        def body(i, c):
            V, alpha, beta = c
            vi = V[i]
            w = -(X @ vi)
            a = vi @ w
            w = w - a * vi
            # full reorth against the built basis (rows > i are 0)
            w = w - V.T @ (V @ w)
            b = jnp.linalg.norm(w)
            V = V.at[i + 1].set(jnp.where(b > 1e-300, w / b, 0.0))
            return V, alpha.at[i].set(a), beta.at[i].set(b)

        V, alpha, beta = jax.lax.fori_loop(0, krylov, body, (V, alpha, beta))
        T = (
            jnp.diag(alpha)
            + jnp.diag(beta[:-1], 1)
            + jnp.diag(beta[:-1], -1)
        )
        _, evecs = jnp.linalg.eigh(T)
        u = V[:krylov].T @ evecs[:, -1]  # Ritz vector of lambda_max(-X)
        return u / jnp.linalg.norm(u)

    v = jax.random.normal(jax.random.PRNGKey(7), (n,), X.dtype)
    u = v / jnp.linalg.norm(v)
    for _ in range(restarts):
        u = sweep(u)
    return u @ (X @ u)


def _try_chol_ok(A: jnp.ndarray) -> bool:
    """The reference's PSD predicate — try a Cholesky, success means PSD
    up to factorization rounding (ref HFpLinsysPsdCheck,
    hdsdp_linsolver.c:1112-1144)."""
    L = jnp.linalg.cholesky(A)
    return bool(jnp.all(jnp.isfinite(L)))


def _certified_block_min_eval(X: jnp.ndarray, est: float) -> float:
    """CERTIFIED lambda_min lower bound for one huge [n, n] block.

    Walks a shift ladder delta_0 = 0 < delta_1 < ... and returns
    -(delta* + eps) for the first delta* whose Cholesky of X + delta* I
    succeeds: that factorization certifies lambda_min(X) >= -delta* up
    to the factor's own rounding slack eps ~ c n u ||diag|| (u = 2^-53,
    the same guarantee as the reference's dpotrf predicate).  Unlike the
    Lanczos estimate (an upper bound on lambda_min that can only
    UNDER-report a violation), the returned value is a lower bound, so
    DIMACS err2 computed from it can only over-report — by at most the
    decade granularity of the ladder.  Typical cost: ONE factorization
    (the converged IPM's X is PSD and rung 0 succeeds).

    ``est`` (the Lanczos refinement) only tightens the failure report
    when even the widest shift fails."""
    n = X.shape[0]
    scale = float(jnp.max(jnp.abs(jnp.diagonal(X)))) + 1e-300
    u = 2.0 ** -53  # f64 unit roundoff
    eps = 4.0 * n * u * scale
    deltas = [0.0] + [scale * 10.0 ** e for e in range(-14, -1)]
    eye = jnp.eye(n, dtype=X.dtype)
    for d in deltas:
        if _try_chol_ok(X if d == 0.0 else X + d * eye):
            return -(d + eps)
    # nothing certifies: X is indefinite beyond 1e-2 * scale — far past
    # any acceptance gate; report the worse of the ladder bound and the
    # Lanczos estimate
    return min(est, -deltas[-1])


def _uwu(U: jnp.ndarray, W: jnp.ndarray) -> jnp.ndarray:
    """Recovery congruence U W U per block [g, n, n]."""
    return jnp.einsum("gij,gjk,gkl->gil", U, W, U, optimize=True)


def _batch_min_eval(Xg: jnp.ndarray) -> jnp.ndarray:
    """Min eigenvalue over a [g, n, n] symmetric block batch.

    Small blocks: exact eigvalsh in the working dtype.  Large f64
    blocks: the minimizing eigenvector is located with an f32 eigh and
    the eigenvalue refined by one f64 Rayleigh quotient v'Xv.  The quotient error is O(||X|| sin^2 theta) for
    eigenvector angle error theta ~ 1e-7 — orders below the 1e-2 DIMACS
    acceptance gate (ref hdsdp.c:905-921) — and a genuinely negative
    direction at gate scale is fully resolved in f32.
    """
    n = Xg.shape[-1]
    if n < _EXACT_EIG_DIM or Xg.dtype != jnp.float64:
        return jnp.min(jnp.linalg.eigvalsh(Xg))
    if n >= _LANCZOS_EIG_DIM:
        return jnp.min(jax.vmap(_lanczos_min_one)(Xg))
    _, V = jnp.linalg.eigh(Xg.astype(jnp.float32))
    v = V[..., :, 0].astype(Xg.dtype)
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    return jnp.min(jnp.einsum("...i,...ij,...j->...", v, Xg, v))


# ----------------------------------------------------------------------
# check-time KKT at the maker point (consistency re-solve)
# ----------------------------------------------------------------------


@partial(jax.jit, static_argnames=("m", "with_m"))
def _maker_kkt(groups, lp, b, mk_mu, mk_y, perturb, lo, up, m: int,
               with_m: bool):
    """Factor Sbar at the maker point, compute U = Sbar^-1, and build
    the KKT system (M + bound diag, rhs) from the SAME U.

    The LAST accurate maker sits closest to the cone boundary
    (min-eig(Sbar) ~ mu* scale), so the plain f64 factor can fail
    marginally there — observed at torus-22 with mu* = 3e-9, where the
    check would otherwise silently fall back to the 1e-5-quality inacc
    maker (the real round-3 accuracy ceiling).  A diagonal shift ladder
    keeps the acc maker usable: delta only redefines the (still PSD)
    recovery map, and because dy is re-solved against M/ASinv built
    from the SAME shifted U, the consistency identity A(X) ~ b is
    unaffected; the shift's effect on the errors is O(mu* delta), far
    below gap level for delta ~ 1e-14 ||Sbar||."""
    Sbar, sbar_lp = _assemble(groups, lp, 1.0, -1.0, mk_y, perturb)
    ok, Lbar = _factor(Sbar, sbar_lp)

    scale = jnp.zeros((), b.dtype)
    for Sg in Sbar:
        scale = jnp.maximum(
            scale, jnp.max(jnp.abs(jnp.diagonal(Sg, axis1=-2, axis2=-1)))
        )

    def shift_cond(carry):
        k, ok_c, _ = carry
        return jnp.logical_and(jnp.logical_not(ok_c), k < 5)

    def shift_body(carry):
        k, _, L_c = carry
        delta = scale * 1e-14 * (10.0 ** (2 * k))
        S_shift = tuple(
            Sg + delta * jnp.eye(Sg.shape[-1], dtype=Sg.dtype)
            for Sg in Sbar
        )
        ok_s, L_s = _factor(S_shift, sbar_lp)
        L_c = tuple(
            jnp.where(ok_s, Ls, Lc) for Ls, Lc in zip(L_s, L_c)
        )
        return k + 1, ok_s, L_c

    _, ok, Lbar = jax.lax.while_loop(
        shift_cond, shift_body, (jnp.asarray(0), ok, Lbar)
    )
    Us = _inverses(Lbar)

    dtype = b.dtype
    M = jnp.zeros((m, m), dtype) if with_m else None
    asinv = jnp.zeros((m,), dtype)
    for ga, U in zip(groups, Us):
        out = schur_ops.group_schur(ga, U, m, with_m=with_m)
        if with_m:
            M = M + out.M
        asinv = asinv + out.asinv
    if lp is not None:
        out = schur_ops.lp_schur(lp, sbar_lp, m, with_m=with_m)
        if with_m:
            M = M + out.M
        asinv = asinv + out.asinv

    # bound cone at the maker point, tau = 1 (ref sBoundConeGetKKT)
    li = 1.0 / (mk_y - lo)
    ui = 1.0 / (up - mk_y)
    d_bound = li * li + ui * ui
    if with_m:
        M = M + jnp.diag(d_bound)
    rhs = b / mk_mu - (asinv + ui - li)
    return ok, Us, sbar_lp, M, d_bound, rhs


@jax.jit
def _chol_solve_ladder(M, rhs):
    """f64 Cholesky solve with an in-graph regularization ladder and one
    residual-correction sweep (the check-time system is factored once)."""
    L = jnp.linalg.cholesky(M)
    ok = jnp.all(jnp.isfinite(L))

    def retry(_):
        base = jnp.max(jnp.diag(M)) * 1e-14 + 1e-300

        def try_reg(k, carry):
            Lc, okc = carry
            reg = base * (10.0 ** (2 * k))
            Lr = jnp.linalg.cholesky(
                M + reg * jnp.eye(M.shape[0], dtype=M.dtype)
            )
            okr = jnp.all(jnp.isfinite(Lr))
            take = jnp.logical_and(jnp.logical_not(okc), okr)
            return jnp.where(take, Lr, Lc), jnp.logical_or(okc, okr)

        return jax.lax.fori_loop(0, 6, try_reg, (L, jnp.asarray(False)))

    L, ok = jax.lax.cond(ok, lambda _: (L, ok), retry, None)
    L = jnp.where(ok, L, jnp.eye(M.shape[0], dtype=M.dtype))
    x = chol_ops.chol_solve(L, rhs)
    x = x + chol_ops.chol_solve(L, rhs - M @ x)  # one refinement sweep
    return ok, x


def _solve_maker_dy(ipm, Us, sbar_lp, M, d_bound, rhs):
    """dy from the check-time KKT: dense Cholesky when M exists, else
    matrix-free CG (operator mode) — with a fresh chunk-materialized f32
    Cholesky preconditioner at the MAKER point when the layout supports
    it (the Jacobi-only re-solve stalls at endgame conditioning, leaving
    err1/err5 at ~1e-6; the chol-PCG reaches the direct path's grade)."""
    if M is not None:
        ok, dy = _chol_solve_ladder(M, rhs)
        return dy if bool(ok) else None
    cones = ipm.cones
    diag = _kkt_diag(cones.groups, cones.lp, Us, sbar_lp, ipm.m) + d_bound
    p = ipm.params
    if (
        ipm.m <= memory.dense_m_cap()
        and getattr(ipm, "mesh", None) is None
        and cones.kkt_rows_supported()
    ):
        try:
            pc = ipm._build_chunked_precond(Us, sbar_lp, d_bound, diag)
        except RuntimeError:
            pc = None
        if pc is not None:
            L32, s = pc
            B = rhs[:, None]
            X = jnp.zeros_like(B)
            R = B
            chunk = max(p.kkt_free_maxiter, 600)
            for _ in range(8):
                dX, _, _ = _kkt_pcg_chol(
                    cones.groups, cones.lp, Us, sbar_lp, d_bound, L32,
                    s, R, ipm.m, 1e-10, 1e-10, chunk,
                )
                X = X + dX
                R = B - _kkt_matvec(
                    cones.groups, cones.lp, Us, sbar_lp, d_bound, X, ipm.m
                )
                if float(jnp.max(jnp.linalg.norm(R, axis=0))) <= 1e-10 * max(
                    float(jnp.linalg.norm(rhs)), 1.0
                ):
                    break
            return X[:, 0]
    pinv = 1.0 / jnp.maximum(diag, 1e-300)
    # restarted chunks of kkt_free_maxiter per dispatch
    B = rhs[:, None]
    X = jnp.zeros_like(B)
    R = B
    # the check is one-time: use a sane per-chunk budget even when the
    # solve ran with a starved kkt_free_maxiter
    chunk = max(ipm.params.kkt_free_maxiter, 600)
    for _ in range(8):
        dX, res, _ = _kkt_pcg(
            cones.groups, cones.lp, Us, sbar_lp, d_bound, pinv, R,
            ipm.m, 1e-10, 1e-10, chunk,
        )
        X = X + dX
        R = B - _kkt_matvec(
            cones.groups, cones.lp, Us, sbar_lp, d_bound, X, ipm.m
        )
        if float(jnp.max(jnp.linalg.norm(R, axis=0))) <= 1e-10 * max(
            float(jnp.linalg.norm(rhs)), 1.0
        ):
            break
    return X[:, 0]


@partial(jax.jit, static_argnames=("m",))
def _dimacs_eval(groups, lp, b, y, Rd, perturb, mk_mu, dy, Us, sbar_lp,
                 m: int):
    """Recovery + raw error parts from the consistent (mu*, U, dy)."""
    W, w_lp = _assemble(groups, lp, 0.0, 1.0, dy, 0.0)

    X_list = []
    for U, Wg in zip(Us, W):
        X = mk_mu * (U + _uwu(U, Wg))
        X_list.append(0.5 * (X + jnp.swapaxes(X, -1, -2)))
    x_lp = (
        mk_mu * (sbar_lp + w_lp) / (sbar_lp * sbar_lp)
        if lp is not None
        else None
    )

    S, s_lp = _assemble(groups, lp, 1.0, -1.0, y, -Rd + perturb)

    d_obj = b @ y
    ax = _atx(groups, lp, tuple(X_list), x_lp, m)
    p_obj = _ctx(groups, lp, tuple(X_list), x_lp)

    compl = jnp.zeros((), b.dtype)
    for Xg, Sg in zip(X_list, S):
        compl = compl + jnp.sum(Xg * Sg)
    if lp is not None:
        compl = compl + x_lp @ s_lp

    # per-group minimum eigenvalues (estimates at n >= _LANCZOS_EIG_DIM,
    # combined with the host-side try-Cholesky certificate by the caller)
    min_evals = tuple(_batch_min_eval(Xg) for Xg in X_list)
    lp_min = jnp.min(x_lp) if lp is not None else jnp.asarray(jnp.inf, b.dtype)

    p_inf_norm = jnp.linalg.norm(ax - b)
    return p_obj, d_obj, compl, min_evals, lp_min, p_inf_norm, tuple(X_list)


def _consistent_maker_solve(ipm, maker):
    """(Us, sbar_lp, dy) for the maker, or None if Sbar is not PD."""
    import time as _time

    times = getattr(ipm, "_check_times", None)
    if times is None:
        times = ipm._check_times = {}
    t0 = _time.time()
    cones = ipm.cones
    with_m = not ipm.kkt_free
    if with_m and (
        getattr(cones, "is_row_sharded", False)
        or ipm.m > ipm.materialize_cap()
    ):
        # Never materialize + factor the full unsharded m x m M at check
        # time on a row-sharded mesh run (whose whole design keeps M
        # distributed) or above the operator materialization cap: route
        # the consistency dy through the matrix-free Jacobi-PCG exactly
        # as the kkt_free path does.
        with_m = False
    ok, Us, sbar_lp, M, d_bound, rhs = _maker_kkt(
        cones.groups, cones.lp, ipm.b,
        jnp.asarray(maker.mu, ipm.dtype),
        jnp.asarray(maker.y, ipm.dtype),
        jnp.asarray(ipm.perturb, ipm.dtype),
        jnp.asarray(ipm.bound_lo, ipm.dtype),
        jnp.asarray(ipm.bound_up, ipm.dtype),
        ipm.m, with_m,
    )
    ok = bool(ok)
    times["maker_kkt"] = times.get("maker_kkt", 0.0) + _time.time() - t0
    if not ok:
        return None
    t0 = _time.time()
    dy = _solve_maker_dy(ipm, Us, sbar_lp, M, d_bound, rhs)
    del M, rhs  # free the m x m system before the recovery congruences
    if dy is not None:
        dy.block_until_ready()
    times["maker_dy"] = times.get("maker_dy", 0.0) + _time.time() - t0
    if dy is None:
        return None
    return Us, sbar_lp, dy


def recover_primal(ipm, maker) -> Optional[Tuple[List[jnp.ndarray], Optional[jnp.ndarray]]]:
    """X per SDP group + LP primal vector for a given maker; None if the
    maker's dual check matrix is not PD (recovery step infeasible)."""
    out = _consistent_maker_solve(ipm, maker)
    if out is None:
        return None
    Us, sbar_lp, dy = out
    cones = ipm.cones
    W, w_lp = cones.assemble(0.0, 1.0, dy, 0.0)
    X_list = []
    for U, Wg in zip(Us, W):
        X = maker.mu * (U + _uwu(U, Wg))
        X_list.append(0.5 * (X + jnp.swapaxes(X, -1, -2)))
    x_lp = None
    if cones.has_lp:
        x_lp = maker.mu * (sbar_lp + w_lp) / (sbar_lp * sbar_lp)
    return X_list, x_lp


def check_solution(ipm) -> np.ndarray:
    """Compute the 6 DIMACS errors and set the final status.

    Mirrors HDSDPCheckSolution including the acc -> inacc maker retry
    (ref hdsdp.c:905-918).
    """
    from hdsdp_tpu.solver import algo

    errs = np.ones(6)
    if ipm.maker_acc.mu <= 0.0 and ipm.maker_inacc.mu <= 0.0:
        ipm.status = algo.NUMERICAL
        return errs

    # the check recomputes everything from (y, makers, cone data); at
    # torus-22 scale the retained solve buffers would not fit beside
    # the recovery program's runtime peak
    ipm.release_solve_buffers()

    use_acc = ipm.maker_acc.mu > 0.0

    while True:
        maker = ipm.maker_acc if use_acc else ipm.maker_inacc
        errs = _dimacs_errors(ipm, maker)
        if errs is None:
            errs = np.ones(6)
        max_err = float(np.max(np.abs(errs)))
        if max_err > 1e-02:
            if use_acc:
                # primal solution not good: switch maker (ref hdsdp.c:909-918)
                ipm.log.info("\nDealing with primal solution")
                use_acc = False
                if ipm.maker_inacc.mu > 0.0:
                    continue
            ipm.status = algo.NUMERICAL
        else:
            ipm.status = algo.PRIMAL_DUAL_OPTIMAL
        return errs


def _errors_from_parts(ipm, p_obj, d_obj, compl, min_eval, p_inf_norm):
    f = ipm.f
    pd_scal = ipm.rhs_scal * ipm.obj_scal
    d_obj = d_obj / pd_scal
    p_obj = p_obj / pd_scal
    p_infeas = p_inf_norm / ipm.rhs_scal
    d_infeas = ipm.perturb * np.sqrt(max(f.n_sum_cone_dims, 1)) / ipm.obj_scal

    errs = np.zeros(6)
    errs[0] = p_infeas / (1.0 + f.rhs_one_norm)
    errs[1] = -min_eval / (1.0 + f.rhs_one_norm) if min_eval < 0.0 else 0.0
    errs[2] = d_infeas / (1.0 + f.obj_one_norm)
    errs[3] = 0.0
    errs[4] = (p_obj - d_obj) / (abs(p_obj) + abs(d_obj) + 1.0)
    errs[5] = compl / (abs(p_obj) + abs(d_obj) + 1.0)

    ipm.p_obj_val = p_obj
    ipm.d_obj_val = d_obj
    return errs


def _dimacs_errors(ipm, maker) -> Optional[np.ndarray]:
    cones = ipm.cones

    if getattr(ipm, "psdp", None) is not None and getattr(ipm.psdp, "X", None) is not None:
        # PSDP-refined primal: compute errors from the explicit X (host)
        X_list, x_lp = ipm.psdp.get_primal()
        S, s_lp = cones.assemble(1.0, -1.0, ipm.y, -ipm.Rd + ipm.perturb)
        d_obj = float(ipm.b @ ipm.y)
        ax = cones.atx(X_list, x_lp)
        p_obj = float(cones.ctx(X_list, x_lp))
        compl = 0.0
        for Xg, Sg in zip(X_list, S):
            compl += float(jnp.sum(Xg * Sg))
        if cones.has_lp:
            compl += float(x_lp @ s_lp)
        min_eval = np.inf
        for Xg in X_list:
            me = float(_batch_min_eval(Xg))
            if Xg.shape[-1] >= _LANCZOS_EIG_DIM and Xg.dtype == jnp.float64:
                for i in range(Xg.shape[0]):
                    me = min(me, _certified_block_min_eval(Xg[i], est=me))
            min_eval = min(min_eval, me)
        if cones.has_lp:
            min_eval = min(min_eval, float(jnp.min(x_lp)))
        p_inf_norm = float(jnp.linalg.norm(ax - ipm.b))
        return _errors_from_parts(ipm, p_obj, d_obj, compl, min_eval, p_inf_norm)

    import time as _time

    times = getattr(ipm, "_check_times", None)
    if times is None:
        times = ipm._check_times = {}
    t0 = _time.time()
    out = _consistent_maker_solve(ipm, maker)
    times["maker_solve"] = times.get("maker_solve", 0.0) + _time.time() - t0
    if out is None:
        return None
    Us, sbar_lp, dy = out
    t0 = _time.time()
    p_obj, d_obj, compl, min_evals, lp_min, p_inf_norm, X_list = _dimacs_eval(
        cones.groups,
        cones.lp,
        ipm.b,
        jnp.asarray(ipm.y, ipm.dtype),
        jnp.asarray(ipm.Rd, ipm.dtype),
        jnp.asarray(ipm.perturb, ipm.dtype),
        jnp.asarray(maker.mu, ipm.dtype),
        dy,
        Us,
        sbar_lp,
        ipm.m,
    )
    # force the eval's device work before timing the certificate
    p_inf_norm = float(np.asarray(p_inf_norm))
    times["eval"] = times.get("eval", 0.0) + _time.time() - t0
    t0 = _time.time()
    # blocks large enough to have used the Lanczos ESTIMATE get the
    # try-Cholesky certificate (the estimate can only under-report a
    # violation; the certificate can only over-report — VERDICT r4 #7)
    min_eval = np.inf
    for Xg, me in zip(X_list, min_evals):
        if Xg.shape[-1] >= _LANCZOS_EIG_DIM and Xg.dtype == jnp.float64:
            for i in range(Xg.shape[0]):
                min_eval = min(
                    min_eval,
                    _certified_block_min_eval(Xg[i], est=float(me)),
                )
        else:
            min_eval = min(min_eval, float(me))
    if cones.has_lp:
        min_eval = min(min_eval, float(lp_min))
    times["certify"] = times.get("certify", 0.0) + _time.time() - t0
    return _errors_from_parts(
        ipm,
        float(np.asarray(p_obj)),
        float(np.asarray(d_obj)),
        float(np.asarray(compl)),
        min_eval,
        p_inf_norm,
    )
