"""Whole-phase fused IPM: each phase compiles to ONE XLA program.

The host-driven loop in hdsdp_tpu.solver.algo issues ~60 synchronizing
dispatches per IPM iteration (factor checks, ratio tests, line searches),
each a host round trip.  Every shape in the solver is static, so this
design compiles the ENTIRE phase as a jitted ``lax.while_loop``: outer loop over
IPM iterations, inner ``lax.while_loop``s for the data-dependent line
searches, ``lax.cond`` for the fallback ladders.  A full mcp100 solve then
takes a handful of dispatches instead of thousands.

Numerical semantics mirror hdsdp_tpu.solver.algo line by line (which in
turn mirrors ref interface/hdsdp_algo.c); algo.py remains the readable
reference implementation and the two are cross-validated in
tests/test_fused.py.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hdsdp_tpu.ops import chol as chol_ops
from hdsdp_tpu.ops import ratio as ratio_ops
from hdsdp_tpu.ops import schur as schur_ops

INF = 1e30

# integer status codes (host maps them to the string statuses of algo.py)
RUNNING = 0
DUAL_FEASIBLE = 1
SUSPECT = 2
MAXITER = 3
NUMERICAL = 4
OPTIMAL = 5
INFEAS = 6
PSDP_HANDOFF = 7
DUAL_OPTIMAL = 8


class Maker(NamedTuple):
    mu: jnp.ndarray
    y: jnp.ndarray
    dy: jnp.ndarray


class Cones(NamedTuple):
    """Static cone data closed over by the fused programs."""

    groups: Tuple[schur_ops.GroupArrays, ...]
    lp: Optional[schur_ops.LPArrays]
    b: jnp.ndarray
    bound_lo: jnp.ndarray
    bound_up: jnp.ndarray


class Pars(NamedTuple):
    """Runtime scalars derived from Params + features (device-resident)."""

    feas_tol: jnp.ndarray
    trx_estimate: jnp.ndarray
    all_cone_dims: jnp.ndarray
    pot_rho: jnp.ndarray
    rel_opt_tol: jnp.ndarray
    abs_opt_tol_scaled: jnp.ndarray  # abs_opt_tol / (obj_scal*rhs_scal)
    pd_scal: jnp.ndarray  # 1 / (rhs_scal * obj_scal)
    rhs_fro_norm: jnp.ndarray
    rhs_one_norm: jnp.ndarray


class State(NamedTuple):
    y: jnp.ndarray
    Rd: jnp.ndarray
    mu: jnp.ndarray
    perturb: jnp.ndarray
    tau: jnp.ndarray  # HSD homogenizing variable (1.0 in phases A/B)
    obj_improve: jnp.ndarray  # HSD dual-objective improvement tracker
    S: Tuple[jnp.ndarray, ...]
    s_lp: Optional[jnp.ndarray]
    L: Tuple[jnp.ndarray, ...]
    sl: jnp.ndarray
    su: jnp.ndarray
    # checker buffers
    Schk: Tuple[jnp.ndarray, ...]
    s_lp_chk: Optional[jnp.ndarray]
    Lchk: Tuple[jnp.ndarray, ...]
    sl_chk: jnp.ndarray
    su_chk: jnp.ndarray
    # scalars
    prox_norm: jnp.ndarray
    p_obj_internal: jnp.ndarray
    d_obj_internal: jnp.ndarray
    p_infeas: jnp.ndarray
    d_step: jnp.ndarray
    n_small_step: jnp.ndarray
    n_iter: jnp.ndarray
    status: jnp.ndarray
    p_obj_found: jnp.ndarray
    maker_acc: Maker
    maker_inacc: Maker
    # per-iteration log rows [max_iter, 6]:
    # (pObj, dObj, inf, mu, step, extra) in internal units
    log: jnp.ndarray
    # per-group Lanczos warm-start vectors (f32, shape = batch + (n,));
    # threaded through every cone_ratio call like the reference's
    # persistent vVec (ref hdsdp_lanczos.c:166-178, 249)
    lz: Tuple[jnp.ndarray, ...]


# ----------------------------------------------------------------------
# cone primitives (pure; mirror ConeSystem methods)
# ----------------------------------------------------------------------


def assemble(c: Cones, dC, scal, y, dEye):
    S = tuple(
        schur_ops.group_dual(ga, dC, scal, y, dEye) for ga in c.groups
    )
    s_lp = schur_ops.lp_dual(c.lp, dC, scal, y, dEye) if c.lp is not None else None
    return S, s_lp


def factor(c: Cones, S, s_lp):
    Ls = []
    ok = jnp.asarray(True)
    for Sg in S:
        good, L = chol_ops.psd_check(Sg)
        Ls.append(L)
        ok = jnp.logical_and(ok, good)
    if c.lp is not None:
        ok = jnp.logical_and(ok, jnp.all(s_lp > 0))
    return ok, tuple(Ls)


def logdet(c: Cones, L, s_lp):
    val = jnp.zeros((), L[0].dtype)
    for Lg in L:
        val = val + chol_ops.chol_logdet(Lg)
    if c.lp is not None:
        val = val + jnp.sum(jnp.log(s_lp))
    return val


# trace-time ratio-test configuration: set by solve_fused before the
# fused programs are built (included in the program cache key).
# "kwarm" > 0 enables warm-started Lanczos at that reduced fixed depth;
# 0 keeps the cold deterministic start at full "krylov" depth.
_RATIO_CFG = {"mode": "auto", "krylov": 30, "kwarm": 16}


def cone_ratio(c: Cones, L, s_lp, dS, ds_lp, lz):
    """Ratio test over all cone groups, threading per-group Lanczos
    warm-start vectors (State.lz) like the reference's persistent vVec
    (ref hdsdp_lanczos.c:166-178 dLanczosWarmStart): each Lanczos group
    starts from the previous call's top Ritz image (plus the anti-
    stagnation perturbation applied inside block_ratio) and runs a
    reduced fixed depth.  The residual safeguard keeps the step bound
    conservative when the reduced space has not converged, and every
    accepted step is re-verified by an f64 interior check downstream.
    Returns (step, new_lz)."""
    kwarm = _RATIO_CFG["kwarm"]
    step = jnp.asarray(INF)
    new_lz = []
    for gi, (Lg, dSg) in enumerate(zip(L, dS)):
        if kwarm > 0:
            steps, w = ratio_ops.block_ratio(
                Lg, dSg, mode=_RATIO_CFG["mode"], krylov=kwarm,
                v0=lz[gi], return_warm=True, adaptive=False,
            )
            new_lz.append(lz[gi] if w is None else w.astype(lz[gi].dtype))
        else:
            steps = ratio_ops.block_ratio(
                Lg, dSg, mode=_RATIO_CFG["mode"], krylov=_RATIO_CFG["krylov"]
            )
            new_lz.append(lz[gi])
        step = jnp.minimum(step, jnp.min(steps))
    if c.lp is not None:
        step = jnp.minimum(step, ratio_ops.vector_ratio_test(s_lp, ds_lp))
    return step, tuple(new_lz)


def build_kkt(c: Cones, L, s_lp, Rd, kind: str):
    """Mirror of cones._build_kkt (kind in {"inf", "hsd", "corr"})."""
    m = c.b.shape[0]
    dtype = c.b.dtype
    with_m = kind != "corr"
    M = jnp.zeros((m, m), dtype) if with_m else None
    asinv = jnp.zeros((m,), dtype)
    trsas = jnp.zeros((m,), dtype)
    tr_u = jnp.zeros((), dtype)
    asinvcsinv = jnp.zeros((m,), dtype) if kind == "hsd" else None
    csinv = jnp.zeros((), dtype)
    csinvcsinv = jnp.zeros((), dtype)
    csinvrdsinv = jnp.zeros((), dtype)

    for ga, Lg in zip(c.groups, L):
        U = chol_ops.chol_inverse(Lg)
        out = schur_ops.group_schur(ga, U, m, with_m=with_m)
        if with_m:
            M = M + out.M
        asinv = asinv + out.asinv
        trsas = trsas + out.trSAS
        tr_u = tr_u + out.trU
        if kind == "hsd":
            h = schur_ops.group_hsd(ga, U, m)
            asinvcsinv = asinvcsinv + h.asinvcsinv
            csinv = csinv + h.csinv
            csinvcsinv = csinvcsinv + h.csinvcsinv
            csinvrdsinv = csinvrdsinv + Rd * h.trUCU

    if c.lp is not None:
        out = schur_ops.lp_schur(c.lp, s_lp, m, with_m=with_m)
        if with_m:
            M = M + out.M
        asinv = asinv + out.asinv
        trsas = trsas + out.trSAS
        tr_u = tr_u + out.trU
        if kind == "hsd":
            h = schur_ops.lp_hsd(c.lp, s_lp, m)
            asinvcsinv = asinvcsinv + h.asinvcsinv
            csinv = csinv + h.csinv
            csinvcsinv = csinvcsinv + h.csinvcsinv

    return M, asinv, Rd * trsas, asinvcsinv, csinv, csinvcsinv, csinvrdsinv, tr_u


def factor_m(M):
    """Cholesky with in-graph regularization ladder (algo.factor_kkt)."""
    L = jnp.linalg.cholesky(M)
    ok = chol_ops.chol_ok(L)

    def retry(_):
        base = jnp.max(jnp.diag(M)) * 1e-14 + 1e-300

        def try_reg(k, carry):
            Lc, okc = carry
            reg = base * (10.0 ** (2 * k))
            Lr = jnp.linalg.cholesky(M + reg * jnp.eye(M.shape[0], dtype=M.dtype))
            okr = chol_ops.chol_ok(Lr)
            take = jnp.logical_and(jnp.logical_not(okc), okr)
            Lc = jnp.where(take, Lr, Lc)
            return Lc, jnp.logical_or(okc, okr)

        return jax.lax.fori_loop(0, 6, try_reg, (L, jnp.asarray(False)))

    L, ok = jax.lax.cond(ok, lambda _: (L, ok), retry, None)
    return L, ok




# ----------------------------------------------------------------------
# shared sub-steps
# ----------------------------------------------------------------------


def bound_slacks(c: Cones, tau, y):
    return y - tau * c.bound_lo, tau * c.bound_up - y


def bound_ratio(sl, su, dsl, dsu):
    s = jnp.concatenate([sl, su])
    ds = jnp.concatenate([dsl, dsu])
    return ratio_ops.vector_ratio_test(s, ds)


def check_interior(c: Cones, st: State, tau, y, with_bound=True):
    """algo.check_is_interior: assemble at (tau, y), factor, update DUALVAR."""
    S, s_lp = assemble(c, tau, -1.0, y, -st.Rd + st.perturb)
    ok, L = factor(c, S, s_lp)
    S_new = tuple(jnp.where(ok, a, b) for a, b in zip(S, st.S))
    L_new = tuple(jnp.where(ok, a, b) for a, b in zip(L, st.L))
    s_new = jnp.where(ok, s_lp, st.s_lp) if c.lp is not None else None
    st = st._replace(S=S_new, L=L_new, s_lp=s_new)
    interior = ok
    if with_bound:
        sl, su = bound_slacks(c, tau, y)
        bok = jnp.logical_and(jnp.all(sl > 0), jnp.all(su > 0))
        st = st._replace(
            sl=jnp.where(bok, sl, st.sl), su=jnp.where(bok, su, st.su)
        )
        interior = jnp.logical_and(interior, bok)
    return interior, st


def set_step(c: Cones, st: State, dtau, dy, gamma):
    dS, ds_lp = assemble(c, dtau, -1.0, dy, gamma * st.Rd)
    dsu = dtau * c.bound_up - dy
    dsl = dy - dtau * c.bound_lo
    return dS, ds_lp, dsl, dsu


def add_step_to_checker(c: Cones, st: State, dS, ds_lp, dsl, dsu, alpha):
    """algo.add_step_to_checker (checker := dualvar + alpha*step, PSD check)."""
    S_new = tuple(Sg + alpha * dSg for Sg, dSg in zip(st.S, dS))
    s_new = st.s_lp + alpha * ds_lp if c.lp is not None else None
    ok, Lnew = factor(c, S_new, s_new)
    st = st._replace(Schk=S_new, s_lp_chk=s_new, Lchk=Lnew)
    sl = st.sl + alpha * dsl
    su = st.su + alpha * dsu
    st = st._replace(sl_chk=sl, su_chk=su)
    interior = jnp.logical_and(
        ok, jnp.logical_and(jnp.all(sl > 0), jnp.all(su > 0))
    )
    return interior, st


def logdet_cur(c: Cones, st: State):
    """algo.logdet_cur (negated barrier at DUALVAR)."""
    val = logdet(c, st.L, st.s_lp)
    val = val + jnp.sum(jnp.log(st.sl)) + jnp.sum(jnp.log(st.su))
    return -val


def prox_measure(c: Cones, p: Pars, st: State, kkt, d1, d2, which_infeas: bool):
    """algo.prox_measure — returns (p_obj_type in {-1,0,1}, st).

    Structure note: the ``lax.cond`` below ONLY computes fresh buffers and
    returns them; all read-modify-write merges of State scalars happen
    outside the cond.  Conditional self-referential updates inside cond
    branches (``_replace(f=where(flag, new, st.f))``) have crashed an
    XLA backend's HloReplicationAnalysis.
    """
    (M, asinv, asinvrdsinv, _, _, _, _, trace_sinv) = kkt
    mu = st.mu
    dy1 = d1 / mu - d2
    v2 = c.b / mu - asinv
    prox2 = dy1 @ v2
    pos = prox2 >= 0.0

    prox_norm = jnp.where(pos, jnp.sqrt(jnp.maximum(prox2, 0.0)), 1.0)
    vec = dy1 - st.y
    su_b = c.bound_up + vec
    sl_b = -c.bound_lo - vec
    bound_ok = jnp.logical_and(jnp.all(sl_b > 0), jnp.all(su_b > 0))

    # expert check (checker := -Rd*I + A'vec + C), run only when needed
    def expert(_):
        S, s_lp = assemble(c, 1.0, 1.0, vec, -st.Rd + st.perturb)
        okc, Lc = factor(c, S, s_lp)
        return okc, S, s_lp, Lc

    def skip(_):
        return jnp.asarray(False), st.Schk, st.s_lp_chk, st.Lchk

    okc, Schk, s_lp_chk, Lchk = jax.lax.cond(
        jnp.logical_and(pos, bound_ok), expert, skip, None
    )
    feas = jnp.logical_and(pos, jnp.logical_and(bound_ok, okc))

    if which_infeas:
        rel_gap = dy1 @ (asinvrdsinv + asinv) + trace_sinv * st.Rd
    else:
        rel_gap = dy1 @ asinv
    rel_gap = rel_gap + p.all_cone_dims
    p_obj_new = st.d_obj_internal + rel_gap * mu

    # primal infeasibility estimate via the bound cone
    d = -dy1
    slc = st.y - c.bound_lo
    suc = c.bound_up - st.y
    xl = mu * (1.0 / slc - d / (slc * slc))
    xu = mu * (1.0 / suc + d / (suc * suc))
    p_inf = jnp.max(jnp.abs(xu - xl))
    p_inf = jnp.where(p_inf < 1e-16, 0.0, p_inf)

    inacc_tol = jnp.asarray(1e-04)
    acc = p.rel_opt_tol  # prec_ord_acc == rel_opt_tol per params
    thresh = jnp.abs(st.d_obj_internal) + 1.0
    take_inacc = jnp.logical_and(
        feas, jnp.logical_and(p_inf < 1.0, rel_gap * mu > inacc_tol * thresh)
    )
    take_acc = jnp.logical_and(
        feas,
        jnp.logical_and(
            p_inf < 1.0,
            jnp.logical_and(
                rel_gap * mu <= inacc_tol * thresh, rel_gap * mu > acc * thresh
            ),
        ),
    )
    new_maker = Maker(mu=mu, y=st.y, dy=dy1)
    maker_inacc = jax.tree.map(
        lambda a, b: jnp.where(take_inacc, a, b), new_maker, st.maker_inacc
    )
    maker_acc = jax.tree.map(
        lambda a, b: jnp.where(take_acc, a, b), new_maker, st.maker_acc
    )

    p_obj_type = jnp.where(
        feas,
        jnp.where(rel_gap < 0, jnp.where(rel_gap < -1.0, -1, 0), 1),
        0,
    )
    good = jnp.logical_and(feas, rel_gap >= 0)
    st = st._replace(
        prox_norm=prox_norm,
        sl_chk=jnp.where(pos, sl_b, st.sl_chk),
        su_chk=jnp.where(pos, su_b, st.su_chk),
        Schk=Schk,
        s_lp_chk=s_lp_chk,
        Lchk=Lchk,
        p_obj_internal=jnp.where(good, p_obj_new, st.p_obj_internal),
        p_infeas=jnp.where(good, p_inf, st.p_infeas),
        maker_acc=maker_acc,
        maker_inacc=maker_inacc,
    )
    return p_obj_type, st


# ----------------------------------------------------------------------
# Phase A (fused mirror of algo.phase_a)
# ----------------------------------------------------------------------


def _phase_a_iteration(c: Cones, p: Pars, st: State, corrector_a: int):
    """One Phase-A iteration (ref HDSDP_PhaseA_BarInfeasSolve body)."""

    kkt = build_kkt(c, st.L, st.s_lp, st.Rd, "inf")
    (M, asinv, asinvrdsinv, _, _, _, _, trace_sinv) = kkt
    li = 1.0 / st.sl
    ui = 1.0 / st.su
    asinv_b = asinv + ui - li
    M = M + jnp.diag(li * li + ui * ui)
    kkt = (M, asinv_b, asinvrdsinv) + kkt[3:]

    Lm, ok_m = factor_m(M)
    # failed KKT factorization terminates the phase deterministically
    # (otherwise NaN directions spin the loop to MAXITER)
    st = st._replace(status=jnp.where(ok_m, st.status, NUMERICAL))
    rhs3 = jnp.stack([c.b, asinv_b, asinvrdsinv], axis=1)
    sols = chol_ops.chol_solve(Lm, rhs3)
    d1, d2, d3 = sols[:, 0], sols[:, 1], sols[:, 2]

    p_obj_type, st = prox_measure(c, p, st, kkt, d1, d2, True)
    st = st._replace(
        status=jnp.where(p_obj_type < 0, SUSPECT, st.status),
        p_obj_found=st.p_obj_found + jnp.maximum(p_obj_type, 0),
    )

    mu = st.mu
    mu = jnp.where(
        jnp.logical_and(p_obj_type == 1, st.prox_norm < 2.0), mu * 0.7, mu
    )
    target = (
        st.p_obj_internal - st.d_obj_internal - st.Rd * p.trx_estimate
    ) / (5.0 * p.all_cone_dims)
    mu = jnp.where(
        st.prox_norm < 1.0,
        mu * 0.005,
        jnp.where(
            st.prox_norm < 5.0,
            jnp.maximum(mu * 0.01, target * 0.1),
            jnp.where(
                st.prox_norm < 10.0,
                jnp.maximum(mu * 0.1, target * 0.8),
                jnp.maximum(mu * 0.95, target),
            ),
        ),
    )
    st = st._replace(mu=mu)

    # ---- adaptive residual-reduction rate (algo.adaptive_resi_rate)
    dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, -d2, 0.0)
    step, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
    st = st._replace(lz=lz)
    step = jnp.minimum(step, bound_ratio(st.sl, st.su, dsl, dsu))
    alpha_c0 = jnp.minimum(0.98 * step, 1.0)
    max_step = alpha_c0

    def ls_cond(carry):
        alpha, interior, _ = carry
        return jnp.logical_and(
            jnp.logical_not(interior), alpha > 1e-02 * max_step
        )

    def ls_body(carry):
        alpha, _, stc = carry
        interior, stc = add_step_to_checker(c, stc, dS, ds_lp, dsl, dsu, alpha)
        alpha_next = jnp.where(interior, alpha, alpha * 0.8)
        return alpha_next, interior, stc

    # mirror the do-while: first trial at alpha_c0
    interior0, st = add_step_to_checker(c, st, dS, ds_lp, dsl, dsu, alpha_c0)
    alpha_c, _, st = jax.lax.while_loop(
        ls_cond, ls_body, (jnp.where(interior0, alpha_c0, alpha_c0 * 0.8),
                           interior0, st)
    )

    dS2, ds_lp2, _, _ = set_step(c, st, 0.0, d3, 1.0)
    alpha_inf, lz = cone_ratio(c, st.Lchk, st.s_lp_chk, dS2, ds_lp2, st.lz)
    st = st._replace(lz=lz)

    rate = jnp.where(alpha_c > 0, alpha_inf / alpha_c, 0.0)
    rate = jnp.minimum(0.98 * rate, 1.0)
    rate = jnp.where(
        st.prox_norm < 1.0,
        jnp.maximum(0.9, rate),
        jnp.where(
            st.prox_norm < 10.0,
            jnp.maximum(0.3, rate),
            jnp.where(st.prox_norm < 50.0, jnp.maximum(0.1, rate), rate),
        ),
    )
    gamma = rate

    # ---- step: dy = d1/mu - d2 + gamma*d3
    dy = d1 / st.mu - d2 + gamma * d3
    dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, dy, gamma)
    step, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
    st = st._replace(lz=lz)
    step = jnp.minimum(step, bound_ratio(st.sl, st.su, dsl, dsu))
    d_step = jnp.minimum(0.95 * step, 1.0)
    st = st._replace(
        d_step=d_step,
        n_small_step=st.n_small_step + jnp.where(d_step < 1e-03, 1, 0),
        y=st.y + d_step * dy,
        Rd=st.Rd * (1.0 - gamma * d_step),
    )

    # ---- infeasible corrector (algo.infeasible_corrector)
    st, corr_ok = _infeasible_corrector(c, p, st, Lm, corrector_a)
    # a corrector interior-check failure must not overwrite a SUSPECT (or
    # any other terminal) status: SUSPECT hands off to the HSD phase
    st = st._replace(
        status=jnp.where(
            jnp.logical_or(corr_ok, st.status != RUNNING),
            st.status,
            NUMERICAL,
        )
    )

    # ---- bookkeeping (print_log updates d_obj_internal)
    st = st._replace(d_obj_internal=c.b @ st.y)
    row = jnp.stack([
        st.p_obj_internal, st.d_obj_internal, jnp.abs(st.Rd), st.mu,
        st.d_step, st.prox_norm,
    ])
    st = st._replace(log=st.log.at[st.n_iter].set(row))

    # ---- convergence checks
    st = st._replace(
        status=jnp.where(
            jnp.logical_and(st.status == RUNNING, jnp.abs(st.Rd) < p.feas_tol),
            DUAL_FEASIBLE,
            st.status,
        )
    )
    st = st._replace(
        status=jnp.where(
            jnp.logical_and(st.status == RUNNING, st.n_small_step > 3),
            SUSPECT,
            st.status,
        ),
        n_iter=st.n_iter + 1,
    )
    return st


def _infeasible_corrector(c: Cones, p: Pars, st: State, Lm, n_max_corr: int):
    """algo.infeasible_corrector with the factorized M reused (Lm)."""
    interior, st = check_interior(c, st, 1.0, st.y)

    def run(st):
        barrier0 = logdet_cur(c, st)

        def round_body(k, carry):
            st, ratio_max, barrier, active = carry

            def do_round(args):
                st, ratio_max, barrier = args
                _, asinv, asinvrdsinv, _, _, _, _, _ = build_kkt(
                    c, st.L, st.s_lp, st.Rd, "corr"
                )
                li = 1.0 / st.sl
                ui = 1.0 / st.su
                asinv_b = asinv + ui - li
                sols = chol_ops.chol_solve(Lm, jnp.stack([asinv_b, asinvrdsinv], axis=1))
                d2, d3 = sols[:, 0], sols[:, 1]

                dy = -d2
                dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, dy, 0.0)
                step, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
                st = st._replace(lz=lz)
                step = jnp.minimum(step, bound_ratio(st.sl, st.su, dsl, dsu))
                step = jnp.minimum(0.8 * step, 1.0)

                # guarantee feasibility: halve until interior or tiny
                def g_cond(carry):
                    s, interior, _ = carry
                    return jnp.logical_and(
                        jnp.logical_not(interior), s >= 5e-03
                    )

                def g_body(carry):
                    s, _, stc = carry
                    interior, stc = check_interior(c, stc, 1.0, stc.y + s * dy)
                    s_next = jnp.where(interior, s, s * 0.5)
                    return s_next, interior, stc

                step, interior, st = jax.lax.while_loop(
                    g_cond, g_body, (step, jnp.asarray(False), st)
                )

                def too_small(st):
                    _, st = check_interior(c, st, 1.0, st.y)
                    return st, ratio_max, barrier, jnp.asarray(False)

                def continue_round(st):
                    new_barrier = logdet_cur(c, st)

                    def worse(args):
                        st, s = args
                        s2 = s * 0.5
                        _, st = check_interior(c, st, 1.0, st.y + s2 * dy)
                        return st, s2, jnp.asarray(-INF)

                    st, stepc, barrier_eff = jax.lax.cond(
                        new_barrier > barrier,
                        worse,
                        lambda args: (args[0], args[1], new_barrier),
                        (st, step),
                    )
                    alpha_c = stepc

                    dS3, ds_lp3, dsl3, dsu3 = set_step(c, st, 0.0, d3, 1.0)
                    step2, lz = cone_ratio(c, st.L, st.s_lp, dS3, ds_lp3, st.lz)
                    st = st._replace(lz=lz)
                    step2 = jnp.minimum(
                        step2, bound_ratio(st.sl, st.su, dsl3, dsu3)
                    )
                    rate = jnp.minimum(1.0, ratio_max * (step2 / alpha_c))

                    resi = st.Rd

                    # NaN-safe cap: physically terminates because rate -> 0
                    # recovers the already-verified point y + alpha_c*dy
                    def r_cond(carry):
                        r, interior, _, _, n = carry
                        return jnp.logical_and(
                            jnp.logical_not(interior), n < 300
                        )

                    def r_body(carry):
                        r, _, stc, _, n = carry
                        stc = stc._replace(Rd=resi * (1 - alpha_c * r))
                        cand = stc.y + alpha_c * (r * d3 - d2)
                        interior, stc = check_interior(c, stc, 1.0, cand)
                        r_next = jnp.where(interior, r, r * 0.8)
                        return r_next, interior, stc, cand, n + 1

                    rate, _, st, cand, _ = jax.lax.while_loop(
                        r_cond, r_body,
                        (rate, jnp.asarray(False), st, st.y, jnp.asarray(0)),
                    )

                    ar = alpha_c * rate
                    ratio_new = jnp.where(
                        ar < 5e-04,
                        0.0,
                        jnp.where(ar < 0.1, ratio_max * 0.9, ratio_max),
                    )
                    mu_new = st.mu
                    mu_new = jnp.where(ar > 0.8, mu_new * 0.8, mu_new)
                    ratio_new = jnp.where(
                        ar > 0.8, jnp.minimum(ratio_new * 2.0, 0.9), ratio_new
                    )
                    mu_new = jnp.where(
                        jnp.logical_and(ar <= 0.8, ar > 0.3),
                        mu_new * 0.95, mu_new,
                    )
                    ratio_new = jnp.where(
                        jnp.logical_and(ar <= 0.8, ar > 0.3),
                        jnp.minimum(ratio_new * 2.0, 0.8), ratio_new,
                    )
                    st = st._replace(y=cand, mu=mu_new)
                    keep = ratio_new != 0.0
                    return st, ratio_new, barrier_eff, keep

                return jax.lax.cond(
                    step < 5e-03, too_small, continue_round, st
                )

            do = jnp.logical_and(active, st.Rd != 0.0)
            st, ratio_max, barrier, active = jax.lax.cond(
                do,
                do_round,
                lambda args: (args[0], args[1], args[2], jnp.asarray(False)),
                (st, ratio_max, barrier),
            )
            return st, ratio_max, barrier, active

        st, _, _, _ = jax.lax.fori_loop(
            0, n_max_corr, round_body,
            (st, jnp.asarray(0.8), barrier0, jnp.asarray(True)),
        )
        return st, jnp.asarray(True)

    return jax.lax.cond(
        interior, run, lambda st: (st, jnp.asarray(False)), st
    )


def _phase_a_body(c: Cones, p: Pars, reset_rd, st: State,
                  corrector_a: int, allow_reset: bool):
    """One Phase-A iteration incl. the n_iter==3 reset branch."""

    def do_reset(st: State):
        """algo.reset_start + interior check."""
        st = st._replace(
            y=jnp.zeros_like(st.y),
            p_obj_internal=jnp.asarray(1e+15),
            Rd=reset_rd,
        )
        interior, st = check_interior(c, st, 1.0, st.y)
        st = st._replace(
            status=jnp.where(interior, st.status, NUMERICAL)
        )
        return st

    st = jax.lax.cond(
        jnp.logical_and(
            jnp.asarray(allow_reset),
            jnp.logical_and(st.n_iter == 3, st.p_obj_found == 0),
        ),
        do_reset,
        lambda s: s,
        st,
    )
    st = jax.lax.cond(
        st.status == RUNNING,
        lambda s: _phase_a_iteration(c, p, s, corrector_a),
        lambda s: s,
        st,
    )
    return st


def make_phase_a(corrector_a: int, max_iter: int,
                 allow_reset: bool, whole_phase: bool = True,
                 raw: bool = False):
    """Build the fused Phase-A program.

    The problem data (Cones), tolerances (Pars) and the reset residual are
    runtime ARGUMENTS of the jitted program, not baked-in constants: cached
    programs are keyed by bucketed shapes only, so solving a second problem
    with identical shapes in the same process reuses the compiled code but
    never the first problem's data.

    whole_phase=True wraps the iteration in an in-graph lax.while_loop
    (one dispatch per phase; best for small shapes).  whole_phase=False
    returns the jitted iteration BODY: the host drives the loop with one
    dispatch + one status read-back per iteration — XLA's while-loop
    compile time is pathological at large shapes while the body alone
    compiles fine and runs ~14x faster than the op-by-op host loop.
    """
    if not whole_phase:
        def body(st, c, p, reset_rd):
            return _phase_a_body(c, p, reset_rd, st, corrector_a, allow_reset)

        return jax.jit(body, donate_argnums=(0,))

    def run(st: State, c: Cones, p: Pars, reset_rd):
        def cond(st: State):
            return jnp.logical_and(st.status == RUNNING, st.n_iter < max_iter)

        def body(st: State):
            return _phase_a_body(c, p, reset_rd, st, corrector_a, allow_reset)

        st = jax.lax.while_loop(cond, body, st)
        st = st._replace(
            status=jnp.where(st.status == RUNNING, MAXITER, st.status)
        )
        return st

    if raw:  # un-jitted, for vmap composition (solver.batch)
        return run
    return jax.jit(run, donate_argnums=(0,))


# ----------------------------------------------------------------------
# Phase B (fused mirror of algo.phase_b)
# ----------------------------------------------------------------------


def _choose_barrier(c: Cones, p: Pars, st: State, kkt, d1, d2, p_obj_type):
    """algo.choose_barrier — returns (ok, st)."""
    (_, asinv, *_rest) = kkt
    gap = st.p_obj_internal - st.d_obj_internal
    upper = gap / p.all_cone_dims
    lower = upper / p.pot_rho

    def found_case(st):
        dy1 = -d1 / st.mu
        dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, dy1, 0.0)
        step, lz = cone_ratio(c, st.Lchk, st.s_lp_chk, dS, ds_lp, st.lz)
        st = st._replace(lz=lz)
        step = jnp.minimum(step, bound_ratio(st.sl_chk, st.su_chk, dsl, dsu))
        step = jnp.minimum(step * 0.97, 1e+05)
        return st._replace(mu=st.mu / (1.0 + step)), jnp.asarray(True)

    def notfound_case(st):
        dy2 = -d1 / st.mu + d2
        dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, dy2, 0.0)
        step_c, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
        st = st._replace(lz=lz)
        max_step0 = step_c
        step_b = bound_ratio(st.sl, st.su, dsl, dsu)
        p_step0 = jnp.minimum(max_step0, step_b)
        p_step0 = jnp.where(p_step0 < 1.0, 0.97 * p_step0, p_step0)

        def t_cond(carry):
            ps, n_try, interior, _ = carry
            return jnp.logical_and(
                jnp.logical_not(interior), ps >= 1e-05
            )

        def t_body(carry):
            ps, n_try, _, stc = carry
            interior, stc = add_step_to_checker(
                c, stc, dS, ds_lp, dsl, dsu, ps
            )
            ps_next = jnp.where(
                interior, ps, jnp.where(n_try > 2, ps * 0.97, ps * 0.5)
            )
            return ps_next, n_try + 1, interior, stc

        p_step, _, interior, st = jax.lax.while_loop(
            t_cond, t_body, (p_step0, jnp.asarray(0), jnp.asarray(False), st)
        )
        ok = interior

        dy1 = -p_step * d1 / st.mu
        dS1, ds_lp1, dsl1, dsu1 = set_step(c, st, 0.0, dy1, 0.0)
        step2, lz = cone_ratio(c, st.Lchk, st.s_lp_chk, dS1, ds_lp1, st.lz)
        st = st._replace(lz=lz)
        max_step = jnp.minimum(max_step0, step2)
        step_b2 = bound_ratio(st.sl_chk, st.su_chk, dsl1, dsu1)
        max_step = jnp.minimum(max_step, step_b2)
        max_step = jnp.minimum(max_step * 0.97, 1e+05)
        mu_new = p_step * st.mu / (1.0 + max_step) + (1.0 - p_step) * (
            st.p_obj_internal - st.d_obj_internal
        ) / p.all_cone_dims
        return st._replace(mu=mu_new), ok

    st, ok = jax.lax.cond(p_obj_type > 0, found_case, notfound_case, st)
    st = st._replace(mu=jnp.clip(st.mu, lower, upper))
    return ok, st


def _feasible_build_step(c: Cones, p: Pars, st: State, kkt, d1, d2):
    """algo.feasible_build_step (mu shrink loop)."""
    (_, asinv, *_rest) = kkt

    def cond(carry):
        mu, prox, go, n = carry
        return jnp.logical_and(go, n < 300)  # n caps NaN runaway

    def body(carry):
        mu, _, _, n = carry
        dy = d1 / mu - d2
        v = c.b / mu - asinv
        prox2 = v @ dy
        neg = prox2 < 0.0
        prox = jnp.where(neg, 1e+02, jnp.sqrt(jnp.maximum(prox2, 0.0)))
        done = jnp.logical_or(neg, prox >= 0.1)
        mu_next = jnp.where(done, mu, 0.1 * mu)
        return mu_next, prox, jnp.logical_not(done), n + 1

    mu, prox, _, _ = jax.lax.while_loop(
        cond, body, (st.mu, st.prox_norm, jnp.asarray(True), jnp.asarray(0))
    )
    st = st._replace(mu=mu, prox_norm=prox)
    dy = d1 / mu - d2
    return dy, st


def _primal_infeas_check(c: Cones, p: Pars, st: State, force):
    """algo.primal_infeas_check — dual improving ray detection."""
    trigger = jnp.logical_or(
        st.p_infeas >= p.rhs_fro_norm,
        jnp.logical_or(
            force,
            jnp.logical_and(
                st.p_infeas > 0.01 * p.rhs_one_norm, st.mu < 1e-03
            ),
        ),
    )
    d_obj_val = st.d_obj_internal * p.pd_scal
    norm = jnp.linalg.norm(st.y)
    trigger = jnp.logical_and(
        trigger, jnp.logical_and(d_obj_val >= 0.0, norm > 0.0)
    )

    def check(st):
        yn = st.y / norm
        S, s_lp = assemble(c, 0.0, -1.0, yn, 1e-08 + st.perturb)
        ok, L = factor(c, S, s_lp)
        st = st._replace(Schk=S, s_lp_chk=s_lp, Lchk=L)
        return ok, st

    return jax.lax.cond(
        trigger, check, lambda st: (jnp.asarray(False), st), st
    )


def _reduce_potential(c: Cones, p: Pars, st: State, dy):
    """algo.reduce_potential — returns (ok, st)."""
    rho = (st.p_obj_internal - st.d_obj_internal) * p.pd_scal / st.mu
    # NB: algo uses (p_obj_val - d_obj_val)/mu with vals = internal*pd_scal
    min_step_tol = jnp.where(st.n_small_step >= 2, 0.5, 0.0)
    required_dec = jnp.where(st.prox_norm < 0.5, 0.05, 0.0)

    dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, dy, 0.0)
    step, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
    st = st._replace(lz=lz)
    step = jnp.minimum(step, bound_ratio(st.sl, st.su, dsl, dsu))
    dual_step0 = jnp.minimum(step * 0.95, 1.0)

    pot_now = logdet_cur(c, st) + rho * jnp.log(
        st.p_obj_internal - st.d_obj_internal
    )
    # NB: potential uses the scaled b'y via d_obj_internal (see note below)

    def cond(carry):
        s, done, fail, stc, n = carry
        return jnp.logical_and(
            jnp.logical_not(jnp.logical_or(done, fail)), n < 300
        )

    def body(carry):
        s, _, _, stc, n = carry
        cand = stc.y + s * dy
        interior, stc2 = check_interior(c, stc, 1.0, cand)

        def not_int(args):
            s, stc = args
            return s * 0.33, jnp.asarray(False), jnp.asarray(False), stc

        def is_int(args):
            s, stc = args
            pot_new = logdet_cur(c, stc) + rho * jnp.log(
                stc.p_obj_internal - c.b @ cand
            )
            accept = jnp.logical_or(
                pot_new <= pot_now - required_dec,
                jnp.logical_or(
                    s * stc.prox_norm <= 0.001, s < min_step_tol
                ),
            )

            def acc_fn(stc):
                return s, jnp.asarray(True), jnp.asarray(False), stc._replace(y=cand)

            def rej_fn(stc):
                def tiny(stc):
                    interior2, stc = check_interior(c, stc, 1.0, stc.y)
                    return s, interior2, jnp.logical_not(interior2), stc

                def shrink(stc):
                    return s * 0.3, jnp.asarray(False), jnp.asarray(False), stc

                return jax.lax.cond(s < 1e-04, tiny, shrink, stc)

            return jax.lax.cond(accept, acc_fn, rej_fn, stc)

        s2, done, fail, stc3 = jax.lax.cond(interior, is_int, not_int, (s, stc2))
        return s2, done, fail, stc3, n + 1

    dual_step, done, fail, st, _ = jax.lax.while_loop(
        cond, body,
        (dual_step0, jnp.asarray(False), jnp.asarray(False), st, jnp.asarray(0)),
    )
    st = st._replace(d_step=dual_step)
    return jnp.logical_not(fail), st


def _feasible_corrector(c: Cones, p: Pars, st: State, Lm, d1, n_max_corr: int,
                        corr_disable):
    """algo.feasible_corrector.  Returns (st, disable_flag)."""
    shrink = p.all_cone_dims / (p.all_cone_dims + jnp.sqrt(p.all_cone_dims))
    b_dot_d1 = c.b @ d1

    disable = jnp.any(
        jnp.stack([
            jnp.logical_and(st.d_step < 0.1, st.mu < 1e-05),
            st.d_step < 1e-03,
            st.mu < 1e-06,
        ])
    )
    n_eff_zero = jnp.logical_or(
        jnp.logical_or(st.prox_norm < 0.1, st.d_step < 1e-02),
        jnp.logical_or(disable, corr_disable),
    )

    def round_body(k, carry):
        st, b_dot_corr, active = carry

        def do_round(args):
            st, b_dot_corr = args
            _, asinv, _, _, _, _, _, _ = build_kkt(
                c, st.L, st.s_lp, st.Rd, "corr"
            )
            li = 1.0 / st.sl
            ui = 1.0 / st.su
            asinv_b = asinv + ui - li
            d2 = chol_ops.chol_solve(Lm, asinv_b)
            b_dot_d2 = c.b @ d2
            mu_new = jnp.where(
                jnp.logical_and(b_dot_d2 > 0, b_dot_d1 > 0),
                b_dot_d1 / b_dot_d2,
                st.mu,
            ) * shrink
            st = st._replace(mu=mu_new)

            dy = d1 / st.mu - d2
            b_dot_corr = b_dot_corr + c.b @ dy

            # barrier function -(b'y + mu*logdet)
            barrier_now = -(c.b @ st.y + st.mu * (-logdet_cur(c, st)))
            dS, ds_lp, dsl, dsu = set_step(c, st, 0.0, dy, 0.0)
            step, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
            st = st._replace(lz=lz)
            step = jnp.minimum(step, bound_ratio(st.sl, st.su, dsl, dsu))
            step = step * 0.95
            step = jnp.minimum(
                step, p.pot_rho / jnp.maximum(st.prox_norm, 1e-300)
            )

            def w_cond(carry):
                s, done, stc, n = carry
                return jnp.logical_and(jnp.logical_not(done), n < 300)

            def w_body(carry):
                s, _, stc, n = carry
                cand = stc.y + s * dy
                interior, stc2 = check_interior(c, stc, 1.0, cand)

                def not_int(args):
                    s, stc, _ = args
                    return s * 0.5, jnp.asarray(False), stc

                def is_int(args):
                    s, stc, cand = args
                    barrier_new = -(c.b @ cand + stc.mu * (-logdet_cur(c, stc)))
                    done = jnp.logical_or(
                        s < 1e-04,
                        barrier_new
                        <= barrier_now - jnp.abs(0.05 * b_dot_corr * s),
                    )
                    denom = (
                        2.0
                        * (barrier_new - barrier_now + b_dot_corr * s)
                        / (s * s)
                    )
                    frac = b_dot_corr / jnp.where(denom == 0, 1e-300, denom)
                    use_quad = jnp.logical_and(
                        denom != 0,
                        jnp.logical_and(frac > 0, frac < s),
                    )
                    s_next = jnp.where(
                        done, s, jnp.where(use_quad, frac, s * 0.5)
                    )
                    return s_next, done, stc

                s2, done, stc3 = jax.lax.cond(
                    interior, is_int, not_int, (s, stc2, cand)
                )
                return s2, done, stc3, n + 1

            step, _, st, _ = jax.lax.while_loop(
                w_cond, w_body, (step, jnp.asarray(False), st, jnp.asarray(0))
            )

            def tiny(st):
                _, st = check_interior(c, st, 1.0, st.y)
                return st, jnp.asarray(False)

            def take(st):
                return st._replace(y=st.y + step * dy), jnp.asarray(True)

            st, keep = jax.lax.cond(step < 1e-04, tiny, take, st)
            return st, b_dot_corr, keep

        go = jnp.logical_and(active, st.mu >= 1e-05)
        st, b_dot_corr, active = jax.lax.cond(
            go,
            do_round,
            lambda args: (args[0], args[1], jnp.asarray(False)),
            (st, b_dot_corr),
        )
        return st, b_dot_corr, active

    def run(st):
        st, _, _ = jax.lax.fori_loop(
            0, n_max_corr, round_body, (st, jnp.asarray(0.0), jnp.asarray(True))
        )
        return st

    st = jax.lax.cond(n_eff_zero, lambda s: s, run, st)
    return st, disable


def _phase_b_iteration(c: Cones, p: Pars, st_ex, corrector_b: int,
                       psdp_eligible: bool):
    st, force_detect, n_internal, corr_disable, no_p_obj_found = st_ex
    n_internal = n_internal + 1
    force_detect = jnp.logical_and(force_detect, n_internal <= 10)

    kkt = build_kkt(c, st.L, st.s_lp, st.Rd, "inf")
    (M, asinv, asinvrdsinv, _, _, _, _, trace_sinv) = kkt
    li = 1.0 / st.sl
    ui = 1.0 / st.su
    asinv_b = asinv + ui - li
    M = M + jnp.diag(li * li + ui * ui)
    # regularize if mu > 1 (algo.regularize_kkt(1e-6))
    min_diag = jnp.min(jnp.diag(M))
    reg = jnp.minimum(1e-06 * min_diag, 1e-05)
    reg = jnp.where(jnp.logical_or(reg < 1e-14, st.mu <= 1.0), 0.0, reg)
    M = M + reg * jnp.eye(M.shape[0], dtype=M.dtype)
    kkt = (M, asinv_b, asinvrdsinv) + kkt[3:]

    Lm, ok_m = factor_m(M)
    st = st._replace(status=jnp.where(ok_m, st.status, NUMERICAL))
    sols = chol_ops.chol_solve(Lm, jnp.stack([c.b, asinv_b], axis=1))
    d1, d2 = sols[:, 0], sols[:, 1]

    p_obj_type, st = prox_measure(c, p, st, kkt, d1, d2, False)
    st = st._replace(
        status=jnp.where(p_obj_type < 0, SUSPECT, st.status),
        p_obj_found=st.p_obj_found + jnp.maximum(p_obj_type, 0),
    )
    no_p_obj_found = jnp.where(p_obj_type != 0, 0, no_p_obj_found + 1)

    ok_bar, st = _choose_barrier(c, p, st, kkt, d1, d2, p_obj_type)
    st = st._replace(status=jnp.where(ok_bar, st.status, NUMERICAL))

    dy, st = _feasible_build_step(c, p, st, kkt, d1, d2)

    ray, st = _primal_infeas_check(c, p, st, force_detect)
    st = st._replace(status=jnp.where(ray, INFEAS, st.status))

    def continue_iter(args):
        st, corr_disable = args
        ok_pot, st = _reduce_potential(c, p, st, dy)
        st = st._replace(status=jnp.where(ok_pot, st.status, NUMERICAL))
        st = st._replace(
            n_small_step=st.n_small_step
            + jnp.where(st.d_step < 1e-03, 1, 0)
        )
        st, disable = _feasible_corrector(
            c, p, st, Lm, d1, corrector_b, corr_disable
        )
        corr_disable = jnp.logical_or(corr_disable, disable)
        return st, corr_disable

    st, corr_disable = jax.lax.cond(
        st.status == RUNNING,
        continue_iter,
        lambda args: args,
        (st, corr_disable),
    )

    # log-equivalent bookkeeping
    st = st._replace(d_obj_internal=c.b @ st.y)
    row = jnp.stack([
        st.p_obj_internal, st.d_obj_internal, st.p_infeas, st.mu,
        st.d_step, st.prox_norm,
    ])
    st = st._replace(log=st.log.at[st.n_iter].set(row))
    p_obj_val = st.p_obj_internal * p.pd_scal
    d_obj_val = st.d_obj_internal * p.pd_scal
    comp = p_obj_val - d_obj_val

    converged = jnp.logical_and(
        comp < (jnp.abs(p_obj_val) + jnp.abs(d_obj_val) + 1.0) * p.rel_opt_tol,
        comp < p.abs_opt_tol_scaled,
    )
    st = st._replace(
        status=jnp.where(
            jnp.logical_and(st.status == RUNNING, converged), OPTIMAL,
            st.status,
        )
    )

    if psdp_eligible:
        want_psdp = jnp.logical_and(
            jnp.logical_or(st.d_step == 1.0, st.mu < 1e-05),
            jnp.logical_and(
                st.p_infeas < 1e-06,
                comp < (jnp.abs(p_obj_val) + jnp.abs(d_obj_val) + 1.0) * 0.1,
            ),
        )
        st = st._replace(
            status=jnp.where(
                jnp.logical_and(st.status == RUNNING, want_psdp),
                PSDP_HANDOFF,
                st.status,
            )
        )

    st = st._replace(
        status=jnp.where(
            jnp.logical_and(st.status == RUNNING, st.n_small_step > 3),
            NUMERICAL,
            st.status,
        ),
        n_iter=st.n_iter + 1,
    )
    st = st._replace(
        status=jnp.where(
            jnp.logical_and(st.status == RUNNING, no_p_obj_found >= 10),
            NUMERICAL,
            st.status,
        )
    )
    return st, force_detect, n_internal, corr_disable, no_p_obj_found


def phase_b_init_extras():
    """Initial auxiliary loop state for Phase B (see _phase_b_iteration)."""
    return (
        jnp.asarray(True),  # force_detect
        jnp.asarray(0),  # n_internal
        jnp.asarray(False),  # corrector disabled
        jnp.asarray(0),  # no_p_obj_found
    )


def make_phase_b(corrector_b: int, max_iter: int,
                 psdp_eligible: bool, whole_phase: bool = True,
                 raw: bool = False):
    if not whole_phase:
        def body(st_ex, c, p):
            return _phase_b_iteration(c, p, st_ex, corrector_b, psdp_eligible)

        return jax.jit(body, donate_argnums=(0,))

    def run(st: State, c: Cones, p: Pars):
        def cond(st_ex):
            st = st_ex[0]
            return jnp.logical_and(st.status == RUNNING, st.n_iter < max_iter)

        def body(st_ex):
            return _phase_b_iteration(c, p, st_ex, corrector_b, psdp_eligible)

        st_ex = (st,) + phase_b_init_extras()
        st_ex = jax.lax.while_loop(cond, body, st_ex)
        st = st_ex[0]
        st = st._replace(
            status=jnp.where(st.status == RUNNING, MAXITER, st.status)
        )
        return st

    if raw:  # un-jitted, for vmap composition (solver.batch)
        return run
    return jax.jit(run, donate_argnums=(0,))


# ----------------------------------------------------------------------
# Phase A' — homogeneous self-dual embedding (fused mirror of
# algo.hsd_solve, ref HDSDP_PhaseA_BarHsdSolve hdsdp_algo.c:355-546)
# ----------------------------------------------------------------------


class HsdPars(NamedTuple):
    feas_tol: jnp.ndarray
    abs_opt: jnp.ndarray
    rel_opt: jnp.ndarray
    hsd_gamma: jnp.ndarray
    reset_rd: jnp.ndarray
    pd_base: jnp.ndarray  # 1 / (rhs_scal * obj_scal)


def _hsd_build_step(c: Cones, st: State, kkt, d1, d2, d3, d4):
    """ref HDSDP_HSD_BuildStep (algo.hsd_build_step)."""
    (_, asinv, _, asinvcsinv, csinv, csinvcsinv, csinvrdsinv, _) = kkt
    mu, tau = st.mu, st.tau
    bty = c.b @ st.y
    obj_improve = bty - st.d_obj_internal

    dd1 = c.b - mu * asinvcsinv
    num = -bty + mu / tau + mu * (csinv - csinvrdsinv)
    den = mu * csinvcsinv + mu / (tau * tau)
    num = num - dd1 @ (d1 * (tau / mu) - d2 + d3)
    den = den + dd1 @ (d1 / mu + d4)

    dtau = jnp.where(jnp.abs(den) < 1e-12, 0.0, num / den)
    dy = d1 * (tau + dtau) / mu + d4 * dtau - d2 + d3
    return dtau, dy, bty, obj_improve


def _hsd_iteration(c: Cones, hp: HsdPars, st: State):
    kkt = build_kkt(c, st.L, st.s_lp, st.Rd, "hsd")
    (M, asinv, asinvrdsinv, asinvcsinv, *_rest) = kkt
    Lm, ok_m = factor_m(M)
    st = st._replace(status=jnp.where(ok_m, st.status, NUMERICAL))
    rhs4 = jnp.stack([c.b, asinv, asinvrdsinv, asinvcsinv], axis=1)
    sols = chol_ops.chol_solve(Lm, rhs4)
    d1, d2, d3, d4 = sols[:, 0], sols[:, 1], sols[:, 2], sols[:, 3]

    dtau, dy, bty, obj_improve = _hsd_build_step(c, st, kkt, d1, d2, d3, d4)
    st = st._replace(d_obj_internal=bty, obj_improve=obj_improve)

    # ratio test incl tau (ref HDSDP_HSD_RatioTest, :316-353)
    t = st.tau / dtau
    max_step = jnp.where(
        jnp.logical_and(dtau != 0.0, t < 0.0), -t, jnp.asarray(INF)
    )
    dS, ds_lp = assemble(c, dtau, -1.0, dy, 1.0 * st.Rd)
    step_c, lz = cone_ratio(c, st.L, st.s_lp, dS, ds_lp, st.lz)
    st = st._replace(lz=lz)
    max_step = jnp.minimum(max_step, step_c)
    st = st._replace(
        n_small_step=st.n_small_step + jnp.where(max_step < 1e-02, 1, 0)
    )

    # step-size ladder (ref :463-471)
    step = jnp.where(
        max_step > 1.0,
        0.7 * max_step,
        jnp.where(
            max_step > 0.5,
            0.5 * max_step,
            jnp.where(max_step > 0.2, 0.3 * max_step, 0.2 * max_step),
        ),
    )
    step = jnp.minimum(step, 1.0)

    # d_obj_val at the pre-step iterate / tau (print_log semantics)
    d_obj_val = bty * hp.pd_base / st.tau

    st = st._replace(
        d_step=step,
        tau=st.tau + step * dtau,
        y=st.y + step * dy,
        Rd=st.Rd * (1.0 - step),
    )

    # barrier reduction (ref :484-499)
    mu = st.mu
    t_new = jnp.where(
        jnp.logical_and(step > 0.8, st.tau > 1.0),
        jnp.maximum(0.1 * mu, -0.1 * st.Rd / st.tau),
        jnp.maximum(hp.hsd_gamma * mu, -0.1 * st.Rd / st.tau),
    )
    mu = jnp.where(mu > 1e-12, jnp.minimum(mu, t_new), jnp.minimum(mu, 0.8 * mu))
    st = st._replace(mu=mu)

    converged = jnp.logical_and(
        jnp.abs(st.Rd) < hp.feas_tol * st.tau,
        jnp.logical_and(
            st.mu < hp.abs_opt,
            jnp.logical_and(
                st.mu < hp.rel_opt * (1 + 2.0 * jnp.abs(d_obj_val)),
                jnp.abs(st.obj_improve)
                < 1e-05 * (jnp.abs(st.d_obj_internal) + 1.0),
            ),
        ),
    )
    st = st._replace(
        status=jnp.where(
            jnp.logical_and(st.status == RUNNING, converged),
            DUAL_FEASIBLE,  # host maps to DUAL_OPTIMAL when d_only
            st.status,
        )
    )
    row = jnp.stack([
        jnp.asarray(1e+30), st.d_obj_internal, jnp.abs(st.Rd), st.mu,
        st.d_step, st.tau,
    ])
    st = st._replace(log=st.log.at[st.n_iter].set(row))
    st = st._replace(
        status=jnp.where(
            jnp.logical_and(st.status == RUNNING, st.tau <= 1e-10),
            SUSPECT,
            st.status,
        ),
        n_iter=st.n_iter + 1,
    )
    return st


def _hsd_body(c: Cones, hp: HsdPars, st: State):
    interior, st = check_interior(c, st, st.tau, st.y, with_bound=False)

    def first_reset(st):
        # ref :641-647: inflate residual, reset, retry next iteration
        st = st._replace(
            y=jnp.zeros_like(st.y),
            tau=jnp.asarray(1.0),
            p_obj_internal=jnp.asarray(1e+15),
            Rd=hp.reset_rd,
            n_iter=st.n_iter + 1,
        )
        return st

    def not_interior(st):
        return jax.lax.cond(
            st.n_iter == 0,
            first_reset,
            lambda s: s._replace(status=jnp.asarray(NUMERICAL, jnp.int32)),
            st,
        )

    return jax.lax.cond(
        interior,
        lambda s: _hsd_iteration(c, hp, s),
        not_interior,
        st,
    )


def make_hsd(max_iter: int, whole_phase: bool = True):
    if not whole_phase:
        def body(st, c, hp):
            return _hsd_body(c, hp, st)

        return jax.jit(body, donate_argnums=(0,))

    def run(st: State, c: Cones, hp: HsdPars):
        def cond(st: State):
            return jnp.logical_and(st.status == RUNNING, st.n_iter < max_iter)

        st = jax.lax.while_loop(cond, lambda s: _hsd_body(c, hp, s), st)
        st = st._replace(
            status=jnp.where(st.status == RUNNING, MAXITER, st.status)
        )
        return st

    return jax.jit(run, donate_argnums=(0,))


# ----------------------------------------------------------------------
# host driver integration
# ----------------------------------------------------------------------


def _cones_from_ipm(ipm) -> Cones:
    return Cones(
        groups=ipm.cones.groups,
        lp=ipm.cones.lp,
        b=ipm.b,
        bound_lo=jnp.asarray(ipm.bound_lo, ipm.dtype),
        bound_up=jnp.asarray(ipm.bound_up, ipm.dtype),
    )


def _pars_from_ipm(ipm, phase: str) -> Pars:
    p = ipm.params
    f = ipm.f
    n_sum = max(f.n_sum_cone_dims, 1)
    if phase == "a":
        feas_tol = max(p.abs_feas_tol, p.rel_feas_tol * (1 + f.obj_one_norm))
    else:
        feas_tol = min(p.abs_feas_tol, p.rel_feas_tol * (1 + f.obj_one_norm))
    feas_tol = feas_tol * ipm.obj_scal / np.sqrt(n_sum)
    pd_scal_mul = ipm.obj_scal * ipm.rhs_scal
    d = ipm.dtype
    return Pars(
        feas_tol=jnp.asarray(feas_tol, d),
        trx_estimate=jnp.asarray(p.trx_estimate, d),
        all_cone_dims=jnp.asarray(ipm.all_cone_dims, d),
        pot_rho=jnp.asarray(p.pot_rho, d),
        rel_opt_tol=jnp.asarray(p.rel_opt_tol, d),
        abs_opt_tol_scaled=jnp.asarray(p.abs_opt_tol / pd_scal_mul, d),
        pd_scal=jnp.asarray(1.0 / pd_scal_mul, d),
        rhs_fro_norm=jnp.asarray(f.rhs_fro_norm, d),
        rhs_one_norm=jnp.asarray(f.rhs_one_norm, d),
    )


def _state_from_ipm(ipm) -> State:
    d = ipm.dtype
    m = ipm.m
    np_d = np.dtype(d.dtype if hasattr(d, "dtype") else d)

    def zero_m():
        # fresh array per field: the State is DONATED to the fused
        # programs, and aliasing one host buffer into several donated
        # leaves would defeat (or warn out of) the aliasing analysis
        return np.zeros((m,), np_d)

    def scal(v):
        # host scalar: the jit call batches all transfers in one dispatch
        # (an eager jnp.asarray is one op dispatch EACH, ~20 of them per
        # phase launch)
        return np.asarray(v, np_d)

    Schk = tuple(np.zeros(Sg.shape, np_d) for Sg in ipm.S)
    def maker0():
        return Maker(mu=scal(-1.0), y=zero_m(), dy=zero_m())

    # Lanczos warm vectors persist across phase launches via the ipm
    # (ref: the per-cone lanczos struct outlives the phase loops)
    lz_shapes = tuple(Sg.shape[:-1] for Sg in ipm.S)
    lz0 = getattr(ipm, "_lz_fused", None)
    if lz0 is None or tuple(np.shape(w) for w in lz0) != lz_shapes:
        lz0 = tuple(
            np.broadcast_to(
                1.0 + 1e-03 * np.arange(Sg.shape[-1], dtype=np.float32),
                Sg.shape[:-1],
            ).copy()
            for Sg in ipm.S
        )

    def maker_of(mk):
        if mk.mu is None or mk.mu <= 0 or mk.y is None:
            return maker0()
        return Maker(mu=scal(mk.mu), y=np.asarray(mk.y, np_d),
                     dy=np.asarray(mk.dy, np_d))

    return State(
        y=ipm.y if hasattr(ipm.y, "devices") else np.asarray(ipm.y, np_d),
        Rd=scal(ipm.Rd),
        mu=scal(ipm.mu),
        perturb=scal(ipm.perturb),
        tau=scal(ipm.tau),
        obj_improve=scal(ipm.obj_improve),
        S=tuple(ipm.S),
        s_lp=ipm.s_lp,
        L=tuple(ipm.L),
        sl=ipm.sl if hasattr(ipm.sl, "devices") else np.asarray(ipm.sl, np_d),
        su=ipm.su if hasattr(ipm.su, "devices") else np.asarray(ipm.su, np_d),
        Schk=Schk,
        s_lp_chk=(
            np.zeros(ipm.s_lp.shape, np_d) if ipm.s_lp is not None else None
        ),
        Lchk=tuple(np.zeros(Lg.shape, np_d) for Lg in ipm.L),
        sl_chk=zero_m(),
        su_chk=zero_m(),
        prox_norm=scal(ipm.prox_norm),
        p_obj_internal=scal(ipm.p_obj_internal),
        d_obj_internal=scal(ipm.d_obj_internal),
        p_infeas=scal(ipm.p_infeas),
        d_step=scal(ipm.d_step),
        n_small_step=np.asarray(ipm.n_small_step, np.int32),
        n_iter=np.asarray(ipm.n_iter, np.int32),
        status=np.asarray(RUNNING, np.int32),
        p_obj_found=np.asarray(0, np.int32),
        maker_acc=maker_of(ipm.maker_acc),
        maker_inacc=maker_of(ipm.maker_inacc),
        log=np.full((ipm.params.max_iter, 6), np.nan, np_d),
        lz=lz0,
    )


def _sync_to_ipm(st: State, ipm):
    from hdsdp_tpu.solver import algo

    ipm.y = st.y
    ipm.Rd = float(st.Rd)
    ipm.mu = float(st.mu)
    ipm.tau = float(st.tau)
    ipm.obj_improve = float(st.obj_improve)
    ipm.S = st.S
    ipm.s_lp = st.s_lp
    ipm.L = st.L
    ipm.sl = st.sl
    ipm.su = st.su
    ipm.Schk, ipm.s_lp_chk, ipm.Lchk = st.Schk, st.s_lp_chk, st.Lchk
    ipm.sl_chk, ipm.su_chk = st.sl_chk, st.su_chk
    ipm.prox_norm = float(st.prox_norm)
    ipm.p_obj_internal = float(st.p_obj_internal)
    ipm.d_obj_internal = float(st.d_obj_internal)
    ipm.p_infeas = float(st.p_infeas)
    ipm.d_step = float(st.d_step)
    ipm.n_small_step = int(st.n_small_step)
    ipm.n_iter = int(st.n_iter)

    pd_scal = 1.0 / (ipm.rhs_scal * ipm.obj_scal)
    ipm.d_obj_val = ipm.d_obj_internal * pd_scal
    ipm.p_obj_val = ipm.p_obj_internal * pd_scal
    ipm.comp = ipm.p_obj_val - ipm.d_obj_val
    n_sum = max(ipm.f.n_sum_cone_dims, 1)
    ipm.d_infeas = np.sqrt(n_sum) * abs(ipm.Rd) / ipm.rhs_scal

    def maker_back(mk):
        if float(mk.mu) <= 0:
            return algo.Maker()
        return algo.Maker(mu=float(mk.mu), y=mk.y, dy=mk.dy)

    ipm.maker_acc = maker_back(st.maker_acc)
    ipm.maker_inacc = maker_back(st.maker_inacc)
    ipm._lz_fused = st.lz


_STATUS_MAP = {
    -2: "TIMELIMIT",
    DUAL_FEASIBLE: "DUAL_FEASIBLE",
    SUSPECT: "SUSPECT_INFEAS_OR_UNBOUNDED",
    MAXITER: "MAXITER",
    NUMERICAL: "NUMERICAL",
    OPTIMAL: "PRIMAL_DUAL_OPTIMAL",
    INFEAS: "INFEAS_OR_UNBOUNDED",
    DUAL_OPTIMAL: "DUAL_OPTIMAL",
}


def _print_fused_log(ipm, st: State, method: str, start_iter: int):
    """Print the per-iteration rows captured inside the fused program."""
    if not ipm.params.verbose:
        return
    import time as _time

    rows = np.asarray(st.log)
    end = min(int(st.n_iter), rows.shape[0])
    pd = 1.0 / (ipm.rhs_scal * ipm.obj_scal)
    nsum = max(ipm.f.n_sum_cone_dims, 1)
    elapsed = _time.time() - ipm.time_begin
    for i in range(start_iter, end):
        pobj, dobj, inf, mu, step, extra = rows[i]
        if not np.isfinite(dobj):
            continue
        if method == "hsd":
            tau = max(extra, 1e-300)
            inf_col = np.sqrt(nsum) * inf / (ipm.rhs_scal * tau)
            ipm.log.iter_row(
                method, i + 1, 1e+30, dobj * pd / tau, inf_col, mu, step,
                extra, elapsed,
            )
        elif method == "potential":
            ipm.log.iter_row(
                method, i + 1, pobj * pd, dobj * pd, inf, mu, step, extra,
                elapsed,
            )
        else:
            inf_col = np.sqrt(nsum) * inf / ipm.rhs_scal
            ipm.log.iter_row(
                method, i + 1, pobj * pd, dobj * pd, inf_col, mu, step,
                extra, elapsed,
            )


def _compile_notice(ipm, phase: str):
    """First dispatch at a new shape JIT-compiles the whole phase body
    (tens of seconds to minutes at large m); say so instead of looking
    hung.  The persistent cache (hdsdp_tpu.utils.cache) makes later runs
    fast."""
    ipm.log.info(
        f"Building fused phase-{phase} program for this shape "
        "(cold XLA compile; can take minutes at large m, cached after)"
    )


def _run_hsd_fused(ipm, c: Cones, d_only: bool, whole: bool = True):
    """Fused counterpart of algo.hsd_solve (ref hdsdp_algo.c:355-546)."""
    from hdsdp_tpu.solver import algo

    p = ipm.params
    f = ipm.f
    ipm.which_method = "hsd"
    if ipm.status == algo.UNKNOWN:
        ipm.set_start("hsd", d_only)
    ipm.log.header("hsd")

    abs_opt = (p.abs_opt_tol if d_only else 1e+20) * 1e-04
    rel_opt = abs_opt * 1e-04  # (ref :401-402 quirk: derived from abs)
    feas_tol = min(p.abs_feas_tol, p.rel_feas_tol * (1.0 + f.obj_one_norm))
    feas_tol = feas_tol * ipm.obj_scal / np.sqrt(max(f.n_sum_cone_dims, 1))
    d = ipm.dtype
    hp = HsdPars(
        feas_tol=jnp.asarray(feas_tol, d),
        abs_opt=jnp.asarray(abs_opt, d),
        rel_opt=jnp.asarray(rel_opt, d),
        hsd_gamma=jnp.asarray(p.hsd_gamma, d),
        reset_rd=jnp.asarray(
            max(-max(f.obj_fro_norm, 1e+02) * 1e+06, -1e+15), d
        ),
        pd_base=jnp.asarray(1.0 / (ipm.rhs_scal * ipm.obj_scal), d),
    )
    key = _cache_key(ipm, "hsd", (p.max_iter, whole))
    if key not in _PROGRAM_CACHE:
        _compile_notice(ipm, "A' (HSD)")
        _PROGRAM_CACHE[key] = make_hsd(p.max_iter, whole_phase=whole)
    prog = _PROGRAM_CACHE[key]
    st = _state_from_ipm(ipm)
    st = st._replace(status=jnp.asarray(RUNNING, jnp.int32))
    start_iter = ipm.n_iter
    if whole:
        st = jax.block_until_ready(prog(st, c, hp))
    else:
        st = _drive_iterated(
            ipm, lambda s: prog(s, c, hp), st, p.max_iter, False
        )
    _sync_to_ipm(st, ipm)
    code = int(st.status)
    _print_fused_log(ipm, st, "hsd", start_iter)
    if code == DUAL_FEASIBLE:
        ipm.status = algo.DUAL_OPTIMAL if d_only else algo.DUAL_FEASIBLE
    else:
        ipm.status = _STATUS_MAP.get(code, algo.NUMERICAL)
    return ipm.status

_PROGRAM_CACHE: dict = {}


def _cache_key(ipm, phase, extra):
    shapes = tuple(
        (ga.F.shape, ga.Ad.shape, ga.C.shape,
         None if ga.Fs is None else ga.Fs.shape)
        for ga in ipm.cones.groups
    )
    lp_shape = None if ipm.cones.lp is None else ipm.cones.lp.A.shape
    ratio = (_RATIO_CFG["mode"], _RATIO_CFG["krylov"], _RATIO_CFG["kwarm"])
    return (
        phase, shapes, lp_shape, ipm.m, ratio, extra,
    )


def _drive_iterated(ipm, body_fn, st, max_iter: int, is_phase_b: bool):
    """Host-driven loop over a jitted iteration body (iteration-fused
    mode): one dispatch + one status read-back per iteration, with
    wall-clock timeout checking the in-graph loop cannot do."""
    import time as _time

    extras = phase_b_init_extras() if is_phase_b else None
    while True:
        if is_phase_b:
            out = body_fn((st,) + extras)
            st, extras = out[0], out[1:]
        else:
            st = body_fn(st)
        code = int(st.status)
        if code != RUNNING:
            return st
        if int(st.n_iter) >= max_iter:
            return st._replace(status=jnp.asarray(MAXITER, jnp.int32))
        if _time.time() - ipm.time_begin >= ipm.params.time_limit:
            return st._replace(status=jnp.asarray(-2, jnp.int32))  # TIMELIMIT


def solve_fused(ipm, d_only: bool = False, mode: str = "phase"):
    """Fused counterpart of DualIPM.solve.

    mode="phase": each phase is one in-graph while-loop dispatch.
    mode="iter": the jitted iteration body is dispatched per iteration
    (large shapes, where the while-loop wrapper's compile time is
    pathological but the body compiles fine).
    """
    from hdsdp_tpu.solver import algo

    p = ipm.params
    whole = mode == "phase"
    f = ipm.f
    c = _cones_from_ipm(ipm)
    ipm.psdp = None
    _RATIO_CFG["mode"] = p.ratio_test
    _RATIO_CFG["krylov"] = p.lanczos_dim
    _RATIO_CFG["kwarm"] = p.lanczos_warm_dim

    # ---- Phase A prologue (host, mirrors algo.phase_a before the loop)
    ipm.which_method = "infeas"
    allow_reset = not (f.many_cones or f.implied_trace or f.very_dense)
    ipm.set_start("infeas", False)
    if not ipm.check_is_interior(ipm.tau, ipm.y):
        ipm.log.info("Initial point is not in the cone. Adding slack value.")
        ipm.reset_start()
        if not ipm.check_is_interior(ipm.tau, ipm.y):
            ipm.status = algo.NUMERICAL
            return ipm.status
    ipm.log.header("infeas")

    reset_rd = max(-max(f.obj_fro_norm, 1e+02) * 1e+06, -1e+15)
    pars_a = _pars_from_ipm(ipm, "a")

    key = _cache_key(ipm, "a", (p.corrector_a, p.max_iter, allow_reset, whole))
    if key not in _PROGRAM_CACHE:
        _compile_notice(ipm, "A")
        _PROGRAM_CACHE[key] = make_phase_a(
            p.corrector_a, p.max_iter, allow_reset, whole_phase=whole
        )
    prog = _PROGRAM_CACHE[key]
    rrd = np.asarray(reset_rd, np.dtype(ipm.dtype))
    st = _state_from_ipm(ipm)
    start_iter = ipm.n_iter
    if whole:
        st = jax.block_until_ready(prog(st, c, pars_a, rrd))
    else:
        st = _drive_iterated(
            ipm, lambda s: prog(s, c, pars_a, rrd), st, p.max_iter, False
        )
    _sync_to_ipm(st, ipm)
    code = int(st.status)
    ipm.status = _STATUS_MAP.get(code, algo.NUMERICAL)
    _print_fused_log(ipm, st, "infeas", start_iter)

    if code == SUSPECT:
        ipm.log.info("\nInfeasible method stops due to suspected infeasibility")
        return _run_hsd_fused(ipm, c, d_only, whole=whole)
    if code != DUAL_FEASIBLE:
        return ipm.status

    # ---- Phase B prologue (host, mirrors algo.phase_b before the loop)
    ipm.log.info("\nInfeasible method finds a dual feasible solution")
    ipm.which_method = "potential"
    feas_tol_b = min(p.abs_feas_tol, p.rel_feas_tol * (1.0 + f.obj_one_norm))
    feas_tol_b = feas_tol_b * ipm.obj_scal / np.sqrt(max(f.n_sum_cone_dims, 1))
    if abs(ipm.Rd) > feas_tol_b:
        ipm.log.info("Dual infeasibility from previous algorithm exceeds tolerance")
    ipm.perturb = -10.0 * ipm.Rd
    ipm.Rd = 0.0
    if ipm.perturb != 0.0:
        ipm.check_is_interior(1.0, ipm.y)
    ipm.log.header("potential")

    pars_b = _pars_from_ipm(ipm, "b")
    psdp_eligible = bool(p.psdp)

    while True:
        key = _cache_key(
            ipm, "b", (p.corrector_b, p.max_iter, psdp_eligible, whole)
        )
        if key not in _PROGRAM_CACHE:
            _compile_notice(ipm, "B")
            _PROGRAM_CACHE[key] = make_phase_b(
                p.corrector_b, p.max_iter, psdp_eligible, whole_phase=whole
            )
        prog = _PROGRAM_CACHE[key]
        st = _state_from_ipm(ipm)
        st = st._replace(perturb=jnp.asarray(ipm.perturb, ipm.dtype))
        start_iter = ipm.n_iter
        if whole:
            st = jax.block_until_ready(prog(st, c, pars_b))
        else:
            st = _drive_iterated(
                ipm, lambda s: prog(s, c, pars_b), st, p.max_iter, True
            )
        _sync_to_ipm(st, ipm)
        code = int(st.status)
        _print_fused_log(ipm, st, "potential", start_iter)

        if code == PSDP_HANDOFF:
            from hdsdp_tpu.solver.psdp import PSDPRefiner

            refiner = PSDPRefiner(ipm)
            refined = refiner.optimize()
            if refined:
                # A clean PSDP return ends the solve even when not
                # converged (ref hdsdp_algo.c:1806-1814: retcode OK ->
                # break); the DIMACS gate decides the final status from
                # the refined (X, y).  Resuming potential reduction
                # would move y while X stays frozen and can drive comp
                # through zero, passing the comp test with a crude
                # primal.
                ipm.psdp = refiner
                ipm.status = (
                    algo.PRIMAL_DUAL_OPTIMAL
                    if refiner.converged
                    else algo.UNKNOWN  # DIMACS gate decides (hdsdp.c:905)
                )
                return ipm.status
            psdp_eligible = False
            continue

        ipm.status = _STATUS_MAP.get(code, algo.NUMERICAL)
        return ipm.status
