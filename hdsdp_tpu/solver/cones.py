"""Functional cone system: batched dual buffers, factors and KKT builds.

This is the batched equivalent of the reference's cone vtable layer
(ref interface/hdsdp_conic.c + def_hdsdp_conic.h:56-107).  Instead of ~30
function pointers mutating per-cone buffers, cone state is an explicit
pytree (tuples of batched arrays) and every operation is a pure jitted
function over it:

  assemble  ~ HConeUpdate / coneInteriorCheckExpert buffer assembly
  factor    ~ HFpLinsysPsdCheck over every cone at once
  build_kkt ~ HKKTBuildUp (ref interface/hdsdp_schur.c:256-268)
  ratio_test~ HConeRatioTest (Lanczos / exact eigh)
  logdet    ~ HConeGetLogBarrier

All heavy functions are module-level jits over (groups, lp) pytrees so the
compiled executables are shared across solver instances with equal shapes.
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.ops import chol as chol_ops
from hdsdp_tpu.ops import ratio as ratio_ops
from hdsdp_tpu.ops import schur as schur_ops
from hdsdp_tpu.ops.schur import GroupArrays, LPArrays

INF = 1e30


class KKTOut(NamedTuple):
    M: Optional[jnp.ndarray]
    asinv: jnp.ndarray
    asinvrdsinv: jnp.ndarray
    asinvcsinv: Optional[jnp.ndarray]
    csinv: jnp.ndarray
    csinvcsinv: jnp.ndarray
    csinvrdsinv: jnp.ndarray
    trace_sinv: jnp.ndarray


# ----------------------------------------------------------------------
# module-level jitted kernels (shared compile cache across instances)
# ----------------------------------------------------------------------


@jax.jit
def _assemble(groups, lp, dC, scal, y, dEye):
    S = tuple(schur_ops.group_dual(ga, dC, scal, y, dEye) for ga in groups)
    s_lp = schur_ops.lp_dual(lp, dC, scal, y, dEye) if lp is not None else None
    return S, s_lp


@jax.jit
def _factor(S, s_lp):
    Ls = []
    ok = jnp.asarray(True)
    for Sg in S:
        good, L = chol_ops.psd_check(Sg)
        Ls.append(L)
        ok = jnp.logical_and(ok, good)
    if s_lp is not None:
        ok = jnp.logical_and(ok, jnp.all(s_lp > 0))
    return ok, tuple(Ls)


@jax.jit
def _logdet(L, s_lp):
    val = jnp.zeros((), L[0].dtype if L else jnp.float64)
    for Lg in L:
        val = val + chol_ops.chol_logdet(Lg)
    if s_lp is not None:
        val = val + jnp.sum(jnp.log(s_lp))
    return val


@partial(jax.jit, static_argnames=("m", "kind"))
def _build_kkt(groups, lp, L, s_lp, Rd, m: int, kind: str,
               col_groups=None) -> KKTOut:
    """col_groups: replicated views of the groups for the COLUMN-side
    operands of M on a row-sharded mesh (see ops.schur._diag_schur)."""
    if col_groups is None:
        col_groups = (None,) * len(groups)
    dtype = L[0].dtype if L else s_lp.dtype
    with_m = kind != "corr"
    M = jnp.zeros((m, m), dtype) if with_m else None
    asinv = jnp.zeros((m,), dtype)
    trsas = jnp.zeros((m,), dtype)
    tr_u = jnp.zeros((), dtype)
    asinvcsinv = jnp.zeros((m,), dtype) if kind == "hsd" else None
    csinv = jnp.zeros((), dtype)
    csinvcsinv = jnp.zeros((), dtype)
    csinvrdsinv = jnp.zeros((), dtype)

    for ga, Lg, cg in zip(groups, L, col_groups):
        U = chol_ops.chol_inverse(Lg)
        out = schur_ops.group_schur(ga, U, m, with_m=with_m, col=cg)
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

    if lp is not None:
        out = schur_ops.lp_schur(lp, s_lp, m, with_m=with_m)
        if with_m:
            M = M + out.M
        asinv = asinv + out.asinv
        trsas = trsas + out.trSAS
        tr_u = tr_u + out.trU
        if kind == "hsd":
            h = schur_ops.lp_hsd(lp, s_lp, m)
            asinvcsinv = asinvcsinv + h.asinvcsinv
            csinv = csinv + h.csinv
            csinvcsinv = csinvcsinv + h.csinvcsinv
            # LP CSinvRdSinv intentionally omitted (ref quirk,
            # hdsdp_conic_lp.c:315-327)

    return KKTOut(
        M=M,
        asinv=asinv,
        asinvrdsinv=Rd * trsas,
        asinvcsinv=asinvcsinv,
        csinv=csinv,
        csinvcsinv=csinvcsinv,
        csinvrdsinv=csinvrdsinv,
        trace_sinv=tr_u,
    )


@jax.jit
def _inverses(L):
    """U = S^-1 per group from the Cholesky factors (one dispatch)."""
    return tuple(chol_ops.chol_inverse(Lg) for Lg in L)


@partial(jax.jit, static_argnames=("m", "kind"))
def _build_kkt_rhs(groups, lp, Us, s_lp, Rd, m: int, kind: str) -> KKTOut:
    """RHS-only KKT build from precomputed inverses: the matrix-free
    analogue of _build_kkt (M stays None; ≙ the reference's sparse-Schur
    decision at hdsdp_schur.c:60,227 — here M is never materialized)."""
    dtype = Us[0].dtype if Us else s_lp.dtype
    asinv = jnp.zeros((m,), dtype)
    trsas = jnp.zeros((m,), dtype)
    tr_u = jnp.zeros((), dtype)
    asinvcsinv = jnp.zeros((m,), dtype) if kind == "hsd" else None
    csinv = jnp.zeros((), dtype)
    csinvcsinv = jnp.zeros((), dtype)
    csinvrdsinv = jnp.zeros((), dtype)

    for ga, U in zip(groups, Us):
        out = schur_ops.group_schur(ga, U, m, with_m=False)
        asinv = asinv + out.asinv
        trsas = trsas + out.trSAS
        tr_u = tr_u + out.trU
        if kind == "hsd":
            h = schur_ops.group_hsd(ga, U, m)
            asinvcsinv = asinvcsinv + h.asinvcsinv
            csinv = csinv + h.csinv
            csinvcsinv = csinvcsinv + h.csinvcsinv
            csinvrdsinv = csinvrdsinv + Rd * h.trUCU

    if lp is not None:
        out = schur_ops.lp_schur(lp, s_lp, m, with_m=False)
        asinv = asinv + out.asinv
        trsas = trsas + out.trSAS
        tr_u = tr_u + out.trU
        if kind == "hsd":
            h = schur_ops.lp_hsd(lp, s_lp, m)
            asinvcsinv = asinvcsinv + h.asinvcsinv
            csinv = csinv + h.csinv
            csinvcsinv = csinvcsinv + h.csinvcsinv

    return KKTOut(
        M=None,
        asinv=asinv,
        asinvrdsinv=Rd * trsas,
        asinvcsinv=asinvcsinv,
        csinv=csinv,
        csinvcsinv=csinvcsinv,
        csinvrdsinv=csinvrdsinv,
        trace_sinv=tr_u,
    )


@partial(jax.jit, static_argnames=("m",))
def _kkt_diag(groups, lp, Us, s_lp, m: int):
    """Exact diag(M) for the Jacobi preconditioner of the operator path."""
    dtype = Us[0].dtype if Us else s_lp.dtype
    d = jnp.zeros((m,), dtype)
    for ga, U in zip(groups, Us):
        d = d + schur_ops.group_schur_diag(ga, U, m)
    if lp is not None:
        d = d + schur_ops.lp_schur_diag(lp, s_lp)
    return d


def _kkt_apply(groups, lp, Us, s_lp, extra_diag, V, m):
    """M @ V for [m, k] V through the per-bucket operators.
    extra_diag [m] carries the bound-cone diagonal + regularization."""

    def one(v):
        out = extra_diag * v
        for ga, U in zip(groups, Us):
            out = out + schur_ops.group_schur_matvec(ga, U, v, m)
        if lp is not None:
            out = out + schur_ops.lp_schur_matvec(lp, s_lp, v)
        return out

    return jax.vmap(one, in_axes=1, out_axes=1)(V)


@partial(jax.jit, static_argnames=("m",))
def _kkt_matvec(groups, lp, Us, s_lp, extra_diag, V, m: int):
    return _kkt_apply(groups, lp, Us, s_lp, extra_diag, V, m)


def _pcg_body(mv, papply, B, abs_tol, rel_tol, max_iter):
    """Shared PCG recurrence for the matrix-free operator (k independent
    right-hand sides, per-column recurrences; ≙ conjGradSolve, ref
    hdsdp_linsolver.c:1446-1588).  ``papply`` is the preconditioner
    application R -> P^-1 R."""
    bnorm = jnp.linalg.norm(B, axis=0)
    tol = jnp.maximum(abs_tol, rel_tol * bnorm)
    X = jnp.zeros_like(B)
    R = B
    Z = papply(R)
    P = Z
    rz = jnp.sum(R * Z, axis=0)

    def cond(c):
        X, R, P, rz, it = c
        res = jnp.linalg.norm(R, axis=0)
        return jnp.logical_and(it < max_iter, jnp.any(res > tol))

    def body(c):
        X, R, P, rz, it = c
        live = (jnp.linalg.norm(R, axis=0) > tol).astype(B.dtype)
        Q = mv(P)
        pq = jnp.sum(P * Q, axis=0)
        alpha = jnp.where(pq > 0, rz / jnp.where(pq == 0, 1.0, pq), 0.0) * live
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * Q
        Z = papply(R)
        rz_new = jnp.sum(R * Z, axis=0)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
        P = Z + beta[None, :] * P
        return X, R, P, rz_new, it + 1

    X, R, P, rz, it = jax.lax.while_loop(cond, body, (X, R, P, rz, 0))
    return X, jnp.linalg.norm(R, axis=0), it


@partial(jax.jit, static_argnames=("m", "max_iter"))
def _kkt_pcg(groups, lp, Us, s_lp, extra_diag, pinv, B, m: int,
             abs_tol: float, rel_tol: float, max_iter: int):
    """Jacobi-preconditioned CG on the matrix-free Schur operator
    (the Jacobi branch of conjGradSolve).  Returns (X, resnorm [k],
    n_iters)."""

    def mv(V):
        return _kkt_apply(groups, lp, Us, s_lp, extra_diag, V, m)

    return _pcg_body(
        mv, lambda R: pinv[:, None] * R, B, abs_tol, rel_tol, max_iter
    )


@partial(jax.jit, static_argnames=("m", "max_iter"))
def _kkt_pcg_chol(groups, lp, Us, s_lp, extra_diag, L32, s, B, m: int,
                  abs_tol: float, rel_tol: float, max_iter: int):
    """Cholesky-preconditioned CG on the matrix-free operator: the
    factorization-grade endgame backend of operator mode (round 5,
    VERDICT #4).  ``L32`` is the equilibrated f32 Cholesky factor of a
    (possibly STALE, ADPCG-style) chunk-materialized M; its application
    is two f32 triangular solves.  CG polishes the f32/staleness error — for
    kappa(M) ~ 1e10 the preconditioned system has kappa ~ 1 +
    eps_f32 * kappa ~ 1e3, tens of iterations instead of the Jacobi
    path's stalled thousands (≙ conjGradSolve's Cholesky branch +
    the ADPCG refresh policy, hdsdp_linsolver.c:1446-1588)."""

    def mv(V):
        return _kkt_apply(groups, lp, Us, s_lp, extra_diag, V, m)

    def papply(R):
        Rf = (s[:, None] * R).astype(L32.dtype)
        T = chol_ops.chol_solve(L32, Rf)
        return s[:, None] * T.astype(B.dtype)

    return _pcg_body(mv, papply, B, abs_tol, rel_tol, max_iter)


@partial(jax.jit, static_argnames=("m", "chunk"))
def _kkt_rows(groups, lp, Us, s_lp, bound_extra, i0, m: int, chunk: int):
    """Rows [i0, i0+chunk) of the full KKT matrix (SDP groups + LP +
    diagonal bound/reg terms), [chunk, m] f64.  ``i0`` is traced: one
    compilation serves every chunk of the materialization loop."""
    dtype = Us[0].dtype if Us else s_lp.dtype
    out = jnp.zeros((chunk, m), dtype)
    for ga, U in zip(groups, Us):
        r = schur_ops.group_schur_rows(ga, U, i0, chunk, m)
        assert r is not None, "caller must check kkt_rows_supported first"
        out = out + r
    if lp is not None:
        out = out + schur_ops.lp_schur_rows(lp, s_lp, i0, chunk)
    idx = jnp.arange(chunk)
    extra = jax.lax.dynamic_slice_in_dim(bound_extra, i0, chunk)
    return out.at[idx, i0 + idx].add(extra)


@partial(jax.jit, static_argnames=("mode", "krylov"))
def _ratio(L, s_lp, dS, ds_lp, mode: str = "auto", krylov: int = 30):
    step = jnp.asarray(INF, L[0].dtype if L else jnp.float64)
    for Lg, dSg in zip(L, dS):
        steps = ratio_ops.block_ratio(Lg, dSg, mode=mode, krylov=krylov)
        step = jnp.minimum(step, jnp.min(steps))
    if s_lp is not None:
        step_lp = ratio_ops.vector_ratio_test(s_lp, ds_lp)
        step = jnp.minimum(step, step_lp)
    return step


@partial(jax.jit, static_argnames=("mode", "krylov"))
def _ratio_warm(L, s_lp, dS, ds_lp, warms, mode: str = "auto", krylov: int = 30):
    """Like _ratio, but carries Lanczos warm-start vectors per group
    across IPM iterations (ref hdsdp_lanczos.c:166-178) and uses the
    early-exit adaptive kernel for large blocks."""
    step = jnp.asarray(INF, L[0].dtype if L else jnp.float64)
    new_warms = []
    for Lg, dSg, w in zip(L, dS, warms):
        steps, warm = ratio_ops.block_ratio(
            Lg, dSg, mode=mode, krylov=krylov, v0=w, return_warm=True
        )
        new_warms.append(warm)
        step = jnp.minimum(step, jnp.min(steps))
    if s_lp is not None:
        step_lp = ratio_ops.vector_ratio_test(s_lp, ds_lp)
        step = jnp.minimum(step, step_lp)
    return step, tuple(new_warms)


@jax.jit
def _interior_check(groups, lp, dC, scal, y, dEye, tau, lo, up):
    """Fused assemble + factor + bound slacks: ONE dispatch, one packed
    flag read-back (the op-by-op path costs ~6 host round-trips)."""
    S, s_lp = _assemble(groups, lp, dC, scal, y, dEye)
    ok, L = _factor(S, s_lp)
    sl = y - tau * lo
    su = tau * up - y
    bok = jnp.logical_and(jnp.all(sl > 0), jnp.all(su > 0))
    flags = jnp.stack([ok, bok])
    return S, s_lp, L, sl, su, flags


@jax.jit
def _add_step_check(S, s_lp, dS, ds_lp, alpha):
    S_new = tuple(Sg + alpha * dSg for Sg, dSg in zip(S, dS))
    s_new = s_lp + alpha * ds_lp if s_lp is not None else None
    ok, Lnew = _factor(S_new, s_new)
    return ok, S_new, s_new, Lnew


@partial(jax.jit, static_argnames=("m",))
def _atx(groups, lp, X_list, x_lp, m: int):
    dtype = X_list[0].dtype if X_list else jnp.float64
    out = jnp.zeros((m,), dtype)
    for ga, X in zip(groups, X_list):
        out = out + schur_ops.group_atx(ga, X, m)
    if lp is not None:
        out = out + lp.A @ x_lp
    return out


@jax.jit
def _ctx(groups, lp, X_list, x_lp):
    val = jnp.zeros((), X_list[0].dtype if X_list else jnp.float64)
    for ga, X in zip(groups, X_list):
        val = val + jnp.sum(ga.C * X)
    if lp is not None:
        val = val + lp.c @ x_lp
    return val


# ----------------------------------------------------------------------
# cone system wrapper
# ----------------------------------------------------------------------


# Max unrolled gathered-m^2 terms (r(r+1)/2 * c^2) the bounded-support
# Schur build may emit before falling back to slot-major matmuls: the
# theta family needs 24 (r=3, c=2); a hypothetical c=4/r=8 instance
# would emit 576 and compile for an hour.
SUPPORT_TERM_BUDGET = 64


class ConeSystem:
    """Holds device-side cone data and compiled cone operations."""

    def __init__(self, prob: SDPProblem, obj_scal: float = 1.0, dtype=jnp.float64,
                 layout: str = "auto"):
        """layout: "auto" stores single-block groups slot-major (the
        large-m path, see GroupArrays) with the diag/support gather
        specializations; "slot" keeps slot-major but disables the
        specializations (cross-validation paths); "flat" forces the
        packed-slot layout (used by the sharded system, which
        partitions the R axis)."""
        self.m = prob.m
        self.dtype = dtype
        specialize = layout == "auto"

        def _slot_major(g):
            """Slot-major low-rank layout for single-block groups (see
            GroupArrays docstring): Fs[j, i] = j-th eigenvector of A_i.
            Scales to SDPLIB-size m without the [g, R, m] one-hot blow-up."""
            m = prob.m
            lam0 = np.asarray(g.lam[0])
            seg0 = np.asarray(g.seg[0])
            F0 = np.asarray(g.F[0])
            nz = np.nonzero(lam0 != 0.0)[0]
            counts = np.bincount(seg0[nz], minlength=m) if len(nz) else np.zeros(m, int)
            r = max(int(counts.max()) if len(counts) else 0, 1)
            Fs = np.zeros((r, m, g.dim))
            lams = np.zeros((r, m))
            fill = np.zeros(m, np.int64)
            for idx in nz:
                i = seg0[idx]
                j = fill[i]
                fill[i] = j + 1
                Fs[j, i] = F0[idx]
                lams[j, i] = lam0[idx]

            # DIAGONAL specialization (maxG*/torus* structure): r == 1
            # and every factor a scaled standard-basis vector makes
            # every coefficient A_i = w_i e_{p_i} e_{p_i}^T, so the
            # Schur build collapses to an O(m^2) gather (see
            # ops.schur._diag_schur; ≙ ref M2 rank-one quadforms on
            # 1-nnz eigenvectors, hdsdp_conic_sdp.c:687-778).
            dpos = dw = None
            spos = sval = None
            nnz_rows = np.count_nonzero(Fs, axis=2)  # [r, m]
            if not specialize:
                pass
            elif r == 1 and np.all(nnz_rows[0] <= 1):
                p = np.argmax(np.abs(Fs[0]), axis=1)
                v = Fs[0][np.arange(m), p]
                if m == g.dim and np.array_equal(p, np.arange(m)):
                    # identity map p_i = i (maxcut/torus): a length-0
                    # dpos marks it at trace time so every gather
                    # through p is skipped (see GroupArrays.dpos)
                    dpos = jnp.zeros((0,), jnp.int32)
                else:
                    dpos = jnp.asarray(p, jnp.int32)
                dw = jnp.asarray(lams[0] * v * v, dtype)
            elif (
                nnz_rows.max(initial=0) <= 4
                # compile-budget guard: the support M build unrolls
                # r(r+1)/2 * c^2 gathered m x m Hadamard terms
                # (ops.schur._support_schur); past this budget the
                # unroll dominates XLA compile time, so fall back to
                # the slot-major matmul path instead
                and (r * (r + 1) // 2)
                * int(nnz_rows.max(initial=1)) ** 2
                <= SUPPORT_TERM_BUDGET
            ):
                # bounded-support layout (see GroupArrays.spos): the
                # theta family's rank-2 coefficients have 2-nnz
                # eigenvectors — assembly becomes m^2 gathers
                c = max(int(nnz_rows.max(initial=1)), 1)
                spos_np = np.zeros((r, m, c), np.int32)
                sval_np = np.zeros((r, m, c))
                for j in range(r):
                    for i in np.nonzero(nnz_rows[j])[0]:
                        idx = np.nonzero(Fs[j, i])[0]
                        spos_np[j, i, : len(idx)] = idx
                        sval_np[j, i, : len(idx)] = Fs[j, i, idx]
                spos = jnp.asarray(spos_np)
                sval = jnp.asarray(sval_np, dtype)
            elif nnz_rows.max(initial=0) <= 4:
                import logging

                logging.getLogger("hdsdp_tpu").info(
                    "support bucket skipped: r=%d c=%d exceeds the "
                    "unrolled-term compile budget (%d); using slot-major",
                    r, int(nnz_rows.max(initial=1)), SUPPORT_TERM_BUDGET,
                )
            if dpos is not None or spos is not None:
                # gather buckets never read Fs's DATA, only its shape
                # (ops.schur dispatches on dpos/spos first); a [r, 1, n]
                # placeholder keeps the shape contract without shipping
                # an r*m*n f64 argument (0.9 GB at torus-22) per dispatch
                Fs = np.zeros((Fs.shape[0], 1, g.dim))
            return (
                jnp.asarray(Fs, dtype),
                jnp.asarray(lams, dtype),
                dpos,
                dw,
                spos,
                sval,
            )

        def _make_group(g):
            kw = dict(
                C=jnp.asarray(g.C * obj_scal, dtype),
                Ad=jnp.asarray(g.Ad, dtype),
                didx=jnp.asarray(g.didx, jnp.int32),
                dblk=jnp.asarray(g.dblk, jnp.int32),
            )
            if g.nblk == 1 and layout in ("auto", "slot"):
                Fs, lams, dpos, dw, spos, sval = _slot_major(g)
                return GroupArrays(
                    F=jnp.zeros((1, 1, g.dim), dtype),
                    lam=jnp.zeros((1, 1), dtype),
                    seg=jnp.zeros((1, 1), jnp.int32),
                    pos=None,
                    Fs=Fs,
                    lams=lams,
                    dpos=dpos,
                    dw=dw,
                    spos=spos,
                    sval=sval,
                    **kw,
                )
            return GroupArrays(
                F=jnp.asarray(g.F, dtype),
                lam=jnp.asarray(g.lam, dtype),
                seg=jnp.asarray(g.seg, jnp.int32),
                pos=None,
                **kw,
            )

        self.groups: Tuple[GroupArrays, ...] = tuple(
            _make_group(g) for g in prob.groups
        )
        self.group_dims = [g.dim for g in prob.groups]
        self.group_nblk = [g.nblk for g in prob.groups]

        self.has_lp = prob.lp is not None
        if self.has_lp:
            self.lp = LPArrays(
                A=jnp.asarray(prob.lp.A, dtype),
                c=jnp.asarray(prob.lp.c * obj_scal, dtype),
            )
        else:
            self.lp = None

        # sum of SDP cone dims + LP dims (bound cone counted by the solver)
        self.sum_cone_dims = prob.sum_cone_dims
        self.n_cones = len(prob.block_dims) + (1 if self.has_lp else 0)

    # -- buffer assembly ------------------------------------------------
    def assemble(self, dC, scal, y, dEye):
        """B = dEye*I + scal*A'y + dC*C per cone."""
        return _assemble(self.groups, self.lp, dC, scal, y, dEye)

    # -- factorization / PSD check --------------------------------------
    def factor(self, S, s_lp):
        return _factor(S, s_lp)

    # -- barrier ---------------------------------------------------------
    def logdet(self, L, s_lp):
        return _logdet(L, s_lp)

    # -- KKT build --------------------------------------------------------
    def build_kkt(self, L, s_lp, Rd, kind: str) -> KKTOut:
        """kind in {"inf", "hsd", "corr"} ~ KKT_TYPE_* (ref hdsdp_conic.h:16-19)."""
        return _build_kkt(self.groups, self.lp, L, s_lp, Rd, self.m, kind)

    # -- matrix-free Schur operator (sparse-Schur analogue) ---------------
    def inverses(self, L):
        """U = S^-1 per group (cached by the solver across one KKT round)."""
        return _inverses(L)

    def build_kkt_rhs(self, Us, s_lp, Rd, kind: str) -> KKTOut:
        """KKT RHS vectors only, M never materialized (operator mode)."""
        return _build_kkt_rhs(self.groups, self.lp, Us, s_lp, Rd, self.m, kind)

    def kkt_diag(self, Us, s_lp):
        """Exact diag(M) — the Jacobi preconditioner of the operator mode."""
        return _kkt_diag(self.groups, self.lp, Us, s_lp, self.m)

    def kkt_matvec(self, Us, s_lp, extra_diag, V):
        """M @ V ([m, k]) through the per-bucket operators."""
        return _kkt_matvec(
            self.groups, self.lp, Us, s_lp, extra_diag, V, self.m
        )

    def kkt_pcg(self, Us, s_lp, extra_diag, pinv, B, abs_tol=1e-10,
                rel_tol=1e-10, max_iter=600):
        """Jacobi-PCG solve of M X = B on the operator; one dispatch."""
        return _kkt_pcg(
            self.groups, self.lp, Us, s_lp, extra_diag, pinv, B, self.m,
            abs_tol, rel_tol, max_iter,
        )

    def kkt_pcg_chol(self, Us, s_lp, extra_diag, L32, s, B, abs_tol=1e-10,
                     rel_tol=1e-10, max_iter=600):
        """Cholesky-preconditioned CG on the operator (stale f32 factor
        of a chunk-materialized M; see _kkt_pcg_chol)."""
        return _kkt_pcg_chol(
            self.groups, self.lp, Us, s_lp, extra_diag, L32, s, B, self.m,
            abs_tol, rel_tol, max_iter,
        )

    def kkt_rows_supported(self) -> bool:
        """True when every group is row-chunkable (slot-major layout,
        dense slots allowed) so the f32 preconditioner can be
        materialized in chunks."""
        return all(ga.Fs is not None for ga in self.groups)

    def kkt_rows(self, Us, s_lp, bound_extra, i0, chunk: int):
        """Rows [i0, i0+chunk) of the full KKT matrix, [chunk, m]."""
        return _kkt_rows(
            self.groups, self.lp, Us, s_lp, bound_extra, i0, self.m, chunk
        )

    def kkt_full_from_rows(self, Us, s_lp, bound_extra, chunk: int = 2048):
        """The full [m, m] KKT matrix assembled from row chunks — for
        factor-once consumers (PSDP) at sizes where the monolithic
        with_m build program does not compile (observed m = 25001)."""
        m = self.m
        chunk = min(chunk, m)
        i0s = list(range(0, m - chunk + 1, chunk))
        if not i0s or i0s[-1] + chunk < m:
            i0s.append(m - chunk)
        M = jnp.zeros((m, m), self.dtype)
        for i0 in i0s:
            rows = self.kkt_rows(Us, s_lp, bound_extra, i0, chunk)
            M = jax.lax.dynamic_update_slice(M, rows, (i0, 0))
        return M

    # -- ratio test --------------------------------------------------------
    ratio_mode: str = "auto"
    lanczos_dim: int = 30

    def ratio_test(self, L, s_lp, dS, ds_lp):
        """Max alpha with S + alpha*dS >= 0 over all cones
        (ref HConeRatioTest; LP part per hdsdp_conic_lp.c:228-243).

        Lanczos warm starts are carried on the system across calls
        (ref HLanczos->dLanczosWarmStart): the Ritz image recorded by
        the previous test seeds the next one."""
        warms = getattr(self, "_lz_warm", None)
        if warms is None or len(warms) != len(L):
            warms = (None,) * len(L)
        step, warms = _ratio_warm(
            L, s_lp, dS, ds_lp, warms,
            mode=self.ratio_mode, krylov=self.lanczos_dim,
        )
        self._lz_warm = warms
        return step

    # -- add step to buffer and check (ref sdpDenseConeAddStepToBufferAndCheck)
    def add_step_check(self, S, s_lp, dS, ds_lp, alpha):
        return _add_step_check(S, s_lp, dS, ds_lp, alpha)

    # -- primal / misc helpers ---------------------------------------------
    def atx(self, X_list, x_lp):
        """A(X) over all cones."""
        return _atx(self.groups, self.lp, tuple(X_list), x_lp, self.m)

    def ctx(self, X_list, x_lp):
        """<C, X> over all cones."""
        return _ctx(self.groups, self.lp, tuple(X_list), x_lp)
