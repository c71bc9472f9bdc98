"""PSDP primal refinement (ref interface/hdsdp_psdp.c).

When Phase B nearly converges, a primal-dual pair (X, y, S) is refined by a
primal interior-point method: the Schur machinery is reused with X in place
of S^-1 (KKT_TYPE_PRIMAL, ref hdsdp_conic_sdp.c:1745-1756) and factored
ONCE; each iteration solves

    M dy = A(XSX/mu - X) + (b - A(X)),        M_ij = tr(A_i X A_j X)

then steps  y += a_d*dy,  X += a_p*(X - XSX/mu - Xs dS Xs / mu)
(ref HPSDPOptimize, hdsdp_psdp.c:164-457), with ratio tests on both the
dual cone (S + a*dS >= 0) and the primal factor (X + a*dX >= 0).
On any failure the dual iterate is restored (ref HPSDPIRecover, :31-47).

Layout: X / XSX / dX are batched per block group; the X-weighted Schur
build reuses the same bucketed kernels as the dual build (U -> X).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hdsdp_tpu.ops import chol as chol_ops
from hdsdp_tpu.ops import ratio as ratio_ops
from hdsdp_tpu.ops import schur as schur_ops
from hdsdp_tpu.solver import memory


def _build_primal_kkt(groups, X_list, m):
    """M_ij = sum tr(A_i X A_j X) (KKT_TYPE_PRIMAL: X replaces S^-1)."""
    M = jnp.zeros((m, m), X_list[0].dtype)
    for ga, X in zip(groups, X_list):
        out = schur_ops.group_schur(ga, X, m, with_m=True)
        M = M + out.M
    return M


def _xsx(X, S):
    """Batched congruence X S X (ref fds_trimultiply)."""
    return jnp.einsum("gij,gjk,gkl->gil", X, S, X, optimize=True)


@jax.jit
def _primal_ratio(X, dX):
    """PSD-check every block of X and bound max a with X + a dX >= 0.

    One dispatch for all groups; large blocks go through the Lanczos
    ratio test exactly as the dual side does (the reference gives each
    cone its own primal Lanczos, hdsdp_psdp.c:19-29) instead of a
    per-block host loop of exact eigh calls.
    """
    ok = jnp.bool_(True)
    step = jnp.asarray(1e30, X[0].dtype)
    for Xg, dXg in zip(X, dX):
        okg, LX = chol_ops.psd_check(Xg)
        ok = jnp.logical_and(ok, okg)
        steps = ratio_ops.block_ratio(LX, dXg, mode="auto")
        step = jnp.minimum(step, jnp.min(steps))
    return ok, step


@jax.jit
def _post_step(X, S):
    """Joint PSD check of the stepped X and complementarity tr(XS)."""
    ok = jnp.bool_(True)
    compl = jnp.asarray(0.0, X[0].dtype)
    for Xg, Sg in zip(X, S):
        okg, _ = chol_ops.psd_check(Xg)
        ok = jnp.logical_and(ok, okg)
        compl = compl + jnp.sum(Xg * Sg)
    return ok, compl


class PSDPRefiner:
    """Primal refinement driver bound to a DualIPM instance."""

    def __init__(self, ipm):
        self.ipm = ipm
        self.X: Optional[List[jnp.ndarray]] = None
        self.converged = False

    # ------------------------------------------------------------------
    def get_primal(self) -> Tuple[List[jnp.ndarray], Optional[jnp.ndarray]]:
        if self.X is None:
            raise NotImplementedError
        return self.X, None

    # ------------------------------------------------------------------
    def optimize(self) -> bool:
        ipm = self.ipm
        from hdsdp_tpu.solver import algo, dimacs

        # preconditions (ref HPSDPInit: needs zero dual residual, no LP cone)
        if ipm.cones.has_lp or ipm.Rd != 0.0:
            return False
        maker = ipm.maker_acc if ipm.maker_acc.mu > 0.0 else ipm.maker_inacc
        if maker.mu <= 0.0:
            return False
        rec = dimacs.recover_primal(ipm, maker)
        if rec is None:
            return False
        X = [0.5 * (Xg + jnp.swapaxes(Xg, -1, -2)) for Xg in rec[0]]
        for Xg in X:
            ok, _ = chol_ops.psd_check(Xg)
            if not bool(ok):
                return False

        groups = ipm.cones.groups
        m = ipm.m
        b = ipm.b
        mu = ipm.mu
        y_backup = ipm.y
        sum_dims = ipm.all_cone_dims - 2.0 * m  # SDP dims only (ref :199)
        pd_scal = 1.0 / (ipm.rhs_scal * ipm.obj_scal)
        p = ipm.params

        Xscal = [Xg for Xg in X]
        ipm.log.info("HDSDP nearly converges. Primal refinement starts.")

        # Operator-mode composition (round 5): when the dual solve ran
        # matrix-free (kkt_free) the refiner still works — it either
        # materializes its own X-weighted M once (the reference's
        # factor-once/solve-many, hdsdp_psdp.c:203-207) while m is small
        # enough to afford a dense system, or runs every PSDP KKT solve
        # through the same matrix-free Jacobi-PCG machinery with X in
        # place of S^-1 (M_ij = tr(A_i X A_j X) has the identical
        # operator form).
        use_operator = bool(getattr(ipm, "kkt_free", False)) and (
            m > ipm.materialize_cap()
            or getattr(ipm, "_op_mat_unavailable", False)
        )
        op_state: dict = {}

        def fail(reason: str) -> bool:
            # ref HPSDPIRecover + "Primal method fails. Switch back to
            # dual method." (hdsdp_psdp.c:449-455)
            ipm.log.info(
                f"Primal method fails ({reason}). Switch back to dual method."
            )
            ipm.y = y_backup
            ipm.check_is_interior(1.0, ipm.y)
            return False

        def factor_primal_kkt():
            from hdsdp_tpu.solver.cones import KKTOut, _kkt_diag

            if use_operator:
                # the "factor" is the exact Jacobi diagonal of the
                # X-weighted Schur operator (the matrix-free analogue of
                # the reference's one-time HKKTFactorize), upgraded to
                # the chunk-materialized f32 Cholesky preconditioner
                # when the layout supports it (same machinery as the
                # dual operator path, round 5)
                diag = _kkt_diag(groups, None, tuple(Xscal), None, m)
                reg = 1e-16 * float(jnp.max(diag)) + 1e-300
                op_state["extra"] = jnp.full((m,), reg, diag.dtype)
                op_state["pinv"] = 1.0 / jnp.maximum(diag + reg, 1e-300)
                op_state["pc"] = None
                if (
                    m <= memory.dense_m_cap()
                    and ipm.cones.kkt_rows_supported()
                ):
                    op_state["pc"] = ipm._build_chunked_precond(
                        tuple(Xscal), None, op_state["extra"], diag + reg
                    )
                return

            # the monolithic with_m build program did not compile at
            # m = 25001: assemble the X-weighted M from row chunks when
            # the layout allows
            if ipm.cones.kkt_rows_supported() and m >= 8192:
                zero = jnp.zeros((m,), ipm.dtype)
                M = ipm.cones.kkt_full_from_rows(
                    tuple(Xscal), None, zero, chunk=p.op_precond_chunk
                )
            else:
                M = _build_primal_kkt(groups, Xscal, m)
            # regularize (ref HKKTRegularize with 1e-16 coefficient)
            reg = 1e-16 * float(jnp.max(jnp.diag(M))) + 1e-300
            ipm.kkt = KKTOut(
                M=M + reg * jnp.eye(m, dtype=M.dtype),
                asinv=None, asinvrdsinv=None, asinvcsinv=None,
                csinv=None, csinvcsinv=None, csinvrdsinv=None,
                trace_sinv=None,
            )
            # factor-once / solve-many: bypass the CG policy (ref
            # HKKTFactorize once, hdsdp_psdp.c:203-207).  Under operator
            # mode factor_kkt would short-circuit to the dual operator
            # state, so the flag is dropped around the primal factor.
            saved_free = ipm.kkt_free
            ipm.kkt_free = False
            try:
                ipm.factor_kkt(force_direct=not ipm._row_sharded())
            finally:
                ipm.kkt_free = saved_free

        def solve_primal_kkt(rhs):
            """M dy = rhs against the X-weighted system (direct factor,
            chol-preconditioned CG, or restarted Jacobi-PCG chunks)."""
            if not use_operator:
                return ipm.solve_kkt(rhs)
            B = rhs[:, None]
            sol = jnp.zeros_like(B)
            R = B
            if op_state.get("pc") is not None:
                L32, s = op_state["pc"]
                sol, res, _ = ipm.cones.kkt_pcg_chol(
                    tuple(Xscal), None, op_state["extra"], L32, s, B,
                    abs_tol=1e-10, rel_tol=1e-10,
                    max_iter=max(p.kkt_free_maxiter, 600),
                )
                if float(jnp.max(res)) <= 1e-06 * max(
                    float(jnp.linalg.norm(rhs)), 1.0
                ):
                    return sol[:, 0]
                # keep the chol iterate: the Jacobi chunks below warm-
                # start from its residual
                R = B - ipm.cones.kkt_matvec(
                    tuple(Xscal), None, op_state["extra"], sol
                )
            chunk = max(p.kkt_free_maxiter, 600)
            bscale = max(float(jnp.linalg.norm(rhs)), 1.0)
            for _ in range(8):
                dsol, _, _ = ipm.cones.kkt_pcg(
                    tuple(Xscal), None, op_state["extra"],
                    op_state["pinv"], R,
                    abs_tol=1e-10, rel_tol=1e-10, max_iter=chunk,
                )
                sol = sol + dsol
                R = B - ipm.cones.kkt_matvec(
                    tuple(Xscal), None, op_state["extra"], sol
                )
                if float(jnp.linalg.norm(R)) <= 1e-08 * bscale:
                    break
            return sol[:, 0]

        factor_primal_kkt()

        n_bad = 0
        comp_prev = ipm.comp / pd_scal if np.isfinite(ipm.comp) else 1e30
        n_slow = 0  # diminishing-returns exit (beyond the reference)

        for n_iter in range(100):
            ax = ipm.cones.atx(X, None)
            rp = b - ax
            p_inf_norm = float(jnp.linalg.norm(rp))

            # rhs = A(XSX/mu - X) + rp  (ref :240-255)
            buf = [
                _xsx(Xg, Sg) / mu - Xg for Xg, Sg in zip(X, ipm.S)
            ]
            rhs = ipm.cones.atx(buf, None) + rp
            dy = solve_primal_kkt(rhs) * mu

            # dual ratio test; dS = -A'dy (Rd = 0)
            dS, _ = ipm.cones.assemble(0.0, -1.0, dy, 0.0)
            d_step = float(ipm.cones.ratio_test(ipm.L, None, dS, None))

            # dX = X - XSX/mu - Xscal dS Xscal / mu  (ref :283-300)
            dX = [
                -bg - _xsx(Xs, dSg) / mu
                for bg, Xs, dSg in zip(buf, Xscal, dS)
            ]

            # primal ratio test: X + a dX >= 0, all groups in one
            # dispatch (Lanczos at size, exact eigh for small blocks)
            okX, p_step_dev = _primal_ratio(tuple(X), tuple(dX))
            if not bool(okX):
                return fail("X not PSD at ratio test")
            p_step = float(p_step_dev)

            p_step = min(0.5 * p_step, 1.0)
            d_step = min(0.5 * d_step, 1.0)

            # take step (ref :327-339)
            y_new = ipm.y + d_step * dy
            X = [Xg + p_step * dXg for Xg, dXg in zip(X, dX)]

            if not ipm.check_is_interior(1.0, y_new):
                return fail("dual step leaves the cone")
            ipm.y = y_new

            ok_all, compl_dev = _post_step(tuple(X), tuple(ipm.S))
            if not bool(ok_all):
                return fail("stepped X not PSD")

            # objective + barrier update (ref :352-383)
            d_obj = float(b @ ipm.y)
            p_obj = float(ipm.cones.ctx(X, None))
            compl = float(compl_dev)
            if p_obj < d_obj:
                return fail("pObj crossed below dObj")

            target = (p_obj - d_obj) / (2.0 * sum_dims)
            if mu < 1e-09:
                target = min(mu, compl / sum_dims)
                mu = target * (1.0 - 1.0 / np.sqrt(sum_dims))
            else:
                mu = target * (1.0 - 1.0 / np.sqrt(sum_dims))

            # synchronize to solver state (ref :386-401)
            ipm.p_obj_internal = p_obj
            ipm.d_obj_internal = d_obj
            ipm.d_obj_val = d_obj * pd_scal
            ipm.p_obj_val = p_obj * pd_scal
            ipm.p_infeas = p_inf_norm / (1.0 + ipm.f.rhs_one_norm)
            ipm.mu = mu
            ipm.d_step = d_step
            ipm.comp = ipm.p_obj_val - ipm.d_obj_val
            ipm.n_iter += 1
            ipm.log.iter_row(
                "psdp", ipm.n_iter + 1, ipm.p_obj_val, ipm.d_obj_val,
                ipm.p_infeas, mu, d_step, p_step,
                time.time() - ipm.time_begin,
            )

            if (
                ipm.comp
                < (abs(ipm.p_obj_val) + abs(ipm.d_obj_val) + 1.0) * p.rel_opt_tol
                and ipm.comp < p.abs_opt_tol * pd_scal
            ):
                ipm.status = algo.PRIMAL_DUAL_OPTIMAL
                self.converged = True
                break

            if n_bad > 2:
                break

            # small steps: refresh scaling matrix + refactor (ref :425-444)
            if (p_step < 1e-02 and d_step < 1e-02) or p_step < 1e-03:
                # X was PSD-verified by _post_step above; rebuild the
                # scaling matrix and refactor (ref :425-444)
                Xscal = [Xg for Xg in X]
                factor_primal_kkt()
                n_bad += 1
                ipm.log.info(f"Primal scaling refresh {n_bad}/3")

            if compl > 10.0 * comp_prev:
                break
            if ipm.p_infeas > 1e-06:
                return fail(f"primal infeasibility {ipm.p_infeas:.1e}")

            # Diminishing-returns exit (BEYOND the reference, which burns
            # the remaining iterations to its 100 cap): the per-iteration
            # gap contraction of this method is bounded by
            # (1 - 1/sqrt(sum_dims)), so once the relative gap is already
            # two orders inside the DIMACS acceptance gate (1e-2, ref
            # hdsdp.c:905-921) and contraction has flattened to near that
            # bound, further refinement buys nothing the gate can
            # measure.  Exit cleanly with the refined X; the gate decides.
            gap_rel = ipm.comp / (abs(ipm.p_obj_val) + abs(ipm.d_obj_val) + 1.0)
            # "slow" means slower than halfway between the method's
            # theoretical per-iteration contraction bound
            # (1 - 1/sqrt(sum_dims)) and 1: at large blocks the bound
            # itself approaches 1, and a fixed 0.95 misclassifies
            # healthy geometric contraction as a stall (observed at
            # m=25,001/n=700: flatten fired at rel gap 6.3e-05 while
            # contraction sat exactly at the 0.962 bound)
            slow_thresh = 0.5 * (1.0 + (1.0 - 1.0 / np.sqrt(sum_dims)))
            n_slow = n_slow + 1 if compl > slow_thresh * comp_prev else 0
            if n_slow >= 8 and gap_rel < 1e-04:
                ipm.log.info(
                    "Primal refinement has flattened inside the DIMACS "
                    f"gate (rel gap {gap_rel:.1e}); stopping early."
                )
                break
            comp_prev = compl

        self.X = X
        return True
