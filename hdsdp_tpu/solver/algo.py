"""Three-phase dual interior-point method.

Faithful re-derivation of the reference algorithm layer
(ref interface/hdsdp_algo.c):

  Phase A  infeasible-start dual IPM     HDSDP_PhaseA_BarInfeasSolve (:960)
  Phase A' self-dual embedding           HDSDP_PhaseA_BarHsdSolve    (:355)
  Phase B  dual potential reduction      HDSDP_PhaseB_BarDualPotentialSolve (:1658)
  correctors                             (:777, :1481)
  proximity + primal bound recovery      HDSDP_ProxMeasure (:548)

State layout: the dual iterate is (y, tau, Rd, mu); dual slacks per cone are
S = -Rd*I - A'y + tau*C (+ perturb*I).  The scalar bound cone l <= y <= u is
implicit (ref hdsdp.c:675-690, hdsdp_conic_bound.c) and participates in
Phase A / B but not in the HSD method (ref hdsdp_algo.c:207-209, 440).

Control flow runs on host (30-60 outer iterations); all heavy math is in
jitted cone-system functions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.ops import chol as chol_ops
from hdsdp_tpu.ops.ratio import vector_ratio_test
from hdsdp_tpu.solver import memory
from hdsdp_tpu.solver.cones import ConeSystem
from hdsdp_tpu.solver.params import Params, adjust_params
from hdsdp_tpu.utils.log import Logger

INF = 1e30

# statuses (ref hdsdp.h:44-57)
UNKNOWN = "UNKNOWN"
DUAL_FEASIBLE = "DUAL_FEASIBLE"
DUAL_OPTIMAL = "DUAL_OPTIMAL"
PRIMAL_DUAL_OPTIMAL = "PRIMAL_DUAL_OPTIMAL"
MAXITER = "MAXITER"
SUSPECT_INFEAS_OR_UNBOUNDED = "SUSPECT_INFEAS_OR_UNBOUNDED"
INFEAS_OR_UNBOUNDED = "INFEAS_OR_UNBOUNDED"
TIMELIMIT = "TIMELIMIT"
NUMERICAL = "NUMERICAL"
INTERNAL = "INTERNAL_ERROR"
USER_INTERRUPT = "USER_INTERRUPT"


@dataclass
class Maker:
    mu: float = -1.0
    y: Optional[jnp.ndarray] = None
    dy: Optional[jnp.ndarray] = None


class DualIPM:
    """Driver owning the IPM state (ref struct hdsdp, def_hdsdp.h:60-143)."""

    def __init__(self, prob: SDPProblem, params: Params, mesh=None):
        self.prob = prob
        self.params = params
        self.f = prob.features
        adjust_params(params, self.f)

        self.m = prob.m
        self.dtype = jnp.float64 if params.dtype == "float64" else jnp.float32

        # scaling (ref hdsdp.c:314-320): C *= objScal, b *= rhsScal
        self.obj_scal = self.f.obj_scaling
        self.rhs_scal = self.f.rhs_scaling
        self.mesh = mesh
        if mesh is not None:
            from hdsdp_tpu.parallel.schur import (
                RowShardedConeSystem,
                ShardedConeSystem,
            )

            if all(g.nblk == 1 for g in prob.groups):
                # constraint-row-sharded assembly: M born sharded, stays
                # sharded through the distributed Cholesky / CG
                self.cones = RowShardedConeSystem(
                    prob, mesh, obj_scal=self.obj_scal, dtype=self.dtype
                )
            else:
                self.cones = ShardedConeSystem(
                    prob, mesh, obj_scal=self.obj_scal, dtype=self.dtype
                )
        else:
            self.cones = ConeSystem(prob, obj_scal=self.obj_scal, dtype=self.dtype)
        self.cones.ratio_mode = params.ratio_test
        self.cones.lanczos_dim = params.lanczos_dim
        # driver and Schur mode, decided once (solver.memory.plan).
        # Schur mode "free" is the matrix-free operator (sparse-Schur
        # analogue, ref hdsdp_schur.c:60,227): M never materializes;
        # solves are Jacobi-PCG on M v = A(S^-1 (sum_j v_j A_j) S^-1)
        self.driver, self.schur = memory.plan(
            self.m, self.f.n_max_cone_dim, self.f.n_sum_cone_dims, params,
            mesh=mesh is not None,
        )
        self.kkt_free = self.schur == "free"
        self._op_Us = None  # frozen S^-1 per group (solve operator)
        self._op_slp = None  # frozen LP slack at the full build
        self._op_bound = None  # bound-cone diagonal [m]
        self._op_diag = None  # exact diag(M) incl. bound
        self._op_reg = 0.0
        self._op_pc = None  # (L32, s): stale chol preconditioner
        self._op_escalated = None  # direct factor from a CG stall
        self.b = jnp.asarray(prob.b * self.rhs_scal, self.dtype)

        # bound cone box (ref hdsdp.c:675-690)
        self.bound_lo = params.dual_box_low
        self.bound_up = params.dual_box_up

        # sum of cone dims + 2*m for the box (ref hdsdp.c:55)
        self.all_cone_dims = float(self.cones.sum_cone_dims + 2 * self.m)

        # iterate (y0 = optional dual warm start, ref HDSDPSetDualStart)
        self.y0 = None
        self.y = jnp.zeros((self.m,), self.dtype)
        self.tau = 1.0
        self.Rd = 0.0  # scalar dual residual (negative)
        self.mu = 1e+10
        self.perturb = 0.0
        self.p_obj_internal = params.p_obj_start
        self.d_obj_internal = 0.0
        self.p_infeas = 1.0
        self.prox_norm = 0.0
        self.d_step = 0.0
        self.comp = INF
        self.p_obj_val = INF
        self.d_obj_val = 0.0
        self.obj_improve = 0.0

        self.n_iter = 0
        self.n_small_step = 0
        self.status = UNKNOWN
        self.which_method = "infeas"
        self.time_begin = time.time()

        # current factors / buffers
        self.S = None
        self.s_lp = None
        self.L = None
        self.Lchk = None
        self.Schk = None
        self.s_lp_chk = None
        self.dS = None
        self.ds_lp = None
        # bound cone slack vectors
        self.sl = None
        self.su = None
        self.dsl = None
        self.dsu = None
        self.sl_chk = None
        self.su_chk = None

        # KKT exports (device)
        self.kkt = None
        self.Mfac = None  # Cholesky factor of the Schur matrix
        self.d1 = None  # M^-1 b
        self.d2 = None  # M^-1 ASinv
        self.d3 = None  # M^-1 ASinvRdSinv
        self.d4 = None  # M^-1 ASinvCSinv

        # primal solution makers (ref def_hdsdp.h:107-118)
        self.maker_acc = Maker()
        self.maker_inacc = Maker()

        self.log = Logger(enabled=params.verbose)
        self._factor_stats = {"n_factor": 0, "n_solve": 0, "n_kkt": 0}

        self.region = None
        if params.profile:
            self._install_profiler()

    def _install_profiler(self) -> None:
        """Wrap the hot stages in wall-clock regions (utils.profile.Region,
        ref HDSDP_CODE_PROFILER_START/END hdsdp_utils.h:55-70).  Each
        wrapper blocks on the stage's device outputs so the accumulators
        attribute async dispatch time to the stage that issued it."""
        import functools

        from hdsdp_tpu.utils.profile import Region

        self.region = Region()

        def wrap(name):
            fn = getattr(self, name)

            @functools.wraps(fn)
            def timed(*a, **kw):
                with self.region(name):
                    out = fn(*a, **kw)
                    if out is not None:
                        jax.block_until_ready(out)
                    elif name == "factor_kkt" and self.Mfac is not None:
                        jax.block_until_ready(self.Mfac[1])
                    return out

            setattr(self, name, timed)

        for name in (
            "build_kkt",
            "factor_kkt",
            "solve_kkt",
            "solve_kkt_multi",
            "prox_measure",
            "ratio_test",
            "adaptive_resi_rate",
            "infeasible_corrector",
            "feasible_corrector",
            "reduce_potential",
            "check_is_interior",
            "primal_infeas_check",
            "choose_barrier",
            "set_step",
        ):
            wrap(name)

    # ------------------------------------------------------------------
    # bound cone helpers (ref hdsdp_conic_bound.c)
    # ------------------------------------------------------------------
    def _bound_slacks(self, tau, y):
        sl = y - tau * self.bound_lo
        su = tau * self.bound_up - y
        return sl, su

    def _bound_step(self, dtau, dy):
        """dsl, dsu for direction (dtau, dy) (ref sBoundConeIUpdateBuffer)."""
        dsu = dtau * self.bound_up - dy
        dsl = dy - dtau * self.bound_lo
        return dsl, dsu

    def _bound_ratio(self, sl, su, dsl, dsu):
        s = jnp.concatenate([sl, su])
        ds = jnp.concatenate([dsl, dsu])
        return vector_ratio_test(s, ds)

    # ------------------------------------------------------------------
    # interior checks (ref HDSDP_CheckIsInterior, hdsdp_algo.c:196-216)
    # ------------------------------------------------------------------
    def check_is_interior(self, tau, y, with_bound=True) -> bool:
        """Assemble S at (tau, y) with the current Rd/perturb and factor."""
        from hdsdp_tpu.solver.cones import _interior_check

        S, s_lp, L, sl, su, flags = _interior_check(
            self.cones.groups, self.cones.lp, tau, -1.0, y,
            -self.Rd + self.perturb, tau, self.bound_lo, self.bound_up,
        )
        ok, bound_ok = (bool(v) for v in np.asarray(flags))
        if ok:
            self.S, self.s_lp, self.L = S, s_lp, L
        interior = ok
        if with_bound and self.which_method != "hsd":
            if bound_ok:
                self.sl, self.su = sl, su
            interior = interior and bound_ok
        return interior

    def check_expert_chk(self, dC, scal, vec, dEye, with_bound=True) -> bool:
        """Assemble the checker buffer and PSD-check it (BUFFER_DUALCHECK)."""
        S, s_lp = self.cones.assemble(dC, scal, vec, dEye + self.perturb)
        ok, L = self.cones.factor(S, s_lp)
        self.Schk, self.s_lp_chk, self.Lchk = S, s_lp, L
        interior = bool(ok)
        if with_bound:
            # bound cone expert check (ref sBoundConeInteriorCheckExpert)
            su = dC * self.bound_up + scal * vec
            sl = -dC * self.bound_lo - scal * vec
            self.sl_chk, self.su_chk = sl, su
            interior = interior and bool(jnp.all(sl > 0) & jnp.all(su > 0))
        return interior

    def logdet_cur(self) -> float:
        """-sum log det over cones at the current DUALVAR factors, negated
        (ref HDSDP_GetLogBarrier, hdsdp_algo.c:218-239 returns -logdet)."""
        val = self.cones.logdet(self.L, self.s_lp)
        if self.which_method != "hsd":
            val = val + jnp.sum(jnp.log(self.sl)) + jnp.sum(jnp.log(self.su))
        return -float(val)

    # ------------------------------------------------------------------
    # KKT assembly / factor / solve
    # ------------------------------------------------------------------
    def build_kkt(self, kind: str):
        """BuildUp + bound-cone extra + regularize + factor + solves.

        kind: "inf" | "hsd" | "corr" (ref KKT_TYPE_*, hdsdp_conic.h:16-19).
        """
        self._factor_stats["n_kkt"] += 1
        if self.kkt_free:
            return self._build_kkt_operator(kind)
        kkt = self.cones.build_kkt(self.L, self.s_lp, self.Rd, kind)
        asinv = kkt.asinv
        M = kkt.M

        if self.which_method != "hsd":
            # bound cone contribution (ref sBoundConeGetKKT,
            # hdsdp_conic_bound.c:201-248)
            li = 1.0 / self.sl
            ui = 1.0 / self.su
            asinv = asinv + ui - li
            if kind != "corr":
                d = li * li + ui * ui
                if M.shape[0] != self.m:  # row-sharded padded M
                    d = jnp.pad(d, (0, M.shape[0] - self.m))
                M = M + jnp.diag(d)

        self.kkt = kkt._replace(M=M, asinv=asinv)
        return self.kkt

    def _build_kkt_operator(self, kind: str):
        """Matrix-free KKT build: RHS vectors + frozen solve operator.

        A full build ("inf"/"hsd") refreshes the operator state (S^-1
        per group, LP slack, bound diagonal, exact Jacobi diag); a
        corrector build refreshes the RHS only and keeps solving against
        the previously frozen operator — exactly the reference's
        reuse-the-factorized-M corrector semantics
        (ref HKKTBuildUp KKT_TYPE_CORRECTOR, hdsdp_schur.c:256-268)."""
        Us = self.cones.inverses(self.L)
        kkt = self.cones.build_kkt_rhs(Us, self.s_lp, self.Rd, kind)
        asinv = kkt.asinv
        bound = jnp.zeros((self.m,), self.dtype)
        if self.which_method != "hsd":
            li = 1.0 / self.sl
            ui = 1.0 / self.su
            asinv = asinv + ui - li
            bound = li * li + ui * ui
        if kind != "corr":
            self._op_Us = Us
            self._op_slp = self.s_lp
            self._op_bound = bound
            self._op_reg = 0.0
            self._op_diag = self.cones.kkt_diag(Us, self.s_lp) + bound
            self._op_escalated = None  # new operator: drop any stale factor
        self.kkt = kkt._replace(asinv=asinv)
        return self.kkt

    def regularize_kkt(self, reg_coef: float):
        """ref HKKTRegularize (hdsdp_schur.c:348-373)."""
        if self.kkt_free:
            if self._op_diag is None:
                return
            min_diag = float(jnp.min(self._op_diag))
            reg = min(reg_coef * min_diag, 1e-05)
            self._op_reg = reg if reg >= 1e-14 else 0.0
            return
        if self.kkt.M is None:
            return
        min_diag = float(jnp.min(jnp.diag(self.kkt.M)[: self.m]))
        reg = min(reg_coef * min_diag, 1e-05)
        if reg < 1e-14:
            reg = 0.0
        if reg:
            mk = self.kkt.M.shape[0]
            M = self.kkt.M + reg * jnp.eye(mk, dtype=self.dtype)
            self.kkt = self.kkt._replace(M=M)

    def materialize_cap(self) -> int:
        """Largest m for which a dense M may be materialized in operator
        mode (Params.op_materialize_cap, else from the device memory)."""
        cap = self.params.op_materialize_cap
        return memory.dense_m_cap() if cap is None else cap

    def _direct_factor(self, M) -> None:
        """Cholesky with a regularization ladder + LU fallback (the direct
        analogue of the CG -> LDL switch, ref hdsdp_linsolver.c:1827-1857)."""
        self.Mfac = self._f64_factor_ladder(M)

    def _f64_factor_ladder(self, M):
        """f64 Cholesky + regularization ladder + LU fallback, returned
        as an Mfac tuple."""
        L = jnp.linalg.cholesky(M)
        if bool(jnp.all(jnp.isfinite(L))):
            return ("chol", L)
        base = float(jnp.max(jnp.diag(M))) * 1e-14 + 1e-300
        for k in range(6):
            reg = base * (10.0 ** (2 * k))
            L = jnp.linalg.cholesky(
                M + reg * jnp.eye(M.shape[0], dtype=self.dtype)
            )
            if bool(jnp.all(jnp.isfinite(L))):
                return ("chol", L)
        return ("lu", jax.scipy.linalg.lu_factor(M))

    def _row_sharded(self) -> bool:
        return getattr(self.cones, "is_row_sharded", False)

    def factor_kkt(self, force_direct: bool = False) -> None:
        """Factor (or defer) the Schur system.  In Schur mode "cg" the
        factorization is deferred: solves go through AdaptiveCG (ref
        conjGradSolve + ADPCG policy) and escalate to the direct ladder on
        CG failure.  On a row-sharded mesh the factorization is the
        distributed blocked Cholesky (parallel.dchol) or row-sharded CG:
        M never materializes on one device.

        ``force_direct`` overrides the CG policy for factor-once /
        solve-many uses (PSDP factors its X-weighted KKT once and then
        performs ~100 solves against it, ref hdsdp_psdp.c:203-207 —
        exact solves there decide the refinement step quality)."""
        self._factor_stats["n_factor"] += 1
        if self.kkt_free:
            # nothing to factor: solves run Jacobi-PCG on the frozen
            # operator state (see _build_kkt_operator)
            self.Mfac = ("opcg", None)
            return
        M = self.kkt.M
        use_cg = not force_direct and self.schur == "cg"
        if self._row_sharded():
            if use_cg:
                self.Mfac = ("shcg", M)
                return
            from hdsdp_tpu.parallel.dchol import sharded_cholesky

            fac = sharded_cholesky(self.mesh, M)
            if not bool(fac.ok):
                # regularization ladder, sharded (ref ladder semantics)
                base = float(jnp.max(jnp.diag(M))) * 1e-14 + 1e-300
                for k in range(6):
                    reg = base * (10.0 ** (2 * k))
                    fac = sharded_cholesky(
                        self.mesh,
                        M + reg * jnp.eye(M.shape[0], dtype=self.dtype),
                    )
                    if bool(fac.ok):
                        break
            self.Mfac = ("shchol", fac)
            return
        if use_cg:
            if not hasattr(self, "_cg"):
                from hdsdp_tpu.ops.cg import AdaptiveCG

                self._cg = AdaptiveCG(abs_tol=1e-10, rel_tol=1e-10)
            self._cg.update(M)
            self.Mfac = ("cg", M)
            return
        self._direct_factor(M)

    def release_solve_buffers(self) -> None:
        """Drop per-iteration device buffers before the final DIMACS
        check.  At torus-22 scale (m = n = 10648) the held S / L /
        checker / step / Schur buffers total ~6 GB and the recovery
        program's runtime peak no longer fits beside them (observed
        ResourceExhausted); everything the check and the public API need
        is recomputed from (y, makers, cone data)."""
        self.S = self.s_lp = self.L = None
        self.Schk = self.s_lp_chk = self.Lchk = None
        self.dS = self.ds_lp = None
        self.kkt = None
        self.Mfac = None
        self.d1 = self.d2 = self.d3 = self.d4 = None
        self._op_Us = self._op_diag = self._op_bound = self._op_slp = None
        self._op_escalated = None
        self._op_pc = None
        if hasattr(self, "_cg"):
            # keep the engagement evidence (the live object holds a
            # stale [m, m] preconditioner) — read by tests/benchmarks
            self._factor_stats["cg_n_factor"] = self._cg.n_factor
            self._factor_stats["cg_n_solve"] = self._cg.n_solve
            self._factor_stats["cg_summary"] = self._cg.summary()
            del self._cg
        if hasattr(self.cones, "_lz_warm"):
            self.cones._lz_warm = None

    def _build_chunked_precond(self, Us, slp, extra, diag):
        """Materialize an equilibrated f32 copy of the operator M (given
        scaling operands Us — S^-1 for the dual system, X for PSDP's) in
        row chunks and return its f32 Cholesky factor (L32, s), or
        None.  No f64 m x m ever exists; each chunk is a small program
        that compiles at sizes where the monolithic build wedges the
        remote pipeline (m = 25001, r4)."""
        import time as _time

        t0 = _time.time()
        p = self.params
        m = self.m
        s = 1.0 / jnp.sqrt(jnp.maximum(diag, 1e-300))
        chunk = min(p.op_precond_chunk, m)
        i0s = list(range(0, m - chunk + 1, chunk))
        if not i0s or i0s[-1] + chunk < m:
            i0s.append(m - chunk)  # final (possibly overlapping) chunk
        Ms = jnp.zeros((m, m), jnp.float32)
        for i0 in i0s:
            rows = self.cones.kkt_rows(Us, slp, extra, i0, chunk)
            sr = jax.lax.dynamic_slice_in_dim(s, i0, chunk)
            rows32 = (sr[:, None] * rows * s[None, :]).astype(jnp.float32)
            Ms = jax.lax.dynamic_update_slice(Ms, rows32, (i0, 0))
        from hdsdp_tpu.ops.cg import factor_scaled_f32

        eye = None
        for dl in (0.0, 1e-06, 1e-04, 1e-02):
            # the equilibrated M has unit diagonal, so dl is a RELATIVE
            # boost; a boosted factor still preconditions M well
            if dl:
                if eye is None:
                    eye = jnp.eye(m, dtype=jnp.float32)
                L32, ok = factor_scaled_f32(Ms + dl * eye)
            else:
                L32, ok = factor_scaled_f32(Ms)
            if bool(ok):
                self._factor_stats["op_pc_builds"] = (
                    self._factor_stats.get("op_pc_builds", 0) + 1
                )
                self.log.info(
                    f"operator f32 preconditioner refreshed "
                    f"(boost {dl:g}, {_time.time() - t0:.1f}s)"
                )
                return (L32, s)
        self.log.warning("operator f32 preconditioner factor failed (NaN)")
        return None

    def _op_build_precond(self) -> bool:
        pc = self._build_chunked_precond(
            self._op_Us, self._op_slp,
            self._op_bound + self._op_reg,
            self._op_diag + self._op_reg,
        )
        self._op_pc = pc
        if pc is None:
            self._op_pc_unavailable = True
        return pc is not None

    def _op_solve(self, B: jnp.ndarray):
        """CG solve of M X = B on the matrix-free operator.

        Tier 0 (round 5): Cholesky-preconditioned CG against a stale,
        chunk-materialized f32 factor of M (ADPCG policy:
        refresh on iteration regret or failure) — the factorization-
        grade endgame the Jacobi path lacked (VERDICT r4 #4).

        Fallback ladder (≙ the reference's CG -> dense-LDL switch,
        hdsdp_linsolver.c:1827-1857):

          1. Jacobi-PCG at kkt_free_maxiter,
          2. on stall: continue the same CG 4x longer (warm from X),
          3. still stalled and m small enough to afford a dense M once:
             materialize M via the dense build, direct-ladder factor,
             and solve every remaining system this KKT round against it.
        """
        def pcg(B0, max_iter):
            extra = self._op_bound + self._op_reg
            diag = self._op_diag + self._op_reg
            pinv = 1.0 / jnp.maximum(diag, 1e-300)
            X, res, n_it = self.cones.kkt_pcg(
                self._op_Us, self._op_slp, extra, pinv, B0,
                abs_tol=1e-10, rel_tol=1e-10, max_iter=max_iter,
            )
            self._factor_stats["opcg_iters"] = (
                self._factor_stats.get("opcg_iters", 0) + int(n_it)
            )
            worst = float(
                jnp.max(res / jnp.maximum(jnp.linalg.norm(B0, axis=0), 1.0))
            )
            return X, worst

        if getattr(self, "_op_escalated", None) is not None:
            # a direct factor from a previous stall this KKT round:
            # keep solving against it (factor-once / solve-many)
            return self._solve_escalated(B)

        def pcg_chol(B0, max_iter):
            extra = self._op_bound + self._op_reg
            L32, s = self._op_pc
            X, res, n_it = self.cones.kkt_pcg_chol(
                self._op_Us, self._op_slp, extra, L32, s, B0,
                abs_tol=1e-10, rel_tol=1e-10, max_iter=max_iter,
            )
            self._factor_stats["opcg_iters"] = (
                self._factor_stats.get("opcg_iters", 0) + int(n_it)
            )
            worst = float(
                jnp.max(res / jnp.maximum(jnp.linalg.norm(B0, axis=0), 1.0))
            )
            return X, worst, int(n_it)

        use_pc = (
            self.m <= memory.dense_m_cap()
            and self.mesh is None
            and not getattr(self, "_op_pc_unavailable", False)
            and self.cones.kkt_rows_supported()
        )
        # tier 0: once engaged (a previous Jacobi solve was inadequate),
        # the stale chol factor carries every subsequent system — the
        # ADPCG diag -> Cholesky escalation that STAYS escalated
        if use_pc and getattr(self, "_op_pc_refresh", False):
            # iteration-regret refresh was requested on the previous
            # system: rebuild now (NOT dropping back to Jacobi first)
            self._op_pc_refresh = False
            self._op_build_precond()
        if use_pc and getattr(self, "_op_pc", None) is not None:
            X, worst, n_it = pcg_chol(B, self.params.kkt_free_maxiter)
            if worst <= 1e-06:
                if n_it > self.params.op_precond_refresh_iters:
                    # ADPCG iteration-regret rule: converged but slowly —
                    # refresh before the next system
                    self._op_pc = None
                    self._op_pc_refresh = True
                return X
            # stale factor underperformed: refresh now, retry once
            if self._op_build_precond():
                X, worst, n_it = pcg_chol(B, self.params.kkt_free_maxiter)
                if worst <= 1e-06:
                    return X
            self.log.info(
                f"operator chol-PCG stalled (rel {worst:.2e}); "
                "falling back to the Jacobi ladder"
            )

        X, worst = pcg(B, self.params.kkt_free_maxiter)
        if worst <= 1e-06:
            return X
        # Jacobi proved inadequate for this conditioning: escalate to
        # the chunk-materialized f32 Cholesky preconditioner before the
        # brute-force extension tiers
        if use_pc and getattr(self, "_op_pc", None) is None:
            if self._op_build_precond():
                Xc, worstc, _ = pcg_chol(B, self.params.kkt_free_maxiter)
                if worstc <= 1e-06:
                    return Xc
                if worstc < worst:
                    X, worst = Xc, worstc
        # tier 2: 4x budget as RESTARTED chunks of kkt_free_maxiter,
        # warm-started via residual correction between dispatches, so
        # every dispatch is the same size as tier 1.
        self.log.info(f"operator CG stalled (rel {worst:.2e}); extending")
        worst2 = worst
        bscale = jnp.maximum(jnp.linalg.norm(B, axis=0), 1.0)
        for _ in range(8):
            R = B - self.cones.kkt_matvec(
                self._op_Us, self._op_slp,
                self._op_bound + self._op_reg, X,
            )
            worst2 = float(jnp.max(jnp.linalg.norm(R, axis=0) / bscale))
            if worst2 <= 1e-06:
                return X
            dX, _ = pcg(R, self.params.kkt_free_maxiter)
            X = X + dX
        R = B - self.cones.kkt_matvec(
            self._op_Us, self._op_slp, self._op_bound + self._op_reg, X,
        )
        worst2 = float(jnp.max(jnp.linalg.norm(R, axis=0) / bscale))
        if worst2 <= 1e-06:
            return X
        # tier 3: materialize M once and direct-factor (only when a
        # dense m x m plus factor workspace plausibly fits).  The build
        # + factor go through the regular non-free machinery so the
        # mesh path (padded, row-sharded M -> distributed Cholesky)
        # composes too.  A compile/OOM failure is remembered: re-trying
        # the same doomed compile costs minutes per stall.
        if (
            self.m <= self.materialize_cap()
            and not getattr(self, "_op_mat_unavailable", False)
        ):
            self.log.info(
                f"operator CG stalled twice (rel {worst2:.2e}); "
                "materializing M for a direct factor"
            )
            self._factor_stats["op_escalations"] = (
                self._factor_stats.get("op_escalations", 0) + 1
            )
            saved_kkt, saved_fac, saved_free = self.kkt, self.Mfac, self.kkt_free
            try:
                kkt = self.cones.build_kkt(
                    self.L, self._op_slp, self.Rd, "inf"
                )
                d = self._op_bound + self._op_reg
                if kkt.M.shape[0] != self.m:  # row-sharded padded M
                    d = jnp.pad(d, (0, kkt.M.shape[0] - self.m))
                self.kkt = kkt._replace(M=kkt.M + jnp.diag(d))
                self.kkt_free = False
                self.factor_kkt(force_direct=True)
                self._op_escalated = self.Mfac
            except RuntimeError as e:  # XlaRuntimeError (compile/OOM,
                # remote-helper failures) subclasses RuntimeError; a
                # genuine programming error (shape/type) propagates.
                # The best CG iterate (rel ~1e-5 here) is still a usable
                # step — the IPM self-corrects and the final DIMACS
                # check re-solves its own consistent system
                import traceback

                self.log.warning(
                    "materialized escalation unavailable; returning best "
                    "CG iterate\n"
                    + "".join(
                        traceback.format_exception(type(e), e, e.__traceback__)
                    )[-800:]
                )
                self._op_escalated = None
                self._op_mat_unavailable = True
                return X
            finally:
                self.kkt, self.Mfac, self.kkt_free = (
                    saved_kkt, saved_fac, saved_free,
                )
            return self._solve_escalated(B)
        self.log.info(
            f"operator CG stalled (rel {worst2:.2e}); m too large to "
            "materialize M — returning best iterate"
        )
        return X

    def _solve_escalated(self, B: jnp.ndarray):
        saved = self.Mfac
        self.Mfac = self._op_escalated
        n0 = self._factor_stats["n_solve"]
        try:
            if B.shape[1] == 1:
                return self.solve_kkt(B[:, 0])[:, None]
            return jnp.stack(
                self.solve_kkt_multi([B[:, i] for i in range(B.shape[1])]),
                axis=1,
            )
        finally:
            # the originating opcg solve already counted these rhs; the
            # inner solve_kkt* calls must not count them again
            self._factor_stats["n_solve"] = n0
            self.Mfac = saved

    def solve_kkt(self, rhs: jnp.ndarray) -> jnp.ndarray:
        self._factor_stats["n_solve"] += 1
        kind, fac = self.Mfac
        if kind == "opcg":
            return self._op_solve(rhs[:, None])[:, 0]
        if kind == "chol":
            return chol_ops.chol_solve(fac, rhs)
        if kind == "shchol":
            from hdsdp_tpu.parallel.dchol import sharded_chol_solve

            pad = fac.m - self.m  # fac.m is the padded KKT size
            x = sharded_chol_solve(fac, jnp.pad(rhs, (0, pad)) if pad else rhs)
            return x[: self.m]
        if kind == "shcg":
            from hdsdp_tpu.parallel.cg import sharded_pcg

            pad = fac.shape[0] - self.m
            x, _ = sharded_pcg(self.mesh, fac,
                               jnp.pad(rhs, (0, pad)) if pad else rhs,
                               abs_tol=1e-10, rel_tol=1e-10)
            return x[: self.m]
        if kind == "cg":
            x, ok = self._cg.solve_checked(fac, rhs)
            if ok:
                return x
            # CG failed even with a fresh Cholesky preconditioner:
            # escalate to the direct ladder (ref hdsdp_linsolver.c:1827-1857)
            self._direct_factor(fac)
            return self.solve_kkt(rhs)
        return jax.scipy.linalg.lu_solve(fac, rhs)

    def solve_kkt_multi(self, rhs_list):
        """Batch several right-hand sides into one dispatch."""
        kind, fac = self.Mfac
        if kind == "opcg":
            self._factor_stats["n_solve"] += len(rhs_list)
            X = self._op_solve(jnp.stack(rhs_list, axis=1))
            return [X[:, i] for i in range(len(rhs_list))]
        if kind == "shchol":
            from hdsdp_tpu.parallel.dchol import sharded_chol_solve

            self._factor_stats["n_solve"] += len(rhs_list)
            rhs = jnp.stack(rhs_list, axis=1)
            pad = fac.m - self.m
            if pad:
                rhs = jnp.pad(rhs, ((0, pad), (0, 0)))
            sols = sharded_chol_solve(fac, rhs)[: self.m]
            return [sols[:, i] for i in range(len(rhs_list))]
        if kind == "chol":
            self._factor_stats["n_solve"] += len(rhs_list)
            sols = chol_ops.chol_solve(fac, jnp.stack(rhs_list, axis=1))
            return [sols[:, i] for i in range(len(rhs_list))]
        if kind == "cg":
            self._factor_stats["n_solve"] += len(rhs_list)
            X, ok = self._cg.solve_mat_checked(fac, jnp.stack(rhs_list, axis=1))
            if ok:
                return [X[:, i] for i in range(len(rhs_list))]
            self._direct_factor(fac)
        return [self.solve_kkt(r) for r in rhs_list]

    # ------------------------------------------------------------------
    # step assembly + ratio tests
    # ------------------------------------------------------------------
    def set_step(self, dtau, dy, gamma):
        """dS = gamma*Rd*I - A'dy + C*dtau (ref sdpDenseConeRatioTestImpl)."""
        dS, ds_lp = self.cones.assemble(dtau, -1.0, dy, gamma * self.Rd)
        self.dS, self.ds_lp = dS, ds_lp
        self.dsl, self.dsu = self._bound_step(dtau, dy)

    def ratio_test(self, dtau, dy, gamma, buffer: str, with_bound=True) -> float:
        self.set_step(dtau, dy, gamma)
        L = self.L if buffer == "dual" else self.Lchk
        s = self.s_lp if buffer == "dual" else self.s_lp_chk
        step = float(self.cones.ratio_test(L, s, self.dS, self.ds_lp))
        if with_bound and self.which_method != "hsd":
            sl = self.sl if buffer == "dual" else self.sl_chk
            su = self.su if buffer == "dual" else self.su_chk
            step_b = float(self._bound_ratio(sl, su, self.dsl, self.dsu))
            step = min(step, step_b)
        return step

    def add_step_to_checker(self, alpha) -> bool:
        """checker = dualvar + alpha * dstep, then PSD check
        (ref HConeAddStepToBufferAndCheck)."""
        ok, S, s, L = self.cones.add_step_check(
            self.S, self.s_lp, self.dS, self.ds_lp, alpha
        )
        self.Schk, self.s_lp_chk, self.Lchk = S, s, L
        interior = bool(ok)
        if self.which_method != "hsd":
            sl = self.sl + alpha * self.dsl
            su = self.su + alpha * self.dsu
            self.sl_chk, self.su_chk = sl, su
            interior = interior and bool(jnp.all(sl > 0) & jnp.all(su > 0))
        return interior

    # ------------------------------------------------------------------
    # starting points (ref HDSDP_SetStart / HDSDP_ResetStart)
    # ------------------------------------------------------------------
    def set_start(self, method: str, d_only: bool):
        self.y = (
            self.y0 if self.y0 is not None else jnp.zeros((self.m,), self.dtype)
        )
        self.tau = 1.0
        obj_fro = max(self.f.obj_fro_norm * self.obj_scal, 100.0)
        if method == "hsd":
            self.mu = 1e+08
            if d_only:
                self.Rd = -obj_fro * self.params.dual_slack_start
            else:
                self.Rd = -obj_fro * 1e+01
        else:
            self.Rd = -obj_fro * self.params.dual_slack_start
            self.p_infeas = 1.0 + self.f.rhs_fro_norm
            self.p_obj_internal = self.params.p_obj_start
            self.mu = (
                self.p_obj_internal
                - self.d_obj_internal
                - self.Rd * self.params.trx_estimate
            ) / self.all_cone_dims
        self.log.info(f"Initialize with dual residual {-self.Rd:3.1e}")

    def reset_start(self):
        self.y = jnp.zeros((self.m,), self.dtype)
        self.tau = 1.0
        self.p_obj_internal = 1e+15
        rd = -max(self.f.obj_fro_norm, 1e+02) * 1e+06
        self.Rd = max(rd, -1e+15)
        self.log.info(f"Reset with dual residual {-self.Rd:3.1e}")

    # ------------------------------------------------------------------
    # proximity measure + primal bound (ref HDSDP_ProxMeasure, :548-665)
    # ------------------------------------------------------------------
    def prox_measure(self) -> int:
        mu = self.mu
        p_obj_new = self.d_obj_internal
        acc = self.params.prec_ord_acc

        def trace(event, **kw):
            # diagnostic breadcrumb trail of maker recording decisions
            # (read by benchmarks/acc_probe.py; negligible host cost)
            if not hasattr(self, "_maker_trace"):
                self._maker_trace = []
            self._maker_trace.append(dict(it=self.n_iter, mu=mu, ev=event, **kw))

        dy1 = self.d1 / mu - self.d2
        v2 = self.b / mu - self.kkt.asinv
        prox2 = float(dy1 @ v2)
        if prox2 < 0.0:
            self.prox_norm = 1.0
            trace("prox2<0", prox2=prox2)
            return 0
        self.prox_norm = float(np.sqrt(prox2))

        # primal feasibility: B = -Rd*I + A'(dy1 - y) + C  PSD?
        vec = dy1 - self.y
        # bound cone first (ref :582-583), then SDP/LP cones
        su = self.bound_up + vec
        sl = -self.bound_lo - vec
        self.sl_chk, self.su_chk = sl, su
        feas = bool(jnp.all(sl > 0) & jnp.all(su > 0))
        if feas:
            feas = self.check_expert_chk(1.0, 1.0, vec, -self.Rd, with_bound=False)
            self.sl_chk, self.su_chk = sl, su
        if not feas:
            trace("checker_infeasible")
            return 0

        # relative gap estimate (ref :593-610)
        if self.which_method == "infeas":
            rel_gap = float(dy1 @ (self.kkt.asinvrdsinv + self.kkt.asinv))
            rel_gap += float(self.kkt.trace_sinv) * self.Rd
        else:
            rel_gap = float(dy1 @ self.kkt.asinv)
        rel_gap += self.all_cone_dims
        p_obj_new += rel_gap * mu

        if rel_gap < 0:
            trace("rel_gap<0", rel_gap=rel_gap)
            return -1 if rel_gap < -1.0 else 0

        self.p_obj_internal = p_obj_new
        inacc_tol = max(acc, 1e-04)  # (ref :626-627, second line overwrites)

        # primal infeasibility estimate via the bound cone
        # (ref sBoundConeGetPrimal, hdsdp_conic_bound.c:427-445)
        d = -dy1
        slc = self.y - self.bound_lo
        suc = self.bound_up - self.y
        xl = mu * (1.0 / slc - d / (slc * slc))
        xu = mu * (1.0 / suc + d / (suc * suc))
        p_inf = float(jnp.max(jnp.abs(xu - xl)))
        self.p_infeas = 0.0 if p_inf < 1e-16 else p_inf

        if p_inf < 1.0:
            thresh = abs(self.d_obj_internal) + 1.0
            if rel_gap * mu > inacc_tol * thresh:
                self.maker_inacc = Maker(mu=mu, y=self.y, dy=dy1)
                trace("inacc", gapmu=rel_gap * mu, thresh=thresh)
            elif rel_gap * mu > acc * thresh:
                self.maker_acc = Maker(mu=mu, y=self.y, dy=dy1)
                trace("acc", gapmu=rel_gap * mu, thresh=thresh)
            else:
                trace("below_acc", gapmu=rel_gap * mu, thresh=thresh)
        else:
            trace("p_inf>=1", p_inf=p_inf)
        return 1

    # ------------------------------------------------------------------
    # Phase A adaptive residual-reduction rate (ref :667-739)
    # ------------------------------------------------------------------
    def adaptive_resi_rate(self) -> float:
        # corrector-like ratio test with dy = -d2
        step = self.ratio_test(0.0, -self.d2, 0.0, "dual")
        alpha_c = min(0.98 * step, 1.0)
        max_step = alpha_c

        # line search on the checker buffer
        interior = False
        while not interior and alpha_c > 1e-02 * max_step:
            interior = self.add_step_to_checker(alpha_c)
            if not interior:
                alpha_c *= 0.8

        # ratio test for s' + alpha * (Rd - A' d3) on the checker
        # (bound cone excluded, ref :719-720 commented out)
        self.set_step(0.0, self.d3, 1.0)
        alpha_inf = float(
            self.cones.ratio_test(self.Lchk, self.s_lp_chk, self.dS, self.ds_lp)
        )

        rate = alpha_inf / alpha_c if alpha_c > 0 else 0.0
        rate = min(0.98 * rate, 1.0)
        if self.prox_norm < 1.0:
            rate = max(0.9, rate)
        elif self.prox_norm < 10.0:
            rate = max(0.3, rate)
        elif self.prox_norm < 50.0:
            rate = max(0.1, rate)
        return rate

    # ------------------------------------------------------------------
    # infeasible corrector (ref HDSDP_Infeasible_Corrector, :777-958)
    # ------------------------------------------------------------------
    def infeasible_corrector(self) -> bool:
        n_max_corr = self.params.corrector_a
        if not self.check_is_interior(1.0, self.y):
            return False

        barrier = self.logdet_cur()
        ratio_max = 0.8

        for _ in range(n_max_corr):
            if self.Rd == 0.0:
                break

            self.build_kkt("corr")
            d2 = self.solve_kkt(self.kkt.asinv)
            d3 = (
                self.solve_kkt(self.kkt.asinvrdsinv) if ratio_max else None
            )

            dy = -d2
            step = self.ratio_test(0.0, dy, 0.0, "dual")
            step = min(0.8 * step, 1.0)

            # guarantee feasibility
            while True:
                cand = self.y + step * dy
                interior = self.check_is_interior(1.0, cand)
                if not interior:
                    step *= 0.5
                if interior or step < 5e-03:
                    break

            if step < 5e-03:
                self.check_is_interior(1.0, self.y)
                break

            new_barrier = self.logdet_cur()
            if new_barrier > barrier:
                step *= 0.5
                cand = self.y + step * dy
                self.check_is_interior(1.0, cand)
                barrier = -INF

            alpha_c = step

            # reduce infeasibility: max step for S' + a*(Rd - A'd3)
            step2 = self.ratio_test(0.0, d3, 1.0, "dual")
            rate = min(1.0, ratio_max * (step2 / alpha_c))

            resi = self.Rd
            while True:
                self.Rd = resi * (1 - alpha_c * rate)
                cand = self.y + alpha_c * (rate * d3 - d2)
                if self.check_is_interior(1.0, cand):
                    break
                rate *= 0.8

            if alpha_c * rate < 5e-04:
                ratio_max = 0.0
            elif alpha_c * rate < 0.1:
                ratio_max *= 0.9
            if alpha_c * rate > 0.8:
                self.mu *= 0.8
                ratio_max = min(ratio_max * 2.0, 0.9)
            elif alpha_c * rate > 0.3:
                self.mu *= 0.95
                ratio_max = min(ratio_max * 2.0, 0.8)

            self.y = cand
            if ratio_max == 0.0:
                break
            barrier = new_barrier

        return True

    # ------------------------------------------------------------------
    # Phase A main loop (ref HDSDP_PhaseA_BarInfeasSolve, :960-1204)
    # ------------------------------------------------------------------
    def phase_a(self, d_only: bool = False):
        self.which_method = "infeas"
        p = self.params
        f = self.f
        allow_reset = not (f.many_cones or f.implied_trace or f.very_dense)
        feas_tol = max(p.abs_feas_tol, p.rel_feas_tol * (1 + f.obj_one_norm))
        feas_tol = feas_tol * self.obj_scal / np.sqrt(max(f.n_sum_cone_dims, 1))

        self.set_start("infeas", False)

        if not self.check_is_interior(self.tau, self.y):
            self.log.info("Initial point is not in the cone. Adding slack value.")
            self.reset_start()
            if not self.check_is_interior(self.tau, self.y):
                self.status = NUMERICAL
                return

        self.log.header("infeas")
        p_obj_found = 0

        while True:
            if self.n_iter == 3 and not p_obj_found and allow_reset:
                self.log.info("Increasing dual infeasibility")
                self.reset_start()
                if not self.check_is_interior(self.tau, self.y):
                    self.status = NUMERICAL
                    return

            self.build_kkt("inf")
            self.regularize_kkt(0.0)
            self.factor_kkt()
            self.d1, self.d2, self.d3 = self.solve_kkt_multi(
                [self.b, self.kkt.asinv, self.kkt.asinvrdsinv]
            )

            p_obj_type = self.prox_measure()
            if p_obj_type < 0:
                self.status = SUSPECT_INFEAS_OR_UNBOUNDED
            else:
                p_obj_found += p_obj_type

            if p_obj_type == 1 and self.prox_norm < 2.0:
                self.mu *= 0.7

            # barrier update by proximity thresholds (ref :1122-1138)
            target = (
                self.p_obj_internal
                - self.d_obj_internal
                - self.Rd * p.trx_estimate
            ) / (5.0 * self.all_cone_dims)
            if self.prox_norm < 1.0:
                self.mu *= 0.005
            elif self.prox_norm < 5.0:
                self.mu = max(self.mu * 0.01, target * 0.1)
            elif self.prox_norm < 10.0:
                self.mu = max(self.mu * 0.1, target * 0.8)
            else:
                self.mu = max(self.mu * 0.95, target)

            gamma = self.adaptive_resi_rate()

            # dy = d1/mu - d2 + gamma*d3 (ref HDSDP_Infeasible_BuildStep)
            dy = self.d1 / self.mu - self.d2 + gamma * self.d3

            step = self.ratio_test(0.0, dy, gamma, "dual")
            self.d_step = min(0.95 * step, 1.0)
            if self.d_step < 1e-03:
                self.n_small_step += 1

            self.y = self.y + self.d_step * dy
            self.Rd = self.Rd * (1.0 - gamma * self.d_step)

            if not self.infeasible_corrector():
                if self.status == SUSPECT_INFEAS_OR_UNBOUNDED:
                    break  # preserve SUSPECT: hand off to the HSD phase
                self.status = NUMERICAL
                return
            self.print_log("infeas")

            if abs(self.Rd) < feas_tol:
                self.status = DUAL_FEASIBLE
                break
            if self.n_small_step > 3:
                self.status = SUSPECT_INFEAS_OR_UNBOUNDED
                break
            if self.status == SUSPECT_INFEAS_OR_UNBOUNDED:
                break
            if time.time() - self.time_begin >= p.time_limit:
                self.status = TIMELIMIT
                break
            self.n_iter += 1
            if self.n_iter >= p.max_iter:
                self.status = MAXITER
                break

    # ------------------------------------------------------------------
    # logging (ref HDSDP_PrintLog, :152-194)
    # ------------------------------------------------------------------
    def print_log(self, method: str):
        pd_scal = 1.0 / (self.rhs_scal * self.obj_scal * self.tau)
        n_sum = max(self.f.n_sum_cone_dims, 1)
        self.d_infeas = np.sqrt(n_sum) * abs(self.Rd) / (self.rhs_scal * self.tau)
        self.d_obj_internal = float(self.b @ self.y)
        self.d_obj_val = self.d_obj_internal * pd_scal
        self.p_obj_val = self.p_obj_internal * pd_scal
        self.comp = self.p_obj_val - self.d_obj_val
        elapsed = time.time() - self.time_begin
        self.log.iter_row(
            method,
            self.n_iter + 1,
            self.p_obj_val,
            self.d_obj_val,
            self.d_infeas if method != "potential" else self.p_infeas,
            self.mu,
            self.d_step,
            self.tau if method == "hsd" else self.prox_norm,
            elapsed,
        )

    # ------------------------------------------------------------------
    # HSD method (ref HDSDP_PhaseA_BarHsdSolve, :355-546)
    # ------------------------------------------------------------------
    def hsd_solve(self, d_only: bool):
        self.which_method = "hsd"
        p = self.params
        f = self.f

        abs_opt = p.abs_opt_tol if d_only else 1e+20
        rel_opt = p.rel_opt_tol if d_only else 1e+20
        feas_tol = min(p.abs_feas_tol, p.rel_feas_tol * (1.0 + f.obj_one_norm))
        feas_tol = feas_tol * self.obj_scal / np.sqrt(max(f.n_sum_cone_dims, 1))
        abs_opt = abs_opt * 1e-04
        rel_opt = abs_opt * 1e-04  # (ref :401-402 quirk: derived from abs)

        if self.status == UNKNOWN:
            self.set_start("hsd", d_only)

        self.log.header("hsd")

        while True:
            if not self.check_is_interior(self.tau, self.y, with_bound=False):
                if self.n_iter == 0:
                    self.log.info("Initial point is not in the cone. Adding slack value.")
                    self.Rd *= 100.0
                    self.reset_start()
                    self.n_iter += 1
                    continue
                else:
                    self.status = NUMERICAL
                    return

            self.build_kkt("hsd")
            self.regularize_kkt(0.0)
            self.factor_kkt()
            self.d1, self.d2, self.d3, self.d4 = self.solve_kkt_multi(
                [self.b, self.kkt.asinv, self.kkt.asinvrdsinv,
                 self.kkt.asinvcsinv]
            )

            dtau, dy = self.hsd_build_step()

            # ratio test incl. tau (ref HDSDP_HSD_RatioTest, :316-353)
            max_step = INF
            if dtau != 0.0:
                t = self.tau / dtau
                if t < 0.0:
                    max_step = min(max_step, -t)
            step_c = self.ratio_test(dtau, dy, 1.0, "dual", with_bound=False)
            max_step = min(max_step, step_c)
            if max_step < 1e-02:
                self.n_small_step += 1
                if self.n_small_step > 2:
                    self.log.info("HDSDP stagnates at the cone boundary.")

            # step size ladder (ref :463-471)
            if max_step > 1.0:
                step = min(0.7 * max_step, 1.0)
            elif max_step > 0.5:
                step = min(0.5 * max_step, 1.0)
            elif max_step > 0.2:
                step = min(0.3 * max_step, 1.0)
            else:
                step = min(0.2 * max_step, 1.0)
            self.d_step = step

            self.print_log("hsd")

            self.tau += step * dtau
            self.y = self.y + step * dy
            self.Rd = self.Rd * (1.0 - step)

            # barrier reduction (ref :484-499)
            if self.mu > 1e-12:
                if step > 0.8 and self.tau > 1.0:
                    t = max(0.1 * self.mu, -0.1 * self.Rd / self.tau)
                else:
                    t = max(p.hsd_gamma * self.mu, -0.1 * self.Rd / self.tau)
                self.mu = min(self.mu, t)
            else:
                self.mu = min(self.mu, 0.8 * self.mu)

            if (
                abs(self.Rd) < feas_tol * self.tau
                and self.mu < abs_opt
                and self.mu < rel_opt * (1 + 2.0 * abs(self.d_obj_val))
                and abs(self.obj_improve) < 1e-05 * (abs(self.d_obj_internal) + 1.0)
            ):
                self.status = DUAL_OPTIMAL if d_only else DUAL_FEASIBLE
                break
            if self.tau <= 1e-10:
                self.status = SUSPECT_INFEAS_OR_UNBOUNDED
                break
            if time.time() - self.time_begin >= p.time_limit:
                self.status = TIMELIMIT
                break
            self.n_iter += 1
            if self.n_iter >= p.max_iter:
                self.status = MAXITER
                break

    def hsd_build_step(self):
        """ref HDSDP_HSD_BuildStep (:263-314)."""
        mu, tau = self.mu, self.tau
        b = self.b
        old_obj = self.d_obj_internal
        bty = float(b @ self.y)
        self.d_obj_internal = bty
        self.obj_improve = bty - old_obj

        dd1 = b - mu * self.kkt.asinvcsinv
        csinvcsinv = float(self.kkt.csinvcsinv)
        csinv = float(self.kkt.csinv)
        csinvrdsinv = float(self.kkt.csinvrdsinv)

        num = -bty + mu / tau + mu * (csinv - csinvrdsinv)
        den = mu * csinvcsinv + mu / (tau * tau)
        tau_over_mu = tau / mu
        num -= float(dd1 @ (self.d1 * tau_over_mu - self.d2 + self.d3))
        den += float(dd1 @ (self.d1 / mu + self.d4))

        dtau = 0.0 if abs(den) < 1e-12 else num / den
        dy = self.d1 * (tau + dtau) / mu + self.d4 * dtau - self.d2 + self.d3
        return dtau, dy

    # ------------------------------------------------------------------
    # Phase B (ref HDSDP_PhaseB_BarDualPotentialSolve, :1658-1851)
    # ------------------------------------------------------------------
    def phase_b(self):
        self.which_method = "potential"
        p = self.params
        f = self.f
        pd_scal = self.obj_scal * self.rhs_scal
        feas_tol = min(p.abs_feas_tol, p.rel_feas_tol * (1.0 + f.obj_one_norm))
        feas_tol = feas_tol * self.obj_scal / np.sqrt(max(f.n_sum_cone_dims, 1))

        if abs(self.Rd) > feas_tol:
            self.log.info(
                "Dual infeasibility from previous algorithm exceeds tolerance"
            )

        # perturbation absorbs the remaining residual (ref :1699-1708)
        self.perturb = -10.0 * self.Rd
        self.Rd = 0.0
        if self.perturb != 0.0:
            self.check_is_interior(1.0, self.y)

        p_obj_found = 0
        no_p_obj_found = 0
        force_detect = True
        n_internal = 0
        p_obj_start = self.p_obj_internal
        # PSDP is unconditionally available, as in the reference
        # (hdsdp_psdp.c:164-457): under operator mode the refiner either
        # materializes its X-weighted M once (factor-once/solve-many,
        # m <= op_materialize_cap) or runs its KKT through the matrix-
        # free Jacobi-PCG with X in place of S^-1 (round 5, VERDICT #7)
        use_psdp = p.psdp

        self.log.header("potential")

        while True:
            n_internal += 1
            if n_internal > 10:
                force_detect = False

            self.build_kkt("inf")
            if self.mu > 1.0:
                self.regularize_kkt(1e-06)
            self.factor_kkt()
            self.d1, self.d2 = self.solve_kkt_multi([self.b, self.kkt.asinv])

            p_obj_type = self.prox_measure()
            if p_obj_type < 0:
                self.status = SUSPECT_INFEAS_OR_UNBOUNDED
            else:
                p_obj_found += p_obj_type
                no_p_obj_found = 0 if p_obj_type else no_p_obj_found + 1

            if not self.choose_barrier(p_obj_type):
                self.status = NUMERICAL
                return

            dy = self.feasible_build_step()

            if self.primal_infeas_check(force_detect):
                self.log.info("HDSDP detects a dual improving ray")
                self.status = INFEAS_OR_UNBOUNDED
                break

            if not self.reduce_potential(dy):
                self.status = NUMERICAL
                return
            if self.d_step < 1e-03:
                self.n_small_step += 1

            self.feasible_corrector()
            self.print_log("potential")

            if (
                self.comp < (abs(self.p_obj_val) + abs(self.d_obj_val) + 1.0) * p.rel_opt_tol
                and self.comp < p.abs_opt_tol / pd_scal
            ):
                self.status = PRIMAL_DUAL_OPTIMAL
                break

            if (
                (self.d_step == 1.0 or self.mu < 1e-05)
                and self.p_infeas < 1e-06
                and self.comp < (abs(self.p_obj_val) + abs(self.d_obj_val) + 1.0) * 0.1
                and use_psdp
            ):
                from hdsdp_tpu.solver.psdp import PSDPRefiner

                refiner = PSDPRefiner(self)
                refined = refiner.optimize()
                if refined:
                    # A clean PSDP return ends the solve even when not
                    # converged to tolerance (ref hdsdp_algo.c:1806-1814:
                    # retcode OK -> break; the nBadIter/compl-growth exits
                    # return OK).  The DIMACS gate decides the final
                    # status from the refined (X, y) pair — resuming
                    # potential reduction here would move y while X stays
                    # frozen and can drive comp through zero, passing the
                    # comp test with a crude primal.
                    self.psdp = refiner
                    break
                use_psdp = 0

            if self.n_small_step > 3:
                self.status = NUMERICAL
                break
            if self.status == SUSPECT_INFEAS_OR_UNBOUNDED:
                break
            if time.time() - self.time_begin >= p.time_limit:
                self.status = TIMELIMIT
                break
            self.n_iter += 1
            if self.n_iter >= p.max_iter:
                self.status = MAXITER
                break
            if no_p_obj_found >= 10 and self.p_obj_internal != p_obj_start:
                self.status = NUMERICAL
                break

    def choose_barrier(self, p_obj_type: int) -> bool:
        """ref HDSDP_PhaseB_ChooseBarrier (:1235-1332)."""
        p = self.params
        gap = self.p_obj_internal - self.d_obj_internal
        upper = gap / self.all_cone_dims
        lower = upper / p.pot_rho
        max_step = INF

        if p_obj_type > 0:
            dy1 = -self.d1 / self.mu
            step = self.ratio_test(0.0, dy1, 0.0, "chk")
            step = min(step * 0.97, 1e+05)
            self.mu = self.mu / (1.0 + step)
        else:
            dy2 = -self.d1 / self.mu + self.d2
            step = self.ratio_test(0.0, dy2, 0.0, "dual", with_bound=False)
            max_step = min(max_step, step)  # SDP/LP cones only (ref :1273-1276)
            step_b = float(self._bound_ratio(self.sl, self.su, self.dsl, self.dsu))
            p_step = min(max_step, step_b)
            if p_step < 1.0:
                p_step = 0.97 * p_step

            n_try = 0
            while True:
                if self.add_step_to_checker(p_step):
                    break
                p_step = p_step * 0.97 if n_try > 2 else p_step * 0.5
                n_try += 1
                if p_step < 1e-05:
                    return False

            dy1 = -p_step * self.d1 / self.mu
            # second ratio test continues the running min (ref :1314-1322)
            self.set_step(0.0, dy1, 0.0)
            step2 = float(
                self.cones.ratio_test(self.Lchk, self.s_lp_chk, self.dS, self.ds_lp)
            )
            max_step = min(max_step, step2)
            step_b = float(
                self._bound_ratio(self.sl_chk, self.su_chk, self.dsl, self.dsu)
            )
            max_step = min(max_step, step_b)
            max_step = min(max_step * 0.97, 1e+05)
            self.mu = p_step * self.mu / (1.0 + max_step) + (1.0 - p_step) * (
                self.p_obj_internal - self.d_obj_internal
            ) / self.all_cone_dims

        self.mu = max(self.mu, lower)
        self.mu = min(self.mu, upper)
        return True

    def feasible_build_step(self):
        """ref HDSDP_Feasible_BuildStep (:1334-1364)."""
        while True:
            dy = self.d1 / self.mu - self.d2
            v = self.b / self.mu - self.kkt.asinv
            prox2 = float(v @ dy)
            if prox2 < 0.0:
                self.prox_norm = 1e+02
                return dy
            self.prox_norm = float(np.sqrt(prox2))
            if self.prox_norm >= 0.1:
                return dy
            self.mu = 0.1 * self.mu

    def primal_infeas_check(self, force: bool) -> bool:
        """ref HDSDP_PhaseB_BarPrimalInfeasCheck (:1616-1656)."""
        f = self.f
        trigger = (
            self.p_infeas >= f.rhs_fro_norm
            or force
            or (self.p_infeas > 0.01 * f.rhs_one_norm and self.mu < 1e-03)
        )
        if not trigger:
            return False
        if self.d_obj_val < 0.0:
            return False
        norm = float(jnp.linalg.norm(self.y))
        if norm == 0.0:
            return False
        yn = self.y / norm
        # improving ray: 1e-8*I - A'yn PSD over SDP/LP cones
        S, s_lp = self.cones.assemble(0.0, -1.0, yn, 1e-08 + self.perturb)
        ok, L = self.cones.factor(S, s_lp)
        self.Schk, self.s_lp_chk, self.Lchk = S, s_lp, L
        return bool(ok)

    def get_potential(self, rho: float, y) -> float:
        """ref HDSDP_GetPotential (:1366-1387); uses current factors."""
        pot = self.logdet_cur()
        obj = float(self.b @ y)
        pot += rho * np.log(self.p_obj_internal - obj)
        return pot

    def reduce_potential(self, dy) -> bool:
        """ref HDSDP_Reduce_Potential (:1389-1456)."""
        rho = (self.p_obj_val - self.d_obj_val) / self.mu
        min_step_tol = 0.5 if self.n_small_step >= 2 else 0.0
        required_dec = 0.05 if self.prox_norm < 0.5 else 0.0

        step = self.ratio_test(0.0, dy, 0.0, "dual")
        dual_step = min(step * 0.95, 1.0)

        pot_now = self.get_potential(rho, self.y)
        pot_new = pot_now

        while True:
            cand = self.y + dual_step * dy
            if not self.check_is_interior(1.0, cand):
                dual_step *= 0.33
                continue
            pot_new = self.get_potential(rho, cand)
            if (
                pot_new <= pot_now - required_dec
                or dual_step * self.prox_norm <= 0.001
                or dual_step < min_step_tol
            ):
                self.y = cand
                break
            if dual_step < 1e-04:
                if not self.check_is_interior(1.0, self.y):
                    return False
                break
            dual_step *= 0.3

        self.d_step = dual_step
        return True

    def get_barrier_fn(self, y) -> float:
        """ref HDSDP_GetBarrier (:1458-1479): -(b'y + mu*logdet)."""
        val = float(self.cones.logdet(self.L, self.s_lp))
        val += float(jnp.sum(jnp.log(self.sl)) + jnp.sum(jnp.log(self.su)))
        return -(float(self.b @ y) + self.mu * val)

    def feasible_corrector(self):
        """ref HDSDP_Feasible_Corrector (:1481-1614)."""
        p = self.params
        shrink = self.all_cone_dims / (self.all_cone_dims + np.sqrt(self.all_cone_dims))
        n_max_corr = p.corrector_b
        if n_max_corr == 0:
            return
        if self.prox_norm < 0.1 or self.d_step < 1e-02:
            n_max_corr = 0
        if self.d_step < 0.1 and self.mu < 1e-05:
            n_max_corr = 0
            p.corrector_b = 0
        if self.d_step < 1e-03:
            n_max_corr = 0
            p.corrector_b = 0
        if self.mu < 1e-06:
            n_max_corr = 0
            p.corrector_b = 0

        b_dot_d1 = float(self.b @ self.d1)
        b_dot_corr = 0.0

        for _ in range(n_max_corr):
            if self.mu < 1e-05:
                break
            self.build_kkt("corr")
            d2 = self.solve_kkt(self.kkt.asinv)
            b_dot_d2 = float(self.b @ d2)
            if b_dot_d2 > 0 and b_dot_d1 > 0:
                self.mu = b_dot_d1 / b_dot_d2
            self.mu *= shrink

            dy = self.d1 / self.mu - d2
            b_dot_corr += float(self.b @ dy)  # accumulates across correctors
            # (faithful to ref :1520,1554-1557 where it is never reset)

            barrier_now = self.get_barrier_fn(self.y)
            step = self.ratio_test(0.0, dy, 0.0, "dual")
            step = min(step * 0.95, step)
            step = min(step, p.pot_rho / max(self.prox_norm, 1e-300))

            while True:
                cand = self.y + step * dy
                if not self.check_is_interior(1.0, cand):
                    step *= 0.5
                    continue
                barrier_new = self.get_barrier_fn(cand)
                if step < 1e-04 or barrier_new <= barrier_now - abs(
                    0.05 * b_dot_corr * step
                ):
                    break
                denom = 2 * (barrier_new - barrier_now + b_dot_corr * step) / (step * step)
                if denom != 0 and 0 < b_dot_corr / denom < step:
                    step = b_dot_corr / denom
                else:
                    step *= 0.5

            if step < 1e-04:
                self.check_is_interior(1.0, self.y)
                break
            self.y = cand

    # ------------------------------------------------------------------
    # main entry (ref HDSDP_Conic_Solve, :1853-1870)
    # ------------------------------------------------------------------
    def plan(self):
        """(driver, schur) this solve runs: driver "phase", "iter" or
        "host"; Schur mode "direct", "cg" or "free" (solver.memory.plan,
        taken once at construction)."""
        return self.driver, self.schur

    def solve(self, d_only: bool = False):
        fused = self.driver
        if fused == "host":
            fused = False
        try:
            if fused:
                from hdsdp_tpu.solver.fused import solve_fused

                return solve_fused(self, d_only, mode=fused)
            self.psdp = None
            self.phase_a(d_only)
            if self.status == SUSPECT_INFEAS_OR_UNBOUNDED:
                self.log.info(
                    "\nInfeasible method stops due to suspected infeasibility"
                )
                self.hsd_solve(d_only)
            elif self.status == DUAL_FEASIBLE:
                self.log.info(
                    "\nInfeasible method finds a dual feasible solution"
                )
                self.phase_b()
        except KeyboardInterrupt:
            # ref HUtilCheckCtrlC polling (hdsdp_utils.c:501-519)
            self.log.info("\nUser interrupt")
            self.status = USER_INTERRUPT
        return self.status
