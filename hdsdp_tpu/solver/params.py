"""Solver parameters, defaults and feature-driven auto-tuning.

Parity: defaults from HDSDPIGetDefaultParams (ref interface/hdsdp.c:397-424),
adjustment logic from HDSDPIAdjustParams (ref hdsdp.c:280-395) and
HDSDPIAdjustConeParams (ref hdsdp.c:136-278).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from hdsdp_tpu.models.problem import Features


@dataclass
class Params:
    # int params (ref hdsdp.h:70-78)
    max_iter: int = 500
    corrector_a: int = 12
    corrector_b: int = 12
    threads: int = 12
    psdp: int = 0
    pre_level: int = 2
    # double params (ref hdsdp.h:80-92)
    abs_opt_tol: float = 1e-08
    abs_feas_tol: float = 1e-08
    rel_opt_tol: float = 1e-08
    rel_feas_tol: float = 1e-08
    time_limit: float = 3600.0
    pot_rho: float = 4.0
    hsd_gamma: float = 0.5
    dual_box_up: float = 1e+07
    dual_box_low: float = -1e+07
    bar_mu_start: float = 1e+05
    p_obj_start: float = 1e+10
    dual_slack_start: float = 1e+05
    trx_estimate: float = 1e+08
    prec_ord_acc: float = 1e-08
    # hdsdp_tpu extensions
    dtype: str = "float64"
    ratio_test: str = "auto"  # "exact" | "lanczos" | "auto"
    lanczos_dim: int = 30
    # Warm-started Lanczos depth for the fused programs: the per-group
    # top-Ritz image is threaded through the State (ref persistent vVec,
    # hdsdp_lanczos.c:166-178) so the Krylov space can be half as deep
    # for the same bound quality.  0 disables warm starts (cold
    # deterministic start at full lanczos_dim depth every call).
    lanczos_warm_dim: int = 16
    verbose: bool = True
    model_notes: str = ""
    # stage wall-clock profiling of the host loop (utils.profile.Region);
    # result lands in DualIPM.region (ref HDSDP_CODE_PROFILER analogue)
    profile: bool = False
    # Fusion mode for the IPM phases (hdsdp_tpu.solver.fused):
    #   "phase" — each phase is ONE in-graph while-loop dispatch (small
    #             shapes; the while-loop wrapper's compile time grows
    #             steeply with the shapes),
    #   "iter"  — the jitted iteration body is dispatched per iteration,
    #   False   — host-driven reference loop,
    #   "auto"  — "phase" iff m <= fused_max_m and max block dim <=
    #             fused_max_n; "iter" while the estimated resident state
    #             fits the device; host loop above that
    #             (solver.memory.plan).
    fused: object = "auto"
    fused_max_m: int = 512
    fused_max_n: int = 256
    # Schur system backend: "direct" dense Cholesky, "cg" Jacobi/stale-
    # Cholesky PCG (ref HDSDP_LINSYS_DENSE_ITERATIVE default), "auto"
    # picks cg above kkt_cg_threshold rows (host loop only; the fused
    # path factors directly)
    kkt_solver: str = "auto"
    kkt_cg_threshold: int = 4096
    # Matrix-free Schur operator (the sparse-Schur-storage analogue,
    # ref hdsdp_schur.c:60,227): "free" never materializes the m x m M —
    # CG solves apply M v = A(S^-1 (sum_j v_j A_j) S^-1) per bucket with
    # an exact Jacobi diagonal as preconditioner, O(m + n^2) memory.
    # "auto" engages where a dense M would crowd the device
    # (solver.memory.kkt_free); "dense" forces materialization.  Host
    # loop only; PSDP is skipped in operator mode (its KKT is dense-only).
    kkt_mode: str = "auto"
    # CG iterations per dispatch in operator mode
    kkt_free_maxiter: int = 600
    # Largest m for which operator mode's stall escalation (≙ the
    # reference's CG -> dense-LDL switch, hdsdp_linsolver.c:1827-1857)
    # materializes M once for a direct factor.  None derives it from the
    # device memory (solver.memory.dense_m_cap); 0 turns it off.
    op_materialize_cap: Optional[int] = None
    # Operator mode's Cholesky preconditioner (≙ QDLDL's role for the
    # sparse Schur system, hdsdp_linsolver.c:510-810, + the ADPCG
    # stale-factor policy) builds an equilibrated f32 copy of M in row
    # chunks of this many rows, up to m = solver.memory.dense_m_cap()
    op_precond_chunk: int = 2048
    # refresh the stale factor when a converged solve needed this many
    # CG iterations (the ADPCG iteration-regret rule)
    op_precond_refresh_iters: int = 80


def adjust_params(params: Params, f: Features) -> Params:
    """Feature-driven auto-tuning (ref hdsdp.c:280-395, 136-278)."""

    # --- scaling decision (ref hdsdp.c:287-312); the scale factors are
    # recorded on the features and applied by the solver.
    obj_one = f.obj_one_norm
    rhs_inf = f.rhs_inf_norm
    obj_scal = 1.0
    if obj_one > 1e+10:
        obj_scal = 1e-08
    elif obj_one > 1e+08:
        obj_scal = 1e-06
    elif obj_one > 1e+05:
        obj_scal = 1e-05
    if rhs_inf > 1e+10:
        rhs_scal = 1e-08
    elif rhs_inf > 1e+08:
        rhs_scal = 1e-06
    else:
        rhs_scal = 1.0
    f.obj_scaling = obj_scal
    f.rhs_scaling = rhs_scal

    if params.pre_level < 1:
        return params

    # --- corrector counts (ref hdsdp.c:340-387)
    m = f.n_rows
    max_dim = max(f.n_max_cone_dim, 1)
    n_corr_a = (m - 2) // max_dim
    if f.n_sum_cone_dims < 100 and n_corr_a == 0:
        n_corr_a = 1
    if n_corr_a >= 1:
        n_corr_a += 1
    n_corr_a = n_corr_a * n_corr_a
    if m < 2000 and n_corr_a > 10:
        n_corr_a = 10
    n_corr_b = n_corr_a

    if f.n_max_cone_dim >= 5 * m:
        n_corr_b = 0
        n_corr_a = 2
    elif f.n_max_cone_dim >= m:
        n_corr_b = min(n_corr_b, 2)
        n_corr_a = 4
    else:
        n_corr_a = 6

    if m > 20 * f.n_max_cone_dim:
        n_corr_b = max(n_corr_b, 12)
        n_corr_a = 12
    elif m > 5 * f.n_max_cone_dim:
        n_corr_b = max(n_corr_b, 10)
        n_corr_a = 10
    elif m > 2 * f.n_max_cone_dim:
        n_corr_b = max(n_corr_b, 8)
        n_corr_a = 8

    params.corrector_b = min(n_corr_b, 12)
    params.corrector_a = max(n_corr_a, 2)

    if params.pre_level >= 2:
        _adjust_cone_params(params, f)

    return params


def _adjust_cone_params(params: Params, f: Features) -> None:
    """Structure-specific tuning (ref HDSDPIAdjustConeParams, hdsdp.c:136-278)."""

    notes = []
    n_sdp_cones = f.n_cones - (1 if f.n_lp_cols else 0)

    if f.many_cones:
        params.corrector_a = 6
        params.corrector_b = 0
        params.dual_slack_start = 1.0
        params.p_obj_start = 1e+10

    is_one_cone = n_sdp_cones <= 1

    if f.n_max_cone_dim < f.n_rows / 3 and is_one_cone:
        params.psdp = 1
    if f.n_lp_cols > 0:
        params.psdp = 0

    if f.very_dense:
        params.corrector_a = 4
        params.dual_slack_start = 1.0
        params.dual_box_up = 1e+04
        params.dual_box_low = -1e+04
        notes.append("dense")

    if f.implied_trace:
        params.dual_slack_start = 1e+03
        params.trx_estimate = f.implied_trace_x
        params.p_obj_start = 1e+08
        params.pot_rho = 5.0
        params.dual_box_up = 1e+06
        params.dual_box_low = -1e+06
        notes.append("trace-implied")

    if f.no_primal_interior:
        params.dual_box_up = 1e+04
        params.dual_box_low = -1e+04
        params.dual_slack_start = 1e+03
        params.prec_ord_acc = 1e-07
        notes.append("no-primal interior")

    if f.imp_y_bound:
        if f.imp_y_up:
            params.dual_box_up = min(params.dual_box_up, f.imp_y_up)
        if f.imp_y_low:
            params.dual_box_low = max(params.dual_box_low, f.imp_y_low)
        if f.imp_y_up and f.imp_y_low:
            params.dual_slack_start = 1e+02
            params.p_obj_start = 1e+05
        else:
            params.dual_slack_start = 1e+05
            params.p_obj_start = 1e+10
            params.corrector_a = 12
            params.corrector_b = 12
        params.abs_opt_tol = 1e-01
        params.rel_opt_tol = 1e-04
        params.prec_ord_acc = 1e-05
        notes.append("dual-bounded")

    if f.no_dual_interior:
        params.dual_box_up = 1.0
        params.dual_box_low = -1.0
        total_dims = f.n_sum_cone_dims + 2 * f.n_rows
        if total_dims > 100000:
            params.dual_slack_start = 1e+00
            params.abs_feas_tol = 1e-04
            params.rel_feas_tol = 1e-05
        else:
            params.dual_box_up = 1e+01
            params.dual_box_low = -1e+01
            params.abs_feas_tol = 1e-05
            params.rel_feas_tol = 1e-07
        params.prec_ord_acc = 1e-05
        notes.append("no-dual interior")

    if f.null_obj:
        params.dual_slack_start = 1.0
        params.dual_box_up = 1.0
        params.dual_box_low = -1.0
        notes.append("no objective")

    if notes:
        params.model_notes = "This is a " + " ".join(notes) + " SDP problem"
