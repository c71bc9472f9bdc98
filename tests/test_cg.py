"""PCG Schur backend: single-chip AdaptiveCG policy, row-sharded CG on the
virtual mesh, and an end-to-end solve driven through the CG path."""

import jax.numpy as jnp
import numpy as np
import pytest

from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.models.synthetic import random_sdpa
from hdsdp_tpu.ops.cg import STATUS_OK, AdaptiveCG, pcg
from hdsdp_tpu.parallel import make_mesh
from hdsdp_tpu.parallel.cg import sharded_pcg
from hdsdp_tpu.solver.solver import HDSDPSolver


def _spd(m, seed=0, cond=1e3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(m, m)))
    w = np.geomspace(1.0, cond, m)
    return jnp.asarray(Q @ np.diag(w) @ Q.T)


def test_pcg_jacobi_converges():
    m = 60
    M = _spd(m, seed=1, cond=50.0)
    rhs = jnp.asarray(np.random.default_rng(2).normal(size=m))
    res = pcg(M, rhs, jnp.diag(M), max_iter=200)
    assert int(res.status) == STATUS_OK
    x_ref = np.linalg.solve(np.asarray(M), np.asarray(rhs))
    np.testing.assert_allclose(np.asarray(res.x), x_ref, atol=1e-5)


def test_adaptive_cg_escalates_on_illconditioned():
    m = 80
    M = _spd(m, seed=3, cond=1e10)
    rhs = jnp.asarray(np.random.default_rng(4).normal(size=m))
    cg = AdaptiveCG()
    x = cg.solve(M, rhs)
    x_ref = np.linalg.solve(np.asarray(M), np.asarray(rhs))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-5, atol=1e-6)
    assert cg.n_factor >= 1  # f32 tier stalled -> f64 preconditioner
    # second solve with a nearby matrix reuses the stale factor
    nf = cg.n_factor
    x2 = cg.solve(M + 1e-6 * jnp.eye(m), rhs)
    np.testing.assert_allclose(np.asarray(x2), x_ref, rtol=1e-4, atol=1e-5)
    assert cg.n_factor == nf


def test_sharded_pcg_matches_direct():
    mesh = make_mesh(8)
    m = 100  # not a multiple of 8: exercises padding
    M = _spd(m, seed=5, cond=100.0)
    rhs = jnp.asarray(np.random.default_rng(6).normal(size=m))
    x, iters = sharded_pcg(mesh, M, rhs, max_iter=400)
    x_ref = np.linalg.solve(np.asarray(M), np.asarray(rhs))
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-5)


def test_solver_via_cg_backend():
    prob = SDPProblem.from_sdpa(random_sdpa(m=20, block_dims=[10], seed=8))
    r_cg = HDSDPSolver(prob, verbose=False, fused=False, kkt_solver="cg").optimize()
    r_di = HDSDPSolver(prob, verbose=False, fused=False, kkt_solver="direct").optimize()
    assert r_cg.status == "PRIMAL_DUAL_OPTIMAL"
    assert r_cg.d_obj == pytest.approx(r_di.d_obj, rel=1e-6)


def test_cg_reports_failure_on_indefinite():
    """An indefinite M must be reported (ok=False), not silently NaN."""
    m = 40
    M = _spd(m, seed=9)
    M = M - 10.0 * jnp.eye(m)  # make indefinite
    rhs = jnp.asarray(np.random.default_rng(10).normal(size=m))
    cg = AdaptiveCG()
    x, ok = cg.solve_checked(M, rhs)
    assert not ok


def test_solver_cg_escalates_direct():
    """DualIPM.solve_kkt must escalate to the direct ladder when CG fails
    (ADVICE: CG backend previously iterated on NaNs)."""
    from hdsdp_tpu.solver.algo import DualIPM
    from hdsdp_tpu.solver.params import Params

    # m must exceed CG's max_iter cap, else the Krylov method terminates
    # exactly on the indefinite system within m iterations
    prob = SDPProblem.from_sdpa(random_sdpa(m=120, block_dims=[10], seed=8))
    ipm = DualIPM(prob, Params(verbose=False, kkt_solver="cg"))
    m = ipm.m
    rng = np.random.default_rng(11)
    Q = np.asarray(rng.normal(size=(m, m)))
    # genuinely indefinite: mixed-sign spectrum (not merely negative definite)
    M_bad = jnp.asarray(0.05 * (Q + Q.T) + np.diag(np.linspace(-1.0, 1.0, m)))
    from hdsdp_tpu.solver.cones import KKTOut

    ipm.kkt = KKTOut(M=M_bad, asinv=None, asinvrdsinv=None, asinvcsinv=None,
                     csinv=None, csinvcsinv=None, csinvrdsinv=None,
                     trace_sinv=None)
    ipm.factor_kkt()
    rhs = jnp.asarray(rng.normal(size=m))
    x = ipm.solve_kkt(rhs)
    # the LU fallback must produce the true solution of the indefinite system
    x_ref = np.linalg.solve(np.asarray(M_bad), np.asarray(rhs))
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-8, atol=1e-8)
    assert ipm.Mfac[0] in ("lu", "chol")


@pytest.mark.parametrize("m,cond,atol", [
    (600, 1e6, 1e-9),  # late-IPM conditioning
    (600, 1e4, 1e-10),
    (512, 1e4, 1e-10),
])
def test_refine_solve_f32_factor_matches_direct(m, cond, atol):
    """AdaptiveCG's f32 tier refines with f64 residuals against the
    equilibrated f32 Cholesky factor, applied by two triangular solves
    (solve_triangular) per sweep; it must reach the f64 direct solve."""
    from hdsdp_tpu.ops.cg import _equilibrated_factor, refine_solve

    k = 8
    M = _spd(m, seed=9, cond=cond)
    rng = np.random.default_rng(10)
    B = jnp.asarray(rng.normal(size=(m, k)))

    L, s, ok = _equilibrated_factor(M, f32=True)
    assert bool(ok) and L.dtype == jnp.float32
    X, st, _ = refine_solve(M, L, s, B)
    assert int(st) == STATUS_OK
    X_ref = np.linalg.solve(np.asarray(M), np.asarray(B))
    scale = np.max(np.abs(X_ref))
    np.testing.assert_allclose(np.asarray(X) / scale, X_ref / scale,
                               atol=atol)


def test_adaptive_cg_tiers_keep_their_factor_form():
    """Both tiers store the triangular factor L: f32 in the fast tier,
    f64 in the escalation tier."""
    m = 80
    rhs = jnp.asarray(np.random.default_rng(4).normal(size=m))
    cg = AdaptiveCG()
    cg.solve(_spd(m, seed=3, cond=1e2), rhs)
    L, _ = cg.chol_fac
    assert L.dtype == jnp.float32
    np.testing.assert_array_equal(np.triu(np.asarray(L), 1), 0.0)
    cg = AdaptiveCG()
    cg._factor(_spd(m, seed=3, cond=1e2), f32=False)
    L, _ = cg.chol_fac
    assert L.dtype == jnp.float64
