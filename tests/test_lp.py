"""Standalone LP IPM: golden objectives on the in-repo MPS instances
(HiGHS optima via scipy; ref tests/test_file_io.c:89-183 is the
equivalent driver) plus synthetic random LP sanity checks."""

import numpy as np
import pytest

import instances
from hdsdp_tpu.solver.lpsolve import LPParams, LPSolver, solve_mps_file

@pytest.mark.parametrize("fname", ["lp_small.mps", "lp_medium.mps"])
def test_lp_golden(fname):
    obj = instances.lp_golden(fname)
    r = solve_mps_file(instances.path(fname), verbose=False)
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.p_obj == pytest.approx(obj, rel=1e-6)
    assert r.d_obj == pytest.approx(obj, rel=1e-6)


def test_lp_random_feasible():
    rng = np.random.default_rng(0)
    m, n = 30, 80
    A = rng.normal(size=(m, n))
    x0 = rng.random(n) + 0.5
    b = A @ x0
    y0 = rng.normal(size=m)
    s0 = rng.random(n) + 0.5
    c = A.T @ y0 + s0
    r = LPSolver(A, b, c, LPParams(verbose=False)).optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    # strong duality
    assert r.p_obj == pytest.approx(r.d_obj, rel=1e-7)
    assert np.all(r.x > -1e-9)
    assert np.linalg.norm(A @ r.x - b) < 1e-6 * (1 + np.linalg.norm(b))


@pytest.mark.parametrize("scal", ["ruiz", "geometric", "l2", "none"])
def test_lp_scalings(scal):
    rng = np.random.default_rng(3)
    m, n = 10, 25
    A = rng.normal(size=(m, n)) * np.exp(rng.normal(size=(1, n)) * 2)
    x0 = rng.random(n) + 0.5
    b = A @ x0
    c = A.T @ rng.normal(size=m) + rng.random(n) + 0.5
    r = LPSolver(A, b, c, LPParams(verbose=False, scal_method=scal)).optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"


def test_lp_golden_large():
    """Larger sparse instance (240 rows, 500 columns): the factor:solve
    switch-over machinery runs, optimum matches HiGHS."""
    obj = instances.lp_golden("lp_large.mps")
    r = solve_mps_file(instances.path("lp_large.mps"), verbose=False)
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.p_obj == pytest.approx(obj, rel=1e-5)
    assert r.d_obj == pytest.approx(obj, rel=1e-5)


def test_lp_golden_redundant_rows(tmp_path):
    """Degenerate instance with repeated equality rows (rank-deficient A):
    exercises the persistent regularization-ladder rung (ref qdldl static
    regularization)."""
    c, A, senses, rhs, ub = instances.random_lp(*instances.LP["lp_small.mps"])
    eq = np.nonzero(senses == "E")[0]
    lp = (c, np.vstack([A, A[eq]]), np.concatenate([senses, senses[eq]]),
          np.concatenate([rhs, rhs[eq]]), ub)
    path = tmp_path / "redundant.mps"
    path.write_text(instances.format_mps("REDUNDANT", *lp))
    obj = instances.linprog_optimum(*lp)
    r = solve_mps_file(str(path), verbose=False)
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.p_obj == pytest.approx(obj, rel=1e-6)
    assert r.d_obj == pytest.approx(obj, rel=1e-6)


def test_lp_primal_phase_runs():
    """Force the primal-only switch-over (primal_switch_ratio=0) and check
    the flagship primal phase (ref HLpSolverITakePrimalStep,
    hdsdp_lpsolve.c:949-1092) is actually entered and still reaches the
    optimum."""
    rng = np.random.default_rng(7)
    m, n = 40, 100
    A = rng.normal(size=(m, n))
    x0 = rng.random(n) + 0.5
    b = A @ x0
    c = A.T @ rng.normal(size=m) + rng.random(n) + 0.5
    solver = LPSolver(
        A, b, c, LPParams(verbose=False, primal_switch_ratio=0.0)
    )
    r = solver.optimize()
    assert solver.last_method == "primal"
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.p_obj == pytest.approx(r.d_obj, rel=1e-6)


RANGED_MPS = """NAME          RANGED
ROWS
 N  COST
 L  R1
 G  R2
 E  R3
COLUMNS
    X1        COST      -1.0   R1   1.0
    X1        R2         1.0   R3   1.0
    X2        COST      -2.0   R1   1.0
    X2        R2        -1.0   R3   2.0
RHS
    RHS       R1         4.0   R2  -1.0
    RHS       R3         3.0
RANGES
    RNG       R1         2.0   R2   3.0
    RNG       R3         {r3}
ENDATA
"""


@pytest.mark.parametrize(
    "r3,obj",
    [
        (4.0, -6.5),  # E range > 0:  3 <= x1+2x2 <= 7
        (-4.0, -3.0),  # E range < 0: -1 <= x1+2x2 <= 3
    ],
)
def test_lp_ranges_full_semantics(tmp_path, r3, obj):
    """Two-sided rows via RANGES incl. signed E-row ranges
    (ref external/lp_mps.c semantics; hand-computed optima)."""
    path = tmp_path / "ranged.mps"
    path.write_text(RANGED_MPS.format(r3=r3))
    r = solve_mps_file(str(path), verbose=False)
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.p_obj == pytest.approx(obj, rel=1e-6)
