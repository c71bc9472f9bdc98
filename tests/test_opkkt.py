"""Matrix-free Schur operator (sparse-Schur analogue): the operator
matvec and the exact Jacobi diagonal must match the dense M elementwise
across every bucket (slot-major, diagonal rank-1, bounded-support, flat
multi-block, dense, LP), and an end-to-end operator-mode solve must
reach the dense solve's optimum (≙ HUtilKKTCheck cross-validation,
ref interface/hdsdp_utils.c:536-707)."""

import jax.numpy as jnp
import numpy as np
import pytest

import instances
from hdsdp_tpu.io.sdpa import read_sdpa
from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.models.synthetic import maxcut_sdpa, qpg_sdpa, theta_sdpa
from hdsdp_tpu.solver.cones import ConeSystem
from hdsdp_tpu.solver.solver import HDSDPSolver


def _prob(name):
    if name.endswith(".dat-s"):
        return SDPProblem.from_sdpa(read_sdpa(instances.path(name)))
    gen = {
        "maxcut120": lambda: maxcut_sdpa(n=120),
        "theta60": lambda: theta_sdpa(n=60, n_edges=400),
        "qpg60": lambda: qpg_sdpa(n=60),
    }[name]
    return SDPProblem.from_sdpa(gen())


@pytest.mark.parametrize(
    "name",
    ["theta50.dat-s", "control10.dat-s", "maxcut120", "theta60", "qpg60"],
)
def test_operator_matches_dense(name):
    prob = _prob(name)
    cs = ConeSystem(prob)
    m = prob.m

    rng = np.random.default_rng(3)
    y = jnp.asarray(rng.normal(size=m) * 0.01)
    shift = 10.0 + prob.features.obj_fro_norm
    S, s_lp = cs.assemble(1.0, -1.0, y, shift)
    ok, L = cs.factor(S, s_lp)
    assert bool(ok)

    kkt = cs.build_kkt(L, s_lp, -1.3, "hsd")
    M = np.asarray(kkt.M)
    scale = max(1.0, np.abs(M).max())

    Us = cs.inverses(L)
    rhs = cs.build_kkt_rhs(Us, s_lp, -1.3, "hsd")
    for f in ("asinv", "asinvrdsinv", "asinvcsinv"):
        np.testing.assert_allclose(
            np.asarray(getattr(rhs, f)), np.asarray(getattr(kkt, f)),
            atol=1e-10, rtol=1e-10,
        )
    for f in ("csinv", "csinvcsinv", "csinvrdsinv", "trace_sinv"):
        assert float(getattr(rhs, f)) == pytest.approx(
            float(getattr(kkt, f)), rel=1e-10, abs=1e-12
        )

    # matvec against dense M on a handful of directions
    V = jnp.asarray(rng.normal(size=(m, 3)))
    zero = jnp.zeros((m,))
    MV = cs.kkt_matvec(Us, s_lp, zero, V)
    np.testing.assert_allclose(
        np.asarray(MV), M @ np.asarray(V), atol=1e-9 * scale
    )

    # exact Jacobi diagonal
    d = cs.kkt_diag(Us, s_lp)
    np.testing.assert_allclose(
        np.asarray(d), np.diag(M), atol=1e-9 * scale
    )

    # PCG solve against the dense solve
    b = jnp.asarray(rng.normal(size=(m, 2)))
    reg = 1e-08 * scale
    pinv = 1.0 / (d + reg)
    X, res, _ = cs.kkt_pcg(
        Us, s_lp, jnp.full((m,), reg), pinv, b, abs_tol=1e-12,
        rel_tol=1e-12, max_iter=4 * m,
    )
    Xd = np.linalg.solve(M + reg * np.eye(m), np.asarray(b))
    np.testing.assert_allclose(np.asarray(X), Xd, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["maxcut120", "theta60"])
def test_kkt_rows_chunks_match_dense(name):
    """The row-chunked KKT build (the f32-preconditioner materializer,
    round 5) must reproduce the dense M row-for-row, including the
    diagonal bound/reg terms, for every chunkable bucket."""
    prob = _prob(name)
    cs = ConeSystem(prob)
    assert cs.kkt_rows_supported()
    m = prob.m

    rng = np.random.default_rng(7)
    y = jnp.asarray(rng.normal(size=m) * 0.01)
    shift = 10.0 + prob.features.obj_fro_norm
    S, s_lp = cs.assemble(1.0, -1.0, y, shift)
    ok, L = cs.factor(S, s_lp)
    assert bool(ok)
    kkt = cs.build_kkt(L, s_lp, -1.3, "inf")
    Us = cs.inverses(L)

    extra = jnp.asarray(rng.uniform(0.5, 2.0, size=m))
    M = np.asarray(kkt.M) + np.diag(np.asarray(extra))
    scale = max(1.0, np.abs(M).max())

    chunk = 48
    got = np.zeros((m, m))
    i0s = list(range(0, m - chunk + 1, chunk))
    if not i0s or i0s[-1] + chunk < m:
        i0s.append(m - chunk)
    for i0 in i0s:
        got[i0:i0 + chunk] = np.asarray(
            cs.kkt_rows(Us, s_lp, extra, i0, chunk)
        )
    np.testing.assert_allclose(got, M, atol=1e-9 * scale)


def test_kkt_full_from_rows_matches_dense():
    """The chunk-assembled full KKT matrix (PSDP's factor-once path at
    sizes where the monolithic with_m build cannot compile) must equal
    the dense build elementwise."""
    prob = _prob("theta60")
    cs = ConeSystem(prob)
    m = prob.m
    rng = np.random.default_rng(9)
    y = jnp.asarray(rng.normal(size=m) * 0.01)
    shift = 10.0 + prob.features.obj_fro_norm
    S, s_lp = cs.assemble(1.0, -1.0, y, shift)
    ok, L = cs.factor(S, s_lp)
    assert bool(ok)
    kkt = cs.build_kkt(L, s_lp, -1.3, "inf")
    Us = cs.inverses(L)
    zero = jnp.zeros((m,), jnp.float64)
    M = np.asarray(cs.kkt_full_from_rows(Us, s_lp, zero, chunk=64))
    scale = max(1.0, np.abs(M).max())
    np.testing.assert_allclose(M, np.asarray(kkt.M), atol=1e-9 * scale)


def test_operator_chol_precond_engages_and_solves():
    """The operator-mode f32 Cholesky preconditioner (round 5, VERDICT
    #4) must build via the chunked materializer, drive the CG, and reach
    the dense path's optimum even with a starved Jacobi budget."""
    prob = _prob("theta60")
    ref = HDSDPSolver(prob).optimize()
    s = HDSDPSolver(
        prob, kkt_mode="free", kkt_free_maxiter=40, op_precond_chunk=64,
        op_materialize_cap=0,  # tier 3 off: the preconditioner must carry
    )
    r = s.optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.d_obj == pytest.approx(ref.d_obj, rel=1e-06, abs=1e-06)
    assert r.stats.get("op_pc_builds", 0) >= 1, (
        "the f32 operator preconditioner never engaged"
    )


def test_operator_mode_end_to_end():
    prob = _prob("theta60")
    ref = HDSDPSolver(prob).optimize()
    assert ref.status == "PRIMAL_DUAL_OPTIMAL"

    r = HDSDPSolver(prob, kkt_mode="free").optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.d_obj == pytest.approx(ref.d_obj, rel=1e-06, abs=1e-06)


def test_operator_mode_lp_mix_end_to_end():
    prob = _prob("qpg60")
    ref = HDSDPSolver(prob).optimize()
    r = HDSDPSolver(prob, kkt_mode="free").optimize()
    assert r.status == ref.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.d_obj == pytest.approx(ref.d_obj, rel=1e-06, abs=1e-06)


def test_operator_cg_stall_escalation():
    """A starved CG budget must escalate to the materialized direct
    factor (≙ the reference's CG -> dense-LDL switch on solve failure,
    hdsdp_linsolver.c:1827-1857) and still reach the optimum."""
    prob = _prob("theta60")
    ref = HDSDPSolver(prob).optimize()
    s = HDSDPSolver(prob, kkt_mode="free", kkt_free_maxiter=2)
    r = s.optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.d_obj == pytest.approx(ref.d_obj, rel=1e-06, abs=1e-06)
    assert r.stats.get("op_escalations", 0) > 0


def test_operator_cg_stall_no_materialize_cap():
    """Above the materialize cap the ladder must stop at tier 2 (extended
    CG) without crashing; with a realistic extended budget the solve
    still converges (CG is exact in at most m steps)."""
    prob = _prob("theta60")
    s = HDSDPSolver(
        prob, kkt_mode="free", kkt_free_maxiter=60, op_materialize_cap=0
    )
    r = s.optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.stats.get("op_escalations", 0) == 0
