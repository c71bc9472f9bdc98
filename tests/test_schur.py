"""Schur assembly cross-validation (analogue of HUtilKKTCheck,
ref interface/hdsdp_utils.c:536-707): the bucketed assembly must match a
naive dense einsum reference elementwise."""

import numpy as np
import pytest

import jax.numpy as jnp

import instances
from hdsdp_tpu.io.sdpa import read_sdpa
from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.solver.cones import ConeSystem


def dense_constraints(data, blk_idx):
    """Full [m+1, n, n] dense coefficient stack from raw COO (index 0 = C)."""
    blk = data.blocks[blk_idx]
    n = blk.dim
    A = np.zeros((data.m + 1, n, n))
    np.add.at(A, (blk.con, blk.row, blk.col), blk.val)
    At = np.transpose(A, (0, 2, 1))
    mask = np.triu(np.ones((n, n)), 1)  # mirror lower entries into the upper tri
    return A + At * mask


def naive_kkt(A_all, C, U, Rd):
    """Reference M3-style dense computation for one block."""
    m = A_all.shape[0] - 1
    A = A_all[1:]
    B = np.einsum("pq,iqr,rs->ips", U, A, U)
    M = np.einsum("ipq,jpq->ij", B, A)
    asinv = np.einsum("ipq,pq->i", A, U)
    asinvrdsinv = Rd * np.trace(B, axis1=1, axis2=2)
    asinvcsinv = np.einsum("ipq,pq->i", B, C)
    T = U @ C @ U
    csinv = np.sum(C * U)
    csinvcsinv = np.sum(C * T)
    csinvrdsinv = Rd * np.trace(T)
    return M, asinv, asinvrdsinv, asinvcsinv, csinv, csinvcsinv, csinvrdsinv


@pytest.mark.parametrize("fname", ["maxcut100.dat-s", "theta50.dat-s", "control10.dat-s", "gpp100.dat-s"])
def test_kkt_cross_validation(fname):
    data = read_sdpa(instances.path(fname))
    prob = SDPProblem.from_sdpa(data)
    cones = ConeSystem(prob)

    rng = np.random.default_rng(42)
    m = prob.m
    y = rng.normal(size=m) * 0.01
    Rd = -1.7

    # current duals S = -Rd - A'y + C (must be PD: use large positive shift)
    shift = -Rd + 10.0 + prob.features.obj_fro_norm
    S, s_lp = cones.assemble(1.0, -1.0, jnp.asarray(y), shift)
    ok, L = cones.factor(S, s_lp)
    assert bool(ok)

    kkt = cones.build_kkt(L, s_lp, Rd, "hsd")

    # naive reference: accumulate per block
    M_ref = np.zeros((m, m))
    asinv_ref = np.zeros(m)
    rd_ref = np.zeros(m)
    acs_ref = np.zeros(m)
    csinv_ref = csc_ref = crd_ref = 0.0
    trace_ref = 0.0

    # map original block index -> (group, slot)
    for gi, grp in enumerate(prob.groups):
        for slot, ib in enumerate(grp.block_ids):
            A_all = dense_constraints(data, ib)
            C = A_all[0]
            n = grp.dim
            Sg = np.asarray(S[gi][slot])
            # verify assembly itself
            S_naive = -np.einsum("i,ipq->pq", y, A_all[1:]) + C + shift * np.eye(n)
            np.testing.assert_allclose(Sg, S_naive, atol=1e-10)
            U = np.linalg.inv(Sg)
            Mb, ab, rb, acb, cs, cc, crd = naive_kkt(A_all, C, U, Rd)
            M_ref += Mb
            asinv_ref += ab
            rd_ref += rb
            acs_ref += acb
            csinv_ref += cs
            csc_ref += cc
            crd_ref += crd
            trace_ref += np.trace(U)

    scale = max(1.0, np.max(np.abs(M_ref)))
    np.testing.assert_allclose(np.asarray(kkt.M), M_ref, atol=1e-8 * scale)
    np.testing.assert_allclose(np.asarray(kkt.asinv), asinv_ref, atol=1e-8)
    np.testing.assert_allclose(np.asarray(kkt.asinvrdsinv), rd_ref, atol=1e-8)
    np.testing.assert_allclose(np.asarray(kkt.asinvcsinv), acs_ref, atol=1e-8)
    assert abs(float(kkt.csinv) - csinv_ref) < 1e-8 * max(1, abs(csinv_ref))
    assert abs(float(kkt.csinvcsinv) - csc_ref) < 1e-8 * max(1, abs(csc_ref))
    assert abs(float(kkt.csinvrdsinv) - crd_ref) < 1e-8 * max(1, abs(crd_ref))
    assert abs(float(kkt.trace_sinv) - trace_ref) < 1e-8 * max(1, trace_ref)

    # corrector build must agree on the RHS vectors
    kkt_corr = cones.build_kkt(L, s_lp, Rd, "corr")
    np.testing.assert_allclose(np.asarray(kkt_corr.asinv), asinv_ref, atol=1e-8)
    np.testing.assert_allclose(np.asarray(kkt_corr.asinvrdsinv), rd_ref, atol=1e-8)


def test_ratio_test_exact():
    data = read_sdpa(instances.path("theta50.dat-s"))
    prob = SDPProblem.from_sdpa(data)
    cones = ConeSystem(prob)
    rng = np.random.default_rng(3)
    y = jnp.asarray(rng.normal(size=prob.m) * 0.01)
    dy = jnp.asarray(rng.normal(size=prob.m) * 0.1)

    S, s_lp = cones.assemble(1.0, -1.0, y, 12.0 + prob.features.obj_fro_norm)
    ok, L = cones.factor(S, s_lp)
    assert bool(ok)
    dS, ds_lp = cones.assemble(0.0, -1.0, dy, 0.0)
    step = float(cones.ratio_test(L, s_lp, dS, ds_lp))

    # brute force: smallest positive alpha with S + alpha dS singular
    Sg = np.asarray(S[0][0])
    dSg = np.asarray(dS[0][0])
    w = np.linalg.eigvalsh(
        np.linalg.solve(np.linalg.cholesky(Sg), dSg)
        @ np.linalg.inv(np.linalg.cholesky(Sg)).T
    )
    lam_min = w.min()
    expected = -1.0 / lam_min if lam_min < 0 else np.inf
    assert step == pytest.approx(expected, rel=1e-8)


def test_slot_major_matches_flat_layout():
    """The slot-major assembly (single-block groups, the large-m path)
    must match the flat packed-slot layout elementwise (analogue of
    HUtilKKTCheck comparing two Schur strategies)."""
    import jax.numpy as jnp
    from hdsdp_tpu.models.synthetic import theta_sdpa
    from hdsdp_tpu.ops import schur as so
    from hdsdp_tpu.ops import chol as chol_ops

    data = theta_sdpa(n=40, n_edges=120, seed=3)
    prob = SDPProblem.from_sdpa(data)
    cs_slot = ConeSystem(prob, layout="auto")
    cs_flat = ConeSystem(prob, layout="flat")
    assert cs_slot.groups[0].Fs is not None
    assert cs_flat.groups[0].Fs is None

    rng = np.random.default_rng(1)
    y = jnp.asarray(rng.normal(size=prob.m) * 0.01)
    shift = 5.0 + prob.features.obj_fro_norm
    for cs in (cs_slot, cs_flat):
        S, s_lp = cs.assemble(1.0, -1.0, y, shift)
        ok, L = cs.factor(S, s_lp)
        assert bool(ok)
        cs._kkt = cs.build_kkt(L, s_lp, -0.7, "hsd")
    for f in ("M", "asinv", "asinvrdsinv", "asinvcsinv"):
        np.testing.assert_allclose(
            np.asarray(getattr(cs_slot._kkt, f)),
            np.asarray(getattr(cs_flat._kkt, f)),
            atol=1e-10, rtol=1e-10,
        )


def test_theta_class_scale_end_to_end():
    """SDPLIB theta-family structure at moderate scale (m ~ 900): rank-2
    slot-major bucket + identity in the dense bucket, solved to DIMACS."""
    from hdsdp_tpu.models.synthetic import theta_sdpa
    from hdsdp_tpu.solver.solver import HDSDPSolver

    data = theta_sdpa(n=100, n_edges=900, seed=5)
    prob = SDPProblem.from_sdpa(data)
    r = HDSDPSolver(prob, verbose=False).optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert np.max(np.abs(r.dimacs)) < 1e-2
    assert r.d_obj < -1.0  # theta number >= 1 (min form: -theta)


def test_maxcut_class_end_to_end():
    """SDPLIB maxG-family structure (m = n, all-rank-1 diagonal
    constraints): the pure slot-major r = 1 path."""
    from hdsdp_tpu.models.synthetic import maxcut_sdpa
    from hdsdp_tpu.solver.solver import HDSDPSolver

    data = maxcut_sdpa(n=120, seed=2)
    prob = SDPProblem.from_sdpa(data)
    r = HDSDPSolver(prob, verbose=False).optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert np.max(np.abs(r.dimacs)) < 1e-2


def test_control_class_end_to_end_lyapunov_oracle():
    """SDPLIB control-family structure: Lyapunov-operator coefficients
    (rank <= 4, full support — the multi-slot path).  For a single
    system the optimum is known in closed form: min tr(P) subject to
    -(A'P + PA) >= I is attained at the Lyapunov solution P* of
    A'P* + P*A = -I (any feasible P dominates P* by the integral
    representation), so the solver is checked against an independent
    oracle, not against itself."""
    import scipy.linalg
    from hdsdp_tpu.models.synthetic import control_sdpa
    from hdsdp_tpu.solver.solver import HDSDPSolver

    data = control_sdpa(k=10, n_sys=1, seed=7)
    prob = SDPProblem.from_sdpa(data)

    # reconstruct A from the generator's seed path for the oracle
    rng = np.random.default_rng(7)
    k = 10
    G = rng.normal(size=(k, k)) / np.sqrt(k)
    lam = 0.5 * np.linalg.norm(G + G.T, 2) + 0.5
    A = G - lam * np.eye(k)
    P_star = scipy.linalg.solve_lyapunov(A.T, -np.eye(k))
    opt = -np.trace(P_star)  # solver maximizes b'y = -tr(P)

    r = HDSDPSolver(prob, verbose=False).optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.d_obj == pytest.approx(opt, rel=1e-5)
    assert np.max(np.abs(r.dimacs)) < 1e-2


def test_control_multi_system_matches_reference_binary():
    """control-family with two Lyapunov systems (no closed form): golden
    objective from the reference binary run on the byte-identical
    instance on this machine (write_sdpa -> sdpasolve):

        control_sdpa(k=20, n_sys=2, seed=11)
        -> Primal dual optimal, dObj -7.9439715116, DIMACS max 7.3e-10
    """
    from hdsdp_tpu.models.synthetic import control_sdpa
    from hdsdp_tpu.solver.solver import HDSDPSolver

    prob = SDPProblem.from_sdpa(control_sdpa(k=20, n_sys=2, seed=11))
    r = HDSDPSolver(prob, verbose=False).optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.d_obj == pytest.approx(-7.9439715116, rel=1e-6)
    assert np.max(np.abs(r.dimacs)) < 1e-2


def test_torus_class_end_to_end():
    """SDPLIB torus-family structure (maxcut on a 3-D periodic lattice,
    m = n = side^3).  With all-(+1) weights the lattice is bipartite-free
    but the SDP bound is still sandwiched: the identity/4 is feasible
    (obj = <C, I/4> = -sum_i deg_i/16) and the bound must not exceed the
    trivial cut bound -(|E| + sum w)/8 ... here just gate DIMACS + sanity
    against the feasible-point objective."""
    from hdsdp_tpu.models.synthetic import torus_sdpa
    from hdsdp_tpu.solver.solver import HDSDPSolver

    data = torus_sdpa(side=3, seed=6)  # n = m = 27
    prob = SDPProblem.from_sdpa(data)
    r = HDSDPSolver(prob, verbose=False).optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert np.max(np.abs(r.dimacs)) < 1e-2
    # X = I/4 is feasible, so the minimum is <= <C, I/4> = -sum(deg)/16
    import numpy as _np
    blk = data.blocks[0]
    cmask = blk.con == 0
    diag = (blk.row == blk.col) & cmask
    c_dot_quarter_eye = float(_np.sum(blk.val[diag])) / 4.0
    assert r.d_obj <= c_dot_quarter_eye + 1e-6


def test_diag_bucket_matches_slot_path():
    """The O(m^2) diagonal rank-1 bucket (maxG*/torus* structure) must
    reproduce the generic slot-major path exactly (HUtilKKTCheck
    discipline) for M, RHS vectors, dual assembly, HSD components, and
    A(X)."""
    import jax.numpy as jnp
    from hdsdp_tpu.models.synthetic import maxcut_sdpa
    from hdsdp_tpu.ops import schur as schur_ops
    from hdsdp_tpu.solver.cones import ConeSystem

    prob = SDPProblem.from_sdpa(maxcut_sdpa(n=60, seed=7))
    cones = ConeSystem(prob)
    ga = cones.groups[0]
    assert ga.dpos is not None  # the diag bucket must engage on maxcut
    ga_slot = ConeSystem(prob, layout="slot").groups[0]

    rng = np.random.default_rng(2)
    n = ga.Fs.shape[2]
    Q = rng.standard_normal((n, n))
    U = jnp.asarray(Q @ Q.T + n * np.eye(n), jnp.float64)[None]
    y = jnp.asarray(rng.standard_normal(prob.m))

    a = schur_ops.group_schur(ga, U, prob.m, with_m=True)
    b = schur_ops.group_schur(ga_slot, U, prob.m, with_m=True)
    scale = float(jnp.max(jnp.abs(b.M)))
    assert float(jnp.max(jnp.abs(a.M - b.M))) < 1e-12 * scale
    np.testing.assert_allclose(np.asarray(a.asinv), np.asarray(b.asinv),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(a.trSAS), np.asarray(b.trSAS),
                               rtol=1e-12)

    Sa = schur_ops.group_dual(ga, -1.0, -1.0, y, 2.0)
    Sb = schur_ops.group_dual(ga_slot, -1.0, -1.0, y, 2.0)
    np.testing.assert_allclose(np.asarray(Sa), np.asarray(Sb),
                               rtol=1e-12, atol=1e-12)

    ha = schur_ops.group_hsd(ga, U, prob.m)
    hb = schur_ops.group_hsd(ga_slot, U, prob.m)
    np.testing.assert_allclose(np.asarray(ha.asinvcsinv),
                               np.asarray(hb.asinvcsinv), rtol=1e-12)

    xa = schur_ops.group_atx(ga, U, prob.m)
    xb = schur_ops.group_atx(ga_slot, U, prob.m)
    np.testing.assert_allclose(np.asarray(xa), np.asarray(xb), rtol=1e-12)


def test_support_bucket_matches_slot_path():
    """The bounded-support gather bucket (theta-family 2-nnz rank-2
    structure) must reproduce the generic slot-major path for M, RHS,
    dual assembly, HSD components, and A(X)."""
    import jax.numpy as jnp
    from hdsdp_tpu.models.synthetic import theta_sdpa
    from hdsdp_tpu.ops import schur as schur_ops
    from hdsdp_tpu.solver.cones import ConeSystem

    prob = SDPProblem.from_sdpa(theta_sdpa(n=40, n_edges=120, seed=3))
    cones = ConeSystem(prob)
    ga = cones.groups[0]
    assert ga.spos is not None  # support bucket must engage on theta
    ga_slot = ConeSystem(prob, layout="slot").groups[0]

    rng = np.random.default_rng(2)
    n = ga.Fs.shape[2]
    Q = rng.standard_normal((n, n))
    U = jnp.asarray(Q @ Q.T + n * np.eye(n), jnp.float64)[None]
    y = jnp.asarray(rng.standard_normal(prob.m))

    a = schur_ops.group_schur(ga, U, prob.m, with_m=True)
    b = schur_ops.group_schur(ga_slot, U, prob.m, with_m=True)
    scale = float(jnp.max(jnp.abs(b.M)))
    assert float(jnp.max(jnp.abs(a.M - b.M))) < 1e-12 * scale
    np.testing.assert_allclose(np.asarray(a.asinv), np.asarray(b.asinv), rtol=1e-11)
    np.testing.assert_allclose(np.asarray(a.trSAS), np.asarray(b.trSAS), rtol=1e-11)

    Sa = schur_ops.group_dual(ga, -1.0, -1.0, y, 2.0)
    Sb = schur_ops.group_dual(ga_slot, -1.0, -1.0, y, 2.0)
    np.testing.assert_allclose(np.asarray(Sa), np.asarray(Sb), rtol=1e-11, atol=1e-12)

    ha = schur_ops.group_hsd(ga, U, prob.m)
    hb = schur_ops.group_hsd(ga_slot, U, prob.m)
    np.testing.assert_allclose(np.asarray(ha.asinvcsinv),
                               np.asarray(hb.asinvcsinv), rtol=1e-11)

    xa = schur_ops.group_atx(ga, U, prob.m)
    xb = schur_ops.group_atx(ga_slot, U, prob.m)
    np.testing.assert_allclose(np.asarray(xa), np.asarray(xb), rtol=1e-11)


def test_gpp_class_matches_reference_binary():
    """SDPLIB gpp*/equalG* structure (diag constraints + a dense rank-1
    all-ones row with b=0, C = -Laplacian/4 — ref examples/gpp100.dat-s):
    golden objective from the reference binary run on the byte-identical
    instance on this machine (write_sdpa -> sdpasolve):

        gpp_sdpa(n=100, seed=1)
        -> Primal dual optimal, dObj -3.7773118717e+02
    """
    from hdsdp_tpu.models.synthetic import gpp_sdpa
    from hdsdp_tpu.solver.solver import HDSDPSolver

    prob = SDPProblem.from_sdpa(gpp_sdpa(n=100, seed=1))
    r = HDSDPSolver(prob, verbose=False).optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.d_obj == pytest.approx(-377.73118717, rel=1e-6)
    assert np.max(np.abs(r.dimacs)) < 1e-2


def test_qpg_class_matches_reference_binary():
    """SDPLIB qpG* structure (maxcut diag constraints relaxed through LP
    slacks: X_ii + s_i = 1/4 — every row couples the SDP diag bucket and
    the LP cone).  Golden objective from the reference binary run on the
    byte-identical instance on this machine (write_sdpa -> sdpasolve):

        qpg_sdpa(n=100, seed=1)
        -> Primal dual optimal, dObj -2.0912017164e+01
    """
    from hdsdp_tpu.models.synthetic import qpg_sdpa
    from hdsdp_tpu.solver.solver import HDSDPSolver

    prob = SDPProblem.from_sdpa(qpg_sdpa(n=100, seed=1))
    r = HDSDPSolver(prob, verbose=False).optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.d_obj == pytest.approx(-20.912017164, rel=1e-6)
    assert np.max(np.abs(r.dimacs)) < 1e-2


def test_support_bucket_compile_budget_fallback():
    """An instance whose coefficients have wide-support eigenvectors
    (4x4 dense patches: r=4 slots, c=4 nnz -> 160 unrolled gathered
    terms > SUPPORT_TERM_BUDGET) must SKIP the support bucket and fall
    back to the slot-major matmul path, still producing the same KKT as
    the flat layout."""
    import jax.numpy as jnp
    from hdsdp_tpu.io.sdpa import BlockEntries, SDPAData
    from hdsdp_tpu.solver.cones import SUPPORT_TERM_BUDGET, ConeSystem

    rng = np.random.default_rng(6)
    n, m = 16, 12
    con, row, col, val = [], [], [], []
    # objective: identity
    for i in range(n):
        con.append(0); row.append(i); col.append(i); val.append(1.0)
    # constraints: dense symmetric 4x4 patch at a rotating offset
    for k in range(1, m + 1):
        o = 4 * (k % 4)
        P = rng.standard_normal((4, 4))
        P = P + P.T
        for a in range(4):
            for b_ in range(a + 1):
                con.append(k); row.append(o + a); col.append(o + b_)
                val.append(P[a, b_])
    data = SDPAData(
        m=m, block_dims=[n], b=rng.standard_normal(m),
        blocks=[BlockEntries(dim=n, con=np.asarray(con, np.int32),
                             row=np.asarray(row, np.int32),
                             col=np.asarray(col, np.int32),
                             val=np.asarray(val))],
        nnz=len(val),
    )
    prob = SDPProblem.from_sdpa(data)
    cones = ConeSystem(prob)
    ga = cones.groups[0]
    r, c = ga.Fs.shape[0], 4
    assert (r * (r + 1) // 2) * c * c > SUPPORT_TERM_BUDGET
    assert ga.spos is None  # budget guard fell back to slot-major
    assert ga.dpos is None

    # slot-major result must still match the flat layout elementwise
    flat = ConeSystem(prob, layout="flat")
    y = jnp.asarray(rng.standard_normal(m) * 0.01)
    shift = 10.0 + prob.features.obj_fro_norm
    S1, _ = cones.assemble(1.0, -1.0, y, shift)
    S2, _ = flat.assemble(1.0, -1.0, y, shift)
    np.testing.assert_allclose(np.asarray(S1[0]), np.asarray(S2[0]),
                               atol=1e-12)
    ok1, L1 = cones.factor(S1, None)
    ok2, L2 = flat.factor(S2, None)
    assert bool(ok1) and bool(ok2)
    k1 = cones.build_kkt(L1, None, -1.3, "inf")
    k2 = flat.build_kkt(L2, None, -1.3, "inf")
    scale = max(1.0, float(jnp.max(jnp.abs(k2.M))))
    np.testing.assert_allclose(np.asarray(k1.M), np.asarray(k2.M),
                               atol=1e-10 * scale)
    np.testing.assert_allclose(np.asarray(k1.asinv), np.asarray(k2.asinv),
                               atol=1e-10)
