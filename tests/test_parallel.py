"""Multi-chip path: sharded Schur assembly must match the single-chip
assembly elementwise on an 8-virtual-device CPU mesh, and a sharded
end-to-end solve must reach the same optimum."""

import jax.numpy as jnp
import numpy as np
import pytest

import instances
from hdsdp_tpu.io.sdpa import read_sdpa
from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.models.synthetic import random_sdpa
from hdsdp_tpu.parallel import ShardedConeSystem, make_mesh
from hdsdp_tpu.solver.cones import ConeSystem
from hdsdp_tpu.solver.solver import HDSDPSolver


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.mark.parametrize("fname", ["theta50.dat-s", "control10.dat-s"])
def test_sharded_kkt_matches_single(mesh, fname):
    data = read_sdpa(instances.path(fname))
    prob = SDPProblem.from_sdpa(data)
    ref = ConeSystem(prob)
    sh = ShardedConeSystem(prob, mesh)

    rng = np.random.default_rng(11)
    y = jnp.asarray(rng.normal(size=prob.m) * 0.01)
    shift = 10.0 + prob.features.obj_fro_norm

    S1, s1 = ref.assemble(1.0, -1.0, y, shift)
    S2, s2 = sh.assemble(1.0, -1.0, y, shift)
    for a, b in zip(S1, S2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    if s1 is not None:
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), atol=1e-12)

    ok1, L1 = ref.factor(S1, s1)
    ok2, L2 = sh.factor(S2, s2)
    assert bool(ok1) and bool(ok2)

    m = prob.m
    for kind in ("hsd", "inf", "corr"):
        k1 = ref.build_kkt(L1, s1, -1.3, kind)
        k2 = sh.build_kkt(L2, s2, -1.3, kind)
        if kind != "corr":
            # the multi-block path must also hand M out row-sharded:
            # psum_scatter, not psum (no device holds every row)
            spec = k2.M.sharding.spec
            assert spec[0] == "row", f"M not row-sharded: {k2.M.sharding}"
            nrows_local = max(s.data.shape[0] for s in k2.M.addressable_shards)
            assert nrows_local < m
            scale = max(1.0, float(jnp.max(jnp.abs(k1.M))))
            np.testing.assert_allclose(
                np.asarray(k2.M)[:m, :m], np.asarray(k1.M), atol=1e-9 * scale
            )
            # identity tail on the padding rows
            pad = k2.M.shape[0] - m
            if pad:
                np.testing.assert_allclose(
                    np.asarray(k2.M)[m:, m:], np.eye(pad), atol=1e-12
                )
                assert float(jnp.max(jnp.abs(k2.M[m:, :m]))) == 0.0
        np.testing.assert_allclose(
            np.asarray(k2.asinv), np.asarray(k1.asinv), atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(k2.asinvrdsinv), np.asarray(k1.asinvrdsinv), atol=1e-9
        )
        assert float(k2.trace_sinv) == pytest.approx(float(k1.trace_sinv), rel=1e-10)
        if kind == "hsd":
            np.testing.assert_allclose(
                np.asarray(k2.asinvcsinv), np.asarray(k1.asinvcsinv), atol=1e-9
            )
            for f in ("csinv", "csinvcsinv", "csinvrdsinv"):
                assert float(getattr(k2, f)) == pytest.approx(
                    float(getattr(k1, f)), rel=1e-9, abs=1e-12
                )


def test_sharded_end_to_end(mesh):
    data = random_sdpa(m=20, block_dims=[10, 6], n_lp=4, seed=5)
    prob = SDPProblem.from_sdpa(data)
    r_ref = HDSDPSolver(prob, verbose=False).optimize()
    r_sh = HDSDPSolver(prob, mesh=mesh, verbose=False).optimize()
    assert r_sh.status == "PRIMAL_DUAL_OPTIMAL"
    assert r_sh.d_obj == pytest.approx(r_ref.d_obj, rel=1e-6)


def test_graft_entry_and_dryrun():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    import jax

    fn, args = ge.entry()
    dy, ok = jax.jit(fn)(*args)
    assert bool(ok)
    assert bool(jnp.all(jnp.isfinite(dy)))
    ge.dryrun_multichip(8)


def test_distributed_cholesky(mesh):
    """Blocked right-looking Cholesky with panel psum/all_gather must
    match a direct solve, including the non-PSD predicate."""
    from hdsdp_tpu.parallel.dchol import sharded_cholesky, sharded_chol_solve

    rng = np.random.default_rng(0)
    m = 217  # uneven: exercises the identity-tail padding
    A = rng.normal(size=(m, m))
    M = jnp.asarray(A @ A.T + m * np.eye(m))
    fac = sharded_cholesky(mesh, M, block=32)
    assert bool(fac.ok)
    rhs = jnp.asarray(rng.normal(size=(m, 3)))
    x = sharded_chol_solve(fac, rhs)
    x_ref = np.linalg.solve(np.asarray(M), np.asarray(rhs))
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-10)
    # single-vector RHS path
    x1 = sharded_chol_solve(fac, rhs[:, 0])
    np.testing.assert_allclose(np.asarray(x1), x_ref[:, 0], atol=1e-10)
    # non-PSD must be flagged, not silently NaN
    bad = sharded_cholesky(mesh, jnp.asarray(A @ A.T - 1e3 * np.eye(m)), block=32)
    assert not bool(bad.ok)


@pytest.mark.parametrize("family", ["theta", "maxcut"])
def test_row_sharded_kkt_matches_single(mesh, family):
    """RowShardedConeSystem: M is born row-sharded (no device holds all
    rows) and matches the single-chip build elementwise.  theta covers
    the bounded-support bucket, maxcut the identity-diagonal bucket."""
    from hdsdp_tpu.models.synthetic import maxcut_sdpa, theta_sdpa
    from hdsdp_tpu.parallel.schur import RowShardedConeSystem

    data = (
        theta_sdpa(n=50, n_edges=300, seed=4)
        if family == "theta"
        else maxcut_sdpa(n=96, seed=4)
    )
    prob = SDPProblem.from_sdpa(data)
    ref = ConeSystem(prob)
    sh = RowShardedConeSystem(prob, mesh)

    rng = np.random.default_rng(7)
    y = jnp.asarray(rng.normal(size=prob.m) * 0.01)
    shift = 10.0 + prob.features.obj_fro_norm
    S1, s1 = ref.assemble(1.0, -1.0, y, shift)
    S2, s2 = sh.assemble(1.0, -1.0, y, shift)
    for a, b in zip(S1, S2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    ok1, L1 = ref.factor(S1, s1)
    ok2, L2 = sh.factor(S2, s2)
    assert bool(ok1) and bool(ok2)
    for kind in ("inf", "hsd", "corr"):
        k1 = ref.build_kkt(L1, s1, -1.3, kind)
        k2 = sh.build_kkt(L2, s2, -1.3, kind)
        if kind != "corr":
            # the Schur matrix must be row-sharded over the mesh
            spec = k2.M.sharding.spec
            assert spec[0] == "row", f"M not row-sharded: {k2.M.sharding}"
            nrows_local = max(
                s.data.shape[0] for s in k2.M.addressable_shards
            )
            assert nrows_local < prob.m  # no device holds every row
            scale = max(1.0, float(jnp.max(jnp.abs(k1.M))))
            m = prob.m  # mesh M is padded with an identity tail
            np.testing.assert_allclose(
                np.asarray(k2.M)[:m, :m], np.asarray(k1.M),
                atol=1e-9 * scale,
            )
        np.testing.assert_allclose(
            np.asarray(k2.asinv), np.asarray(k1.asinv), atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(k2.asinvrdsinv), np.asarray(k1.asinvrdsinv), atol=1e-9
        )


def test_mesh_hsd_path(mesh):
    """A dual-infeasible multi-block instance must traverse the HSD
    phase (Phase A') under a mesh: the hsd KKT build exercises the
    sharded asinvcsinv/csinv kernels end-to-end."""
    from hdsdp_tpu.io.sdpa import BlockEntries, SDPAData

    # block 1: C=[[0,1],[1,0]], A1=diag(1,0) -> det(C - y A1) = -1 for
    # all y: no dual interior, the HSD method must engage.  block 2 is a
    # benign identity block that makes the problem multi-block (routes
    # through ShardedConeSystem instead of the row-sharded system).
    data = SDPAData(
        m=1, block_dims=[2, 3], b=np.array([1.0]),
        blocks=[
            BlockEntries(
                dim=2,
                con=np.array([0, 1], np.int32),
                row=np.array([1, 0], np.int32),
                col=np.array([0, 0], np.int32),
                val=np.array([1.0, 1.0]),
            ),
            BlockEntries(
                dim=3,
                con=np.zeros(3, np.int32),
                row=np.arange(3, dtype=np.int32),
                col=np.arange(3, dtype=np.int32),
                val=np.ones(3),
            ),
        ],
        nnz=5,
    )
    prob = SDPProblem.from_sdpa(data)
    solver = HDSDPSolver(prob, mesh=mesh, verbose=False)
    r = solver.optimize()
    assert r.status in ("INFEAS_OR_UNBOUNDED", "SUSPECT_INFEAS_OR_UNBOUNDED")
    assert solver.ipm.which_method == "hsd"  # Phase A' actually ran


def test_mesh_psdp_handoff(mesh):
    """A theta-class instance (single cone, m >> n: the PSDP-eligible
    shape, ref hdsdp.c:153-159) solved under a mesh must hand off to
    PSDP from the host loop, with the primal KKT factored through the
    distributed path, and reach the single-chip optimum."""
    from hdsdp_tpu.models.synthetic import theta_sdpa

    data = theta_sdpa(n=40, n_edges=200, seed=9)
    prob = SDPProblem.from_sdpa(data)
    assert prob.features.n_max_cone_dim < prob.features.n_rows / 3
    r_ref = HDSDPSolver(prob, verbose=False).optimize()
    solver = HDSDPSolver(prob, mesh=mesh, verbose=False)
    r = solver.optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    # the hand-off must actually have happened and produced a primal X
    assert solver.ipm.psdp is not None and solver.ipm.psdp.X is not None
    assert r.d_obj == pytest.approx(r_ref.d_obj, rel=1e-5)
    assert np.max(np.abs(r.dimacs)) < 1e-2


def test_row_sharded_end_to_end(mesh):
    """Theta-class instance solved on the mesh with the distributed
    Cholesky must match the single-chip optimum."""
    from hdsdp_tpu.models.synthetic import theta_sdpa

    data = theta_sdpa(n=40, n_edges=200, seed=9)
    prob = SDPProblem.from_sdpa(data)
    r_ref = HDSDPSolver(prob, verbose=False).optimize()
    r_sh = HDSDPSolver(prob, mesh=mesh, verbose=False).optimize()
    assert r_sh.status == "PRIMAL_DUAL_OPTIMAL"
    # paths differ (fused single-chip vs host-loop mesh): same optimum
    # within solver tolerance
    assert r_sh.d_obj == pytest.approx(r_ref.d_obj, rel=1e-5)
    assert np.max(np.abs(r_sh.dimacs)) < 1e-2


def test_mesh_operator_mode_end_to_end(mesh):
    """Operator mode (matrix-free KKT) composed with the mesh: the
    per-group inverses are row-resharded so the operator matvec
    partitions across devices, and M never materializes anywhere —
    the e2e optimum must match the single-chip dense path."""
    from hdsdp_tpu.models.synthetic import theta_sdpa

    data = theta_sdpa(n=40, n_edges=200, seed=9)
    prob = SDPProblem.from_sdpa(data)
    r_ref = HDSDPSolver(prob, verbose=False).optimize()
    s = HDSDPSolver(prob, mesh=mesh, kkt_mode="free", verbose=False)
    r = s.optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.d_obj == pytest.approx(r_ref.d_obj, rel=1e-5)
    # memory contract: the solve ran the operator CG (never a factor of
    # a materialized M), and the operator's U = S^-1 is sharded over the
    # row axis on the mesh
    assert s.ipm.kkt_free
    assert r.stats.get("opcg_iters", 0) > 0
    ipm = s.ipm
    S, s_lp = ipm.cones.assemble(1.0, -1.0, ipm.y, 1e-4)
    ok, L = ipm.cones.factor(S, s_lp)
    Us = ipm.cones.inverses(L)
    shard = Us[0].addressable_shards[0].data
    assert shard.shape[1] < Us[0].shape[1]  # row axis split across devices
