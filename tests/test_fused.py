"""Fused whole-phase programs must agree with the host-driven reference
loop (same statuses, objectives to solver tolerance, similar iteration
counts) on fixtures and synthetic instances."""

import numpy as np
import pytest

import instances
from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.models.synthetic import random_sdpa
from hdsdp_tpu.solver.solver import HDSDPSolver, solve_sdpa_file


@pytest.mark.parametrize("fname", ["theta50.dat-s", "control10.dat-s"])
def test_fused_matches_host_on_fixture(fname):
    rf = solve_sdpa_file(instances.path(fname), verbose=False, fused=True)
    rh = solve_sdpa_file(instances.path(fname), verbose=False, fused=False)
    assert rf.status == rh.status == "PRIMAL_DUAL_OPTIMAL"
    assert rf.d_obj == pytest.approx(rh.d_obj, rel=1e-7)
    assert abs(rf.n_iters - rh.n_iters) <= 5
    assert np.max(np.abs(rf.dimacs)) < 1e-2


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_matches_host_synthetic(seed):
    data = random_sdpa(m=24, block_dims=[10, 6], n_lp=5, seed=seed)
    prob = SDPProblem.from_sdpa(data)
    rf = HDSDPSolver(prob, verbose=False, fused=True).optimize()
    rh = HDSDPSolver(prob, verbose=False, fused=False).optimize()
    assert rf.status == rh.status == "PRIMAL_DUAL_OPTIMAL"
    assert rf.d_obj == pytest.approx(rh.d_obj, rel=1e-6)


def test_fused_psdp_handoff():
    """PSDP-eligible shape: the fused Phase B must hand off and refine."""
    data = random_sdpa(m=30, block_dims=[8], n_lp=0, seed=4)
    prob = SDPProblem.from_sdpa(data)
    solver = HDSDPSolver(prob, verbose=False, fused=True)
    r = solver.optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert np.max(np.abs(r.dimacs)) < 1e-2


def test_fused_gpp100():
    """gpp100 has a C with nontrivial structure; fused must hit golden."""
    r = solve_sdpa_file(instances.path("gpp100.dat-s"), verbose=False, fused=True)
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.d_obj == pytest.approx(instances.sdp_golden("gpp100.dat-s"), rel=1e-6)


def test_dual_only_mode():
    """d_only stops at a dual solution (ref HDSDPOptimize dOptOnly)."""
    data = random_sdpa(m=20, block_dims=[10], seed=12)
    prob = SDPProblem.from_sdpa(data)
    r = HDSDPSolver(prob, verbose=False).optimize(d_only=True)
    assert r.status in ("PRIMAL_DUAL_OPTIMAL", "DUAL_OPTIMAL", "DUAL_FEASIBLE")


def test_iter_mode_matches_phase_mode():
    """Iteration-fused and whole-phase programs share the same body and
    must agree bitwise on the iterates."""
    data = random_sdpa(m=24, block_dims=[10, 6], n_lp=5, seed=3)
    prob = SDPProblem.from_sdpa(data)
    rp = HDSDPSolver(prob, verbose=False, fused="phase").optimize()
    ri = HDSDPSolver(prob, verbose=False, fused="iter").optimize()
    assert rp.status == ri.status == "PRIMAL_DUAL_OPTIMAL"
    assert rp.n_iters == ri.n_iters
    assert rp.d_obj == pytest.approx(ri.d_obj, rel=1e-12)


def test_program_cache_not_poisoned_across_problems():
    """Two problems with IDENTICAL bucketed shapes but different data must
    both solve correctly in the same process: the cached fused programs
    take the cone data as runtime arguments, not baked-in constants."""
    da = random_sdpa(m=16, block_dims=[8], n_lp=0, seed=21)
    db = random_sdpa(m=16, block_dims=[8], n_lp=0, seed=22)
    pa = SDPProblem.from_sdpa(da)
    pb = SDPProblem.from_sdpa(db)
    ra = HDSDPSolver(pa, verbose=False, fused=True).optimize()
    rb = HDSDPSolver(pb, verbose=False, fused=True).optimize()
    # cross-check against fresh host-loop solves
    ha = HDSDPSolver(pa, verbose=False, fused=False).optimize()
    hb = HDSDPSolver(pb, verbose=False, fused=False).optimize()
    assert ra.d_obj == pytest.approx(ha.d_obj, rel=1e-6)
    assert rb.d_obj == pytest.approx(hb.d_obj, rel=1e-6)
    assert abs(ra.d_obj - rb.d_obj) > 1e-6  # genuinely different problems


def test_fused_iters_match_host_loop_maxcut():
    """The fused programs and the f64 host loop take the same iterations
    to within 2 on a maxcut instance (the same tolerance the GPU smoke
    test holds maxG51 to against the host loop on the CPU): the two
    drivers mirror each other, and only summation order differs."""
    from hdsdp_tpu.models.synthetic import maxcut_sdpa

    prob = SDPProblem.from_sdpa(maxcut_sdpa(n=120, seed=0))
    rf = HDSDPSolver(prob, verbose=False).optimize()
    rh = HDSDPSolver(prob, verbose=False, fused=False).optimize()
    assert rf.status == rh.status == "PRIMAL_DUAL_OPTIMAL"
    assert abs(rf.n_iters - rh.n_iters) <= 2
    assert rf.d_obj == pytest.approx(rh.d_obj, rel=1e-7)
