"""End-to-end golden-objective tests on the in-repo SDPA instances
(tests/data, written by tests/instances.py).

Goldens are independent of this code (closed forms, a Lyapunov solve, or
the reference binary on the byte-identical instance; see
tests/instances.py), gated at the reference's DIMACS acceptance level
of 1e-2 (ref interface/hdsdp.c:905-921).  Instances without a closed
form are checked by an independent numpy primal-dual certificate.
"""

import numpy as np
import pytest

import instances
from hdsdp_tpu.io.sdpa import read_sdpa
from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.solver.solver import HDSDPSolver, solve_sdpa_file


@pytest.mark.parametrize("fname", sorted(instances.SDP_GOLDEN))
def test_golden_solve(fname):
    obj = instances.sdp_golden(fname)
    r = solve_sdpa_file(instances.path(fname), verbose=False)
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    assert r.d_obj == pytest.approx(obj, rel=1e-6)
    assert r.p_obj == pytest.approx(obj, rel=1e-5)
    assert np.max(np.abs(r.dimacs)) < 1e-2
    assert r.n_iters < 100


@pytest.mark.parametrize("fname", ["maxcut100.dat-s", "theta50.dat-s"])
def test_certified_primal_dual_pair(fname):
    """No closed form: the returned (X, y) must certify b'y by weak
    duality, checked with numpy on the raw file data alone."""
    data = read_sdpa(instances.path(fname))
    solver = HDSDPSolver(SDPProblem.from_sdpa(data), verbose=False)
    r = solver.optimize()
    assert r.status == "PRIMAL_DUAL_OPTIMAL"
    X_blocks, _ = solver.get_primal()
    errs = instances.certificate(data, X_blocks, solver.get_row_dual())
    assert max(errs) < 1e-6, errs
    assert r.n_iters <= 50


def test_batch_min_eval_fast_path_matches_exact():
    """The large-block min-eigenvalue fast path (f32 eigh + f64 Rayleigh
    refinement) must agree with exact f64 eigh far below the DIMACS gate,
    including indefinite and near-singular spectra."""
    import jax.numpy as jnp

    from hdsdp_tpu.solver import dimacs

    n = dimacs._EXACT_EIG_DIM + 16  # forces the fast path
    rng = np.random.default_rng(11)
    for spec in (
        np.linspace(1e-9, 5.0, n),          # PSD, clustered bottom
        np.linspace(-3e-3, 4.0, n),         # indefinite at gate scale
        np.r_[np.full(8, 1e-7), np.linspace(0.5, 2.0, n - 8)],  # bottom cluster
    ):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        X = jnp.asarray((Q * spec) @ Q.T, jnp.float64)[None]
        X = 0.5 * (X + jnp.swapaxes(X, -1, -2))
        fast = float(dimacs._batch_min_eval(X))
        exact = float(jnp.min(jnp.linalg.eigvalsh(X)))
        assert fast == pytest.approx(exact, abs=1e-6 * max(1.0, abs(spec).max()))


def test_lanczos_min_eval_matches_exact():
    """The huge-block Lanczos min-eigenvalue estimate (no dense eig at
    any n — the n >= 8192 DIMACS path) must locate lambda_min well below
    the 1e-2 DIMACS acceptance gate on PSD, indefinite and clustered
    spectra."""
    import jax.numpy as jnp

    from hdsdp_tpu.solver import dimacs

    n = 1024
    rng = np.random.default_rng(5)
    for spec in (
        np.linspace(1e-9, 5.0, n),          # PSD, clustered bottom
        np.linspace(-3e-3, 4.0, n),         # indefinite at gate scale
        np.r_[np.full(8, -1e-5), np.linspace(0.5, 2.0, n - 8)],  # neg cluster
    ):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        X = jnp.asarray((Q * spec) @ Q.T, jnp.float64)
        X = 0.5 * (X + X.T)
        est = float(dimacs._lanczos_min_one(X))
        exact = float(jnp.min(jnp.linalg.eigvalsh(X)))
        # resolves to ~1e-4 ||X|| on clustered bottoms; the value feeds
        # a 1e-2 acceptance gate, and the estimate never understates
        # negativity direction (Rayleigh quotient >= lambda_min)
        assert est >= exact - 1e-12
        assert est == pytest.approx(exact, abs=2e-4 * max(1.0, abs(spec).max()))


def test_certified_min_eval_brackets_violation():
    """The try-Cholesky certificate (ref hdsdp_linsolver.c:1112-1144 on
    X + dI) must return a LOWER bound on lambda_min that is within one
    ladder decade of the truth — including the adversarial near-PSD case
    where a tiny negative eigenvalue hides in a clustered bottom (the
    case an unconverged Lanczos sweep can miss entirely)."""
    import jax.numpy as jnp

    from hdsdp_tpu.solver import dimacs

    n = 512
    rng = np.random.default_rng(23)
    for lam_min in (1e-3, -1e-8, -1e-6, -1e-3):
        # adversarial: the negative direction sits inside a cluster of
        # near-zero eigenvalues of the same magnitude
        spec = np.r_[lam_min, np.full(16, abs(lam_min) * 2),
                     np.linspace(0.5, 2.0, n - 17)]
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        X = jnp.asarray((Q * spec) @ Q.T, jnp.float64)
        X = 0.5 * (X + X.T)
        # est deliberately optimistic (simulates a missed-negativity
        # Lanczos sweep): the certificate must still catch the violation
        got = dimacs._certified_block_min_eval(X, est=0.0)
        assert got <= lam_min + 1e-12  # never under-reports the violation
        if lam_min < 0:
            # over-report bounded by the decade ladder + rounding slack
            assert got >= 20.0 * lam_min - 1e-10
