"""Lanczos step-length bound: conservative, tight on well-separated
spectra, and usable end-to-end via ratio_test='lanczos'."""

import jax.numpy as jnp
import numpy as np
import pytest

from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.models.synthetic import random_sdpa
from hdsdp_tpu.ops.ratio import block_ratio, exact_ratio_test, lanczos_ratio_test
from hdsdp_tpu.solver.solver import HDSDPSolver


def _case(n, seed):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, n))
    S = G @ G.T + n * np.eye(n)
    L = jnp.asarray(np.linalg.cholesky(S))
    D = rng.normal(size=(n, n))
    dS = jnp.asarray(-(D + D.T))  # generic indefinite direction
    return L, dS


@pytest.mark.parametrize("n", [32, 96])
def test_lanczos_bound_is_conservative_and_tight(n):
    L, dS = _case(n, seed=n)
    exact = float(exact_ratio_test(L[None], dS[None])[0])
    v0 = jnp.ones((1, n))
    lz, _ = lanczos_ratio_test(L[None], dS[None], v0, krylov=30)
    lz = float(lz[0])
    assert lz <= exact * (1 + 1e-9)  # never overshoots the boundary
    assert lz >= 0.5 * exact  # and is not hopelessly loose


def test_block_ratio_dispatch():
    L, dS = _case(64, seed=7)
    a = block_ratio(L[None], dS[None], mode="exact")
    b = block_ratio(L[None], dS[None], mode="lanczos")
    assert float(b[0]) <= float(a[0]) * (1 + 1e-9)


def test_solve_with_lanczos_ratio():
    prob = SDPProblem.from_sdpa(random_sdpa(m=20, block_dims=[12], seed=9))
    r_lz = HDSDPSolver(prob, verbose=False, ratio_test="lanczos").optimize()
    r_ex = HDSDPSolver(prob, verbose=False, ratio_test="exact").optimize()
    assert r_lz.status == "PRIMAL_DUAL_OPTIMAL"
    assert r_lz.d_obj == pytest.approx(r_ex.d_obj, rel=1e-6)


@pytest.mark.parametrize("n", [64, 224])
def test_adaptive_warm_start_matches_exact(n):
    """Early-exit adaptive kernel (ref hdsdp_lanczos.c:186-292): the
    bound stays conservative from both cold and warm starts, and the
    returned Ritz image seeds the next call."""
    from hdsdp_tpu.ops.ratio import lanczos_ratio_test_adaptive

    L, dS = _case(n, seed=n + 1)
    exact = float(exact_ratio_test(L[None], dS[None])[0])
    v0 = jnp.ones((1, n))
    st1, warm = lanczos_ratio_test_adaptive(L[None], dS[None], v0, krylov=30)
    assert float(st1[0]) <= exact * (1 + 1e-9)
    assert float(st1[0]) >= 0.5 * exact
    # warm restart on a nearby system (next-IPM-iteration analogue)
    st2, _ = lanczos_ratio_test_adaptive(
        L[None], 0.9 * dS[None], warm, krylov=30
    )
    exact2 = exact / 0.9
    assert float(st2[0]) <= exact2 * (1 + 1e-9)
    assert float(st2[0]) >= 0.5 * exact2


def test_cone_system_carries_warm_start():
    """ConeSystem.ratio_test must record per-group warm vectors after a
    Lanczos-mode call (ref HLanczos->dLanczosWarmStart)."""
    from hdsdp_tpu.solver.cones import ConeSystem

    prob = SDPProblem.from_sdpa(random_sdpa(m=16, block_dims=[16], seed=3))
    cones = ConeSystem(prob)
    cones.ratio_mode = "lanczos"
    S, s_lp = cones.assemble(1.0, 0.0, jnp.zeros(prob.m), 1e2)
    from hdsdp_tpu.solver.cones import _factor

    ok, L = _factor(S, s_lp)
    dS = tuple(-0.1 * Sg for Sg in S)
    step1 = float(cones.ratio_test(L, s_lp, dS, None))
    assert cones._lz_warm[0] is not None
    step2 = float(cones.ratio_test(L, s_lp, dS, None))
    assert step2 == pytest.approx(step1, rel=1e-2)


def test_built_block_filler_stays_on_scale():
    """The adaptive Lanczos eigendecomposes its partly built Krylov
    matrix with the unbuilt rows replaced by a filler: the top eigenpairs
    must be the built block's, and the filler must stay on its scale
    (a norm-relative Jacobi eigh, as GPUs use for small matrices, does
    not converge on the built block next to a huge filler)."""
    from hdsdp_tpu.ops.ratio import _built_block

    k, i = 12, 4
    rng = np.random.default_rng(8)
    a = rng.normal(size=k + 1) * 1e3
    b = np.abs(rng.normal(size=k))
    T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    B = np.asarray(_built_block(jnp.asarray(T), i, k))
    blk = T[: i + 1, : i + 1]
    np.testing.assert_allclose(np.linalg.eigvalsh(B)[-2:],
                               np.linalg.eigvalsh(blk)[-2:], rtol=1e-12)
    assert np.abs(B).max() <= 2.0 * (np.abs(blk).sum(axis=1).max() + 1.0)
