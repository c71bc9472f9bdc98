"""Dual ratio test: max alpha with S + alpha * dS >= 0.

Equivalent to lambda_max of -L^{-1} dS L^{-T} (ref linalg/hdsdp_lanczos.c:
HLanczosSolve, and the matvec in hdsdp_conic_sdp.c:462-505): the step is
1 / lambda_max when positive, +inf otherwise.

Two implementations:
  * exact_ratio_test: batched eigh of the congruence (exact; O(n^3), same
    order as the Cholesky work already done per iteration);
  * lanczos_ratio_test: fixed-size Krylov iteration under jit, mirroring
    the reference's 30-dim Lanczos with residual-based safeguard
    (ref hdsdp_lanczos.c:161-292), preferable for large n.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from hdsdp_tpu.ops.chol import congruence

INF_STEP = 1e30


def exact_ratio_test(L: jnp.ndarray, dS: jnp.ndarray) -> jnp.ndarray:
    """Per-matrix max step, batched over leading dims. Returns [...]."""
    B = congruence(L, dS)
    B = 0.5 * (B + jnp.swapaxes(B, -1, -2))
    w = jnp.linalg.eigvalsh(B)
    lam_min = w[..., 0]
    return jnp.where(lam_min < 0.0, -1.0 / jnp.minimum(lam_min, -1e-300), INF_STEP)


def _matvec(L, dS, x):
    """y = L^{-1} (-dS) L^{-T} x, batched over the leading dim of x."""
    u = solve_triangular(L, x[..., None], lower=True, trans=1)[..., 0]
    v = -jnp.einsum("...ij,...j->...i", dS, u)
    return solve_triangular(L, v[..., None], lower=True)[..., 0]


@partial(jax.jit, static_argnames=("krylov",))
def lanczos_ratio_test(L: jnp.ndarray, dS: jnp.ndarray, v0: jnp.ndarray, krylov: int = 30):
    """Batched Lanczos bound on the max step (conservative, like the ref).

    Runs a fixed `krylov`-dimensional Lanczos recurrence on
    M = L^{-1}(-dS)L^{-T}; the returned step is 1/(lam_max + gamma) with the
    residual-based safeguard gamma of the reference (hdsdp_lanczos.c:262-283).
    v0 is the (batched) start vector; returns (steps [...], new warm start).
    """
    batch = L.shape[:-2]
    n = L.shape[-1]
    k = min(krylov, n)

    v = v0 / jnp.linalg.norm(v0, axis=-1, keepdims=True)
    V0 = jnp.zeros(batch + (k + 1, n), dtype=L.dtype).at[..., 0, :].set(v)
    T0 = jnp.zeros(batch + (k + 1, k + 1), dtype=L.dtype)

    def body(i, carry):
        V, T = carry
        vi = V[..., i, :]
        w = _matvec(L, dS, vi)
        w = w - jnp.where(i > 0, 1.0, 0.0) * T[..., i, i - 1][..., None] * V[..., i - 1, :]
        alpha = jnp.sum(w * vi, axis=-1)
        w = w - alpha[..., None] * vi
        # full reorthogonalization for robustness (cheap at k<=30)
        proj = jnp.einsum("...kn,...n->...k", V, w)
        w = w - jnp.einsum("...k,...kn->...n", proj, V)
        beta = jnp.linalg.norm(w, axis=-1)
        vnext = jnp.where(beta[..., None] > 0, w / jnp.maximum(beta, 1e-300)[..., None], w)
        T = T.at[..., i, i].set(alpha)
        T = T.at[..., i + 1, i].set(beta)
        T = T.at[..., i, i + 1].set(beta)
        V = V.at[..., i + 1, :].set(vnext)
        return V, T

    V, T = jax.lax.fori_loop(0, k, body, (V0, T0))

    Tk = T[..., :k, :k]
    w_eigs, Y = jnp.linalg.eigh(Tk)
    lam1 = w_eigs[..., -1]
    lam2 = w_eigs[..., -2] if k > 1 else lam1

    y1 = Y[..., :, -1]
    z1 = jnp.einsum("...kn,...k->...n", V[..., :k, :], y1)
    Mz1 = _matvec(L, dS, z1)
    r1 = jnp.linalg.norm(Mz1 - lam1[..., None] * z1, axis=-1)

    y2 = Y[..., :, -2] if k > 1 else y1
    z2 = jnp.einsum("...kn,...k->...n", V[..., :k, :], y2)
    Mz2 = _matvec(L, dS, z2)
    r2 = jnp.linalg.norm(Mz2 - lam2[..., None] * z2, axis=-1)

    # residual-based bound on the eigengap (ref hdsdp_lanczos.c:262-267)
    gap = jnp.maximum(lam1 - lam2 - r2, 1e-16)
    gamma = jnp.minimum(r1, r1 * r1 / gap)

    lam_bound = lam1 + gamma
    step = jnp.where(lam_bound > 0.0, 1.0 / jnp.maximum(lam_bound, 1e-300), INF_STEP)
    return step, Mz1


def _built_block(T, i, k: int):
    """T[:k,:k] with rows/cols > i zeroed and their diagonal set below the
    built block's spectrum (-2 * (max row sum + 1)), so that the top
    eigenpairs are the built block's.  The filler stays on the built
    block's scale: an eigh whose stopping test is relative to the whole
    matrix's norm (a Jacobi eigh, as GPUs use for small matrices) leaves
    the built block undiagonalized next to a huge filler."""
    idx = jnp.arange(k)
    off = idx > i  # rows beyond the built subspace
    Tm = jnp.where(off[:, None] | off[None, :], 0.0, T[..., :k, :k])
    pad = -2.0 * (jnp.max(jnp.sum(jnp.abs(Tm), axis=-1), axis=-1) + 1.0)
    filler = jnp.where(off, pad[..., None], 0.0)
    return Tm + filler[..., None] * jnp.eye(k, dtype=T.dtype)


@partial(jax.jit, static_argnames=("krylov", "check_freq"))
def lanczos_ratio_test_adaptive(
    L: jnp.ndarray,
    dS: jnp.ndarray,
    v0: jnp.ndarray,
    krylov: int = 30,
    check_freq: int = 3,
):
    """Early-exit Lanczos bound (ref hdsdp_lanczos.c:186-292).

    Identical recurrence to lanczos_ratio_test, but a lax.while_loop
    stops as soon as every matrix in the batch has a converged top Ritz
    pair: the reference checks |beta_k * y1[k]| < 1e-4 every
    min(maxdim/5, 3) steps.  With a warm start from the previous IPM
    iteration this typically exits in <= 2 checks, cutting the dominant
    matvec (two triangular solves) count ~3x near convergence.
    """
    batch = L.shape[:-2]
    n = L.shape[-1]
    k = min(krylov, n)

    v = v0 / jnp.linalg.norm(v0, axis=-1, keepdims=True)
    V0 = jnp.zeros(batch + (k + 1, n), dtype=L.dtype).at[..., 0, :].set(v)
    T0 = jnp.zeros(batch + (k + 1, k + 1), dtype=L.dtype)

    def masked_tri(T, i):
        return _built_block(T, i, k)

    def step_i(V, T, i):
        vi = jnp.take(V, i, axis=-2)
        w = _matvec(L, dS, vi)
        bprev = jnp.take(jnp.take(T, i, axis=-2), jnp.maximum(i - 1, 0), axis=-1)
        vprev = jnp.take(V, jnp.maximum(i - 1, 0), axis=-2)
        w = w - jnp.where(i > 0, 1.0, 0.0) * bprev[..., None] * vprev
        alpha = jnp.sum(w * vi, axis=-1)
        w = w - alpha[..., None] * vi
        proj = jnp.einsum("...kn,...n->...k", V, w)
        w = w - jnp.einsum("...k,...kn->...n", proj, V)
        beta = jnp.linalg.norm(w, axis=-1)
        vnext = jnp.where(
            beta[..., None] > 0, w / jnp.maximum(beta, 1e-300)[..., None], w
        )
        T = T.at[..., i, i].set(alpha)
        T = T.at[..., i + 1, i].set(beta)
        T = T.at[..., i, i + 1].set(beta)
        V = V.at[..., i + 1, :].set(vnext)
        return V, T

    def cond(st):
        _, _, i, done = st
        return jnp.logical_and(~done, i < k)

    def body(st):
        V, T, i, _ = st
        V, T = step_i(V, T, i)
        do_check = jnp.logical_or((i + 1) % check_freq == 0, i + 1 >= k)

        def check(_):
            _, Y = jnp.linalg.eigh(masked_tri(T, i))
            y1 = Y[..., :, -1]
            beta = jnp.take(jnp.take(T, i + 1, axis=-2), i, axis=-1)
            y1i = jnp.take(y1, i, axis=-1)
            resi = jnp.abs(beta * y1i)
            return jnp.max(resi) < 1e-04

        done = jax.lax.cond(do_check, check, lambda _: jnp.bool_(False), None)
        return V, T, i + 1, done

    V, T, i_fin, _ = jax.lax.while_loop(
        cond, body, (V0, T0, jnp.int32(0), jnp.bool_(False))
    )
    i_last = i_fin - 1  # index of the last completed row

    w_eigs, Y = jnp.linalg.eigh(masked_tri(T, i_last))
    lam1 = w_eigs[..., -1]
    lam2 = w_eigs[..., -2] if k > 1 else lam1

    y1 = Y[..., :, -1]
    z1 = jnp.einsum("...kn,...k->...n", V[..., :k, :], y1)
    Mz1 = _matvec(L, dS, z1)
    r1 = jnp.linalg.norm(Mz1 - lam1[..., None] * z1, axis=-1)

    y2 = Y[..., :, -2] if k > 1 else y1
    z2 = jnp.einsum("...kn,...k->...n", V[..., :k, :], y2)
    Mz2 = _matvec(L, dS, z2)
    r2 = jnp.linalg.norm(Mz2 - lam2[..., None] * z2, axis=-1)

    gap = jnp.maximum(lam1 - lam2 - r2, 1e-16)
    gamma = jnp.minimum(r1, r1 * r1 / gap)

    lam_bound = lam1 + gamma
    step = jnp.where(lam_bound > 0.0, 1.0 / jnp.maximum(lam_bound, 1e-300), INF_STEP)
    return step, Mz1


# exact-ratio threshold: below this dimension the batched eigh is
# taken to be cheaper than 30 sequential Lanczos matvecs
AUTO_LANCZOS_DIM = 192


def block_ratio(
    L: jnp.ndarray,
    dS: jnp.ndarray,
    mode: str = "auto",
    krylov: int = 30,
    use_f32: bool = True,
    v0=None,
    return_warm: bool = False,
    adaptive: bool | None = None,
):
    """Per-matrix max step for one block group, dispatching exact eigh vs
    Lanczos by mode and dimension (ref: the cone binds HLanczosSolve as
    its ratio test, hdsdp_conic_sdp.c:1392-1394; small cones are cheaper
    exactly).

    The Lanczos path may run in f32 (use_f32): the estimate only sizes a
    trial step, and every accepted step is re-verified by an f64 interior
    check downstream; a 0.995 safety factor absorbs the reduced-precision
    error in the bound.
    """
    n = L.shape[-1]
    if mode == "exact" or (mode == "auto" and n < AUTO_LANCZOS_DIM):
        steps = exact_ratio_test(L, dS)
        return (steps, None) if return_warm else steps
    dt = jnp.float32 if use_f32 else L.dtype
    Lc = L.astype(dt)
    dSc = dS.astype(dt)
    if v0 is None:
        # deterministic start vector for the first call; subsequent IPM
        # iterations pass the recorded Ritz image back in
        # (ref hdsdp_lanczos.c:166-178 dLanczosWarmStart)
        start = jnp.broadcast_to(
            (1.0 + 1e-03 * jnp.arange(n)).astype(dt), L.shape[:-2] + (n,)
        )
    else:
        # deterministic perturbation against stagnation on a stale
        # eigvector (ref HLanczosIPerturb, hdsdp_lanczos.c:44-53)
        pert = (jnp.arange(n) % 7 - 3.0).astype(dt) * 1e-03
        start = v0.astype(dt) + pert * jnp.maximum(
            jnp.linalg.norm(v0, axis=-1, keepdims=True).astype(dt), 1e-30
        )
    if adaptive is None:
        adaptive = return_warm
    if adaptive:
        step, warm = lanczos_ratio_test_adaptive(Lc, dSc, start, krylov=krylov)
    else:
        # in-graph callers (fused phase programs) keep the fixed-depth
        # kernel: a while_loop would bloat their XLA programs.  They can
        # still carry warm vectors (adaptive=False, return_warm=True).
        step, warm = lanczos_ratio_test(Lc, dSc, start, krylov=krylov)
    step = step.astype(L.dtype)
    if use_f32:
        step = step * 0.995
    return (step, warm) if return_warm else step


def vector_ratio_test(s: jnp.ndarray, ds: jnp.ndarray) -> jnp.ndarray:
    """Max alpha with s + alpha*ds > 0 elementwise for s > 0.

    Mirrors the LP/bound cone ratio tests (ref hdsdp_conic_lp.c:215-247,
    hdsdp_conic_bound.c:157-194) including their 100.0 cap when the
    direction is nonnegative.
    """
    ratio = jnp.min(ds / s)
    return jnp.where(ratio >= 0.0, 100.0, -1.0 / ratio)
