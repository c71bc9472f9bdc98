"""Schur-complement assembly: M_ij = sum_cones tr(A_i S^-1 A_j S^-1).

Batched replacement for the reference's per-row M1-M5 strategy kernels
(ref interface/hdsdp_conic_sdp.c:687-985 and the per-type KKT routines of
linalg/hdsdp_sdpdata.c): constraints are bucketed at presolve into

  low-rank:  A_i = sum_k lam_k u_k u_k^T   (factors F, weights lam, seg ids)
  dense:     A_i stored as full [n, n]

and each IPM iteration computes, per block group (batched over g blocks):

  W  = F U F^T                  (U = S^-1)           -> two batched matmuls
  M += E^T ((lam lam^T) .* W^2) E                    -> matmul + gather
  B  = U A_d U                  (dense bucket)       -> batched congruence
  M += <A_d, B> and low-rank x dense cross terms

which generalizes M2 (rank-one quadforms, hdsdp_conic_sdp.c:687-778) and
M3/M5 (congruence + traces, :780-985) to one data layout.  The RHS vectors
  ASinv_i       = tr(A_i S^-1)
  ASinvRdSinv_i = Rd * tr(S^-1 A_i S^-1)
  ASinvCSinv_i  = tr(C S^-1 A_i S^-1)        (homogeneous method only)
and HSD scalars CSinv / CSinvCSinv / CSinvRdSinv / TraceSinv are fused into
the same pass, exactly as the reference fuses them into its KKT build.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


class GroupArrays(NamedTuple):
    """Device-side arrays of one same-dimension SDP block group.

    Two storage layouts for the low-rank bucket:

    * FLAT (``Fs is None``): all low-rank slots of the group are packed
      into F:[g, R, n] with per-slot constraint ids seg:[g, R].  The M
      accumulation goes through either the ``pos`` gather map (g == 1,
      injective slots) or a one-hot matmul contraction.  The one-hot path
      costs O(R^2 m) flops and O(g R m) memory — fine for many small
      blocks, catastrophic at SDPLIB scale (R ~ 2m, m ~ 5000).

    * SLOT-MAJOR (``Fs`` set; requires g == 1): factors are stored by
      slot index j < r as Fs:[r, m, n] / lams:[r, m] where Fs[j, i] is
      the j-th eigenvector of constraint i (zero row if rank(A_i) <= j).
      The Schur matrix becomes r(r+1)/2 plain [m,n]x[n,m] matmuls

          M += sym( (lams_j (x) lams_k) * (Fs_j U Fs_k^T)^2 )

      directly in constraint-index order: no scatter, no one-hot, no
      [g, R, m] blow-up.  This replaces the
      reference's per-row M1/M2 rank-one kernels
      (ref hdsdp_conic_sdp.c:687-778) at large m.
    """

    C: jnp.ndarray  # [g, n, n]
    F: jnp.ndarray  # [g, R, n]
    lam: jnp.ndarray  # [g, R]
    seg: jnp.ndarray  # [g, R] int32
    Ad: jnp.ndarray  # [md, n, n]
    didx: jnp.ndarray  # [md] int32
    dblk: jnp.ndarray  # [md] int32
    # Optional gather map for the M accumulation: pos[i] = slot r with
    # seg[0, r] == i (sentinel R if none).  Present only when g == 1 and
    # each constraint owns at most one low-rank slot; it turns the m x m
    # scatter-add into a pure gather.  When absent, a one-hot matmul
    # contraction is used; the
    # general scatter is never emitted on the M path.
    pos: Optional[jnp.ndarray] = None  # [m] int32
    # slot-major layout (see class docstring); F/lam/seg hold 1-slot
    # placeholders when set
    Fs: Optional[jnp.ndarray] = None  # [r, m, n]
    lams: Optional[jnp.ndarray] = None  # [r, m]
    # DIAGONAL specialization of the slot-major layout (requires r == 1
    # and every factor a scaled standard-basis vector, i.e. every
    # low-rank coefficient A_i = w_i e_{p_i} e_{p_i}^T — the maxG*/
    # torus* structure).  Then M_ij = w_i w_j (U_{p_i p_j})^2, a pure
    # gather + Hadamard square: O(m^2) instead of O(n m^2) — the
    # analogue of the reference's rank-one M2 kernel shortcut
    # (ref hdsdp_conic_sdp.c:687-778, kkt2quadform on 1-nnz vectors).
    # A length-0 dpos is the trace-time marker for the IDENTITY map
    # p_i = i (requires m == n; the whole maxcut/torus family): every
    # gather through p is then skipped — at torus-22 that removes two
    # m x m copies per KKT build.
    dpos: Optional[jnp.ndarray] = None  # [m] int32 diagonal position
    dw: Optional[jnp.ndarray] = None  # [m] weight w_i (0 if no slot)
    # BOUNDED-SUPPORT specialization of the slot-major layout: every
    # slot eigenvector has <= c nonzeros (the theta family has rank-2
    # coefficients with 2-nnz eigenvectors).  spos/sval hold the padded
    # positions/entries; the pair products Fs_j U Fs_k^T then become c^2
    # gathered m x m Hadamard combinations of U — O(m^2) memory-bound
    # instead of O(n m^2) matmuls (the analogue of the reference's
    # sparse rank-one / pairwise M5 kernels,
    # ref linalg/hdsdp_sdpdata.c:1711-1963).
    spos: Optional[jnp.ndarray] = None  # [r, m, c] int32
    sval: Optional[jnp.ndarray] = None  # [r, m, c]


class SchurOut(NamedTuple):
    M: Optional[jnp.ndarray]  # [m, m] contribution (None for rhs-only)
    asinv: jnp.ndarray  # [m]   tr(A_i S^-1)
    trSAS: jnp.ndarray  # [m]   tr(S^-1 A_i S^-1)  (caller multiplies by Rd)
    trU: jnp.ndarray  # []    tr(S^-1)


class HSDOut(NamedTuple):
    asinvcsinv: jnp.ndarray  # [m] tr(C S^-1 A_i S^-1)
    csinv: jnp.ndarray  # []
    csinvcsinv: jnp.ndarray  # []
    trUCU: jnp.ndarray  # []  tr(S^-1 C S^-1) (caller multiplies by Rd)


def group_dual(ga: GroupArrays, dC, scal, y, dEye) -> jnp.ndarray:
    """Buffer assembly B = dEye*I + scal*(A'y) + dC*C, batched [g,n,n].

    Mirrors sdpDenseConeIUpdateBuffer (ref hdsdp_conic_sdp.c:343-402); the
    per-cone perturbation is folded into dEye by the caller."""
    if ga.dpos is not None:
        n = ga.Fs.shape[2]
        g = 1
        wy = ga.dw * y
        dvec = (
            wy  # identity map p_i = i (length-0 dpos marker)
            if ga.dpos.shape[0] == 0
            else jax.ops.segment_sum(wy, ga.dpos, num_segments=n)
        )
        W = jnp.zeros((n, n), dvec.dtype).at[
            jnp.arange(n), jnp.arange(n)
        ].set(dvec)[None]
    elif ga.spos is not None:
        # scatter the r*m*c^2 weighted outer-product entries (a few
        # hundred k elements even at theta12 scale)
        n = ga.Fs.shape[2]
        g = 1
        P, V = ga.spos, ga.sval
        wy = ga.lams * y[None, :]  # [r, m]
        vals = (
            wy[:, :, None, None] * V[:, :, :, None] * V[:, :, None, :]
        ).reshape(-1)
        flat = (P[:, :, :, None] * n + P[:, :, None, :]).reshape(-1)
        W = jax.ops.segment_sum(vals, flat, num_segments=n * n).reshape(
            n, n
        )[None]
    elif ga.Fs is not None:
        r, m_, n = ga.Fs.shape
        g = 1
        w = ga.lams * y[None, :]  # [r, m]
        W = jnp.einsum(
            "jan,ja,jam->nm", ga.Fs, w, ga.Fs, optimize=True
        )[None]
    else:
        g, R, n = ga.F.shape
        w = ga.lam * y[ga.seg]  # [g, R]
        W = jnp.einsum("grn,gr,grm->gnm", ga.F, w, ga.F, optimize=True)
    if ga.Ad.shape[0]:
        Wd = jax.ops.segment_sum(
            ga.Ad * y[ga.didx][:, None, None], ga.dblk, num_segments=g
        )
        W = W + Wd
    eye = jnp.eye(n, dtype=W.dtype)
    return scal * W + dC * ga.C + dEye * eye


def _quadforms(F: jnp.ndarray, T: jnp.ndarray) -> jnp.ndarray:
    """q_r = F_r T F_r^T diagonal: [.., R] of u_r^T T u_r."""
    return jnp.einsum("...rn,...nm,...rm->...r", F, T, F, optimize=True)


def _dense_congruence(ga: GroupArrays, U: jnp.ndarray):
    """B_i = U A_i U for the dense bucket (ref M3, hdsdp_conic_sdp.c:780-851)."""
    Ub = U[ga.dblk]  # [md,n,n]
    return jnp.einsum("ipq,iqr,irs->ips", Ub, ga.Ad, Ub, optimize=True), Ub


def _slot_schur(
    ga: GroupArrays, U: jnp.ndarray, m: int, with_m: bool,
    col: Optional[GroupArrays] = None,
) -> SchurOut:
    """Slot-major Schur contribution (g == 1): r(r+1)/2 [m,n]x[n,m]
    matmuls indexed directly by constraint — the large-m path.

    ``col``: replicated view of the group used for COLUMN-side operands
    of M on a row-sharded mesh (see _diag_schur)."""
    if col is None:
        col = ga
    r, m_, n = ga.Fs.shape
    U0 = U[0]
    md = ga.Ad.shape[0]

    FU = jnp.einsum("jan,nm->jam", ga.Fs, U0, optimize=True)  # [r,m,n]
    asinv = jnp.sum(ga.lams * jnp.sum(FU * ga.Fs, axis=-1), axis=0)
    trsas = jnp.sum(ga.lams * jnp.sum(FU * FU, axis=-1), axis=0)
    trU = jnp.trace(U0)

    M = None
    B = None
    if md:
        B, Ub = _dense_congruence(ga, U)
        asinv = asinv.at[ga.didx].add(jnp.sum(ga.Ad * Ub, axis=(-1, -2)))
        trsas = trsas.at[ga.didx].add(jnp.trace(B, axis1=-2, axis2=-1))

    if with_m:
        M = jnp.zeros((m, m), U.dtype)
        for j in range(r):
            for k in range(j, r):
                T = FU[j] @ col.Fs[k].T  # [m, m]
                T = (ga.lams[j][:, None] * col.lams[k][None, :]) * (T * T)
                if k == j:
                    M = M + T
                elif col is not ga:
                    # row-sharded mesh: avoid the transpose reshard by
                    # recomputing the (k, j) partner row-major
                    Tt = FU[k] @ col.Fs[j].T
                    M = M + T + (
                        ga.lams[k][:, None] * col.lams[j][None, :]
                    ) * (Tt * Tt)
                else:
                    M = M + T + T.T

        if md:
            # dense x dense (single block: all pairs interact)
            Mdd = jnp.einsum("ipq,jpq->ij", B, ga.Ad, optimize=True)
            Ed = jax.nn.one_hot(ga.didx, m, dtype=U.dtype)  # [md, m]
            M = M + Ed.T @ (Mdd @ Ed)
            # dense x low-rank cross: lams_j[a] * Fs_j[a]^T B_i Fs_j[a],
            # memory-bounded scan over the (small) dense bucket
            def cross_one(Bi):
                FB = jnp.einsum("jan,nm->jam", ga.Fs, Bi, optimize=True)
                return jnp.sum(ga.lams * jnp.sum(FB * ga.Fs, axis=-1), axis=0)

            Xc = jax.lax.map(cross_one, B)  # [md, m]
            Mx = Ed.T @ Xc
            M = M + Mx + Mx.T

    return SchurOut(M=M, asinv=asinv, trSAS=trsas, trU=trU)


def _diag_schur(ga: GroupArrays, U: jnp.ndarray, m: int, with_m: bool,
                col: Optional[GroupArrays] = None) -> SchurOut:
    """Diagonal rank-1 bucket: A_i = w_i e_{p_i} e_{p_i}^T, so

        M_ij    = w_i w_j (U_{p_i p_j})^2          (gather + square)
        asinv_i = w_i U_{p_i p_i}
        trsas_i = w_i (U U)_{p_i p_i} = w_i ||U[:, p_i]||^2

    O(m^2 + n^2) per build vs the generic slot path's O(n m^2) — the
    maxG*/torus* family shortcut (≙ ref M2 rank-one quadforms on 1-nnz
    eigenvectors, hdsdp_conic_sdp.c:687-778).

    ``col``: alternative (replicated) view of the group arrays used for
    every COLUMN-side operand of M.  On a row-sharded mesh the row-side
    arrays carry the constraint-row sharding; reading the column side
    from the same sharded arrays forces GSPMD to reshard the whole
    [m, m] intermediate, so the mesh path passes the unconstrained
    (replicated) copy here instead."""
    if col is None:
        col = ga
    U0 = U[0]
    p = ga.dpos
    w = ga.dw
    ident = p.shape[0] == 0  # identity map marker (see GroupArrays.dpos)
    md = ga.Ad.shape[0]

    diagU = jnp.diagonal(U0)
    asinv = w * (diagU if ident else diagU[p])
    rno = jnp.sum(U0 * U0, axis=0)  # diag(U @ U), U symmetric
    trsas = w * (rno if ident else rno[p])
    trU = jnp.trace(U0)

    M = None
    B = None
    if md:
        B, Ub = _dense_congruence(ga, U)
        asinv = asinv.at[ga.didx].add(jnp.sum(ga.Ad * Ub, axis=(-1, -2)))
        trsas = trsas.at[ga.didx].add(jnp.trace(B, axis1=-2, axis2=-1))

    if with_m:
        Usub = U0 if ident else U0[p][:, col.dpos]
        M = (w[:, None] * col.dw[None, :]) * (Usub * Usub)
        if md:
            Mdd = jnp.einsum("ipq,jpq->ij", B, ga.Ad, optimize=True)
            Ed = jax.nn.one_hot(ga.didx, m, dtype=U.dtype)  # [md, m]
            M = M + Ed.T @ (Mdd @ Ed)
            # dense x diag cross: w_i B_d[p_i, p_i]
            dB = jnp.diagonal(B, axis1=-2, axis2=-1)
            Xc = col.dw[None, :] * (dB if ident else dB[:, col.dpos])
            Mx = Ed.T @ Xc
            M = M + Mx + Mx.T

    return SchurOut(M=M, asinv=asinv, trSAS=trsas, trU=trU)


def _support_schur(ga: GroupArrays, U: jnp.ndarray, m: int, with_m: bool,
                   col: Optional[GroupArrays] = None) -> SchurOut:
    """Bounded-support slot bucket: every eigenvector has <= c nonzeros,
    so every pair product (Fs_j U Fs_k^T)_{i1 i2} = sum_{a,b}
    v_{j,i1,a} v_{k,i2,b} U[p_{j,i1,a}, p_{k,i2,b}] — c^2 gathered m x m
    Hadamard terms per slot pair, no [m,n]x[n,m] matmul (≙ ref sparse
    pairwise M5 kernels, hdsdp_sdpdata.c:1711-1963).  Needs one n^3
    matmul (U @ U) for the trSAS row regardless of m.

    ``col``: replicated view of the group used for COLUMN-side operands
    of M on a row-sharded mesh (see _diag_schur)."""
    if col is None:
        col = ga
    U0 = U[0]
    P = ga.spos  # [r, m, c]
    V = ga.sval
    r, m_, c = P.shape
    md = ga.Ad.shape[0]
    w = ga.lams  # [r, m]

    # [r, m, c, c] gathers of U at each slot's support
    Usup = U0[P[:, :, :, None], P[:, :, None, :]]
    quad = jnp.einsum("jiab,jia,jib->ji", Usup, V, V)  # v' U v per slot
    asinv = jnp.sum(w * quad, axis=0)
    U2 = U0 @ U0
    U2sup = U2[P[:, :, :, None], P[:, :, None, :]]
    quad2 = jnp.einsum("jiab,jia,jib->ji", U2sup, V, V)  # ||U v||^2
    trsas = jnp.sum(w * quad2, axis=0)
    trU = jnp.trace(U0)

    M = None
    B = None
    if md:
        B, Ub = _dense_congruence(ga, U)
        asinv = asinv.at[ga.didx].add(jnp.sum(ga.Ad * Ub, axis=(-1, -2)))
        trsas = trsas.at[ga.didx].add(jnp.trace(B, axis1=-2, axis2=-1))

    if with_m:
        Pc, Vc, wc = col.spos, col.sval, col.lams

        def pair(Pr, Vr, Pcol, Vcol):
            # (Fs_j U Fs_k^T)[i1, i2] over the two supports: c^2 gathered
            # m x m Hadamard terms (row side gathers rows of U, column
            # side gathers columns of the row-gathered [m, n] block)
            T = jnp.zeros((m_, m_), U.dtype)
            for a in range(c):
                G = U0[Pr[:, a]]  # [m, n]
                for b in range(c):
                    T = T + (Vr[:, a, None] * Vcol[None, :, b]) * G[
                        :, Pcol[:, b]
                    ]
            return T

        M = jnp.zeros((m, m), U.dtype)
        for j in range(r):
            for k in range(j, r):
                T = pair(P[j], V[j], Pc[k], Vc[k])
                T = (w[j][:, None] * wc[k][None, :]) * (T * T)
                if k == j:
                    M = M + T
                elif col is not ga:
                    # row-sharded mesh: T.T would transpose-reshard the
                    # [m_loc, m] shard (all-to-all); compute the (k, j)
                    # partner row-major instead
                    Tt = pair(P[k], V[k], Pc[j], Vc[j])
                    M = M + T + (w[k][:, None] * wc[j][None, :]) * (Tt * Tt)
                else:
                    M = M + T + T.T
        if md:
            Mdd = jnp.einsum("ipq,jpq->ij", B, ga.Ad, optimize=True)
            Ed = jax.nn.one_hot(ga.didx, m, dtype=U.dtype)  # [md, m]
            M = M + Ed.T @ (Mdd @ Ed)
            # dense x support cross: w_ji v' B_d v at each support
            Bsup = B[:, P[:, :, :, None], P[:, :, None, :]]  # [md,r,m,c,c]
            Xc = jnp.einsum(
                "djiab,jia,jib,ji->di", Bsup, V, V, w, optimize=True
            )
            Mx = Ed.T @ Xc
            M = M + Mx + Mx.T

    return SchurOut(M=M, asinv=asinv, trSAS=trsas, trU=trU)


def group_schur(
    ga: GroupArrays, U: jnp.ndarray, m: int, with_m: bool = True,
    col: Optional[GroupArrays] = None,
) -> SchurOut:
    """Schur contribution of one group given U = S^-1 [g,n,n].

    ``col``: replicated view of the same group for COLUMN-side operands
    of M (row-sharded mesh assembly; see _diag_schur)."""

    if ga.dpos is not None:
        return _diag_schur(ga, U, m, with_m, col=col)
    if ga.spos is not None:
        return _support_schur(ga, U, m, with_m, col=col)
    if ga.Fs is not None:
        return _slot_schur(ga, U, m, with_m, col=col)

    g, R, n = ga.F.shape
    md = ga.Ad.shape[0]

    FU = jnp.einsum("grn,gnm->grm", ga.F, U, optimize=True)  # [g,R,n]

    asinv = jnp.zeros((m,), U.dtype)
    trsas = jnp.zeros((m,), U.dtype)

    t_asinv = ga.lam * jnp.sum(FU * ga.F, axis=-1)  # lam * u'Uu
    t_trsas = ga.lam * jnp.sum(FU * FU, axis=-1)  # lam * ||Uu||^2
    asinv = asinv.at[ga.seg].add(t_asinv)
    trsas = trsas.at[ga.seg].add(t_trsas)

    trU = jnp.trace(U, axis1=-2, axis2=-1).sum()

    M = None
    B = None
    if md:
        Ub = U[ga.dblk]  # [md,n,n]
        B = jnp.einsum("ipq,iqr,irs->ips", Ub, ga.Ad, Ub, optimize=True)
        asinv = asinv.at[ga.didx].add(jnp.sum(ga.Ad * Ub, axis=(-1, -2)))
        trsas = trsas.at[ga.didx].add(jnp.trace(B, axis1=-2, axis2=-1))

    if with_m:
        W = jnp.einsum("grn,gsn->grs", FU, ga.F, optimize=True)  # F U F^T
        Q = (ga.lam[:, :, None] * ga.lam[:, None, :]) * (W * W)
        M = accumulate_m(ga, Q, m)

        if md:
            # dense x dense within the same block
            same = (ga.dblk[:, None] == ga.dblk[None, :]).astype(U.dtype)
            Mdd = jnp.einsum("ipq,jpq->ij", B, ga.Ad, optimize=True) * same
            Ed = jax.nn.one_hot(ga.didx, m, dtype=U.dtype)  # [md, m]
            M = M + jnp.einsum("ij,im,jn->mn", Mdd, Ed, Ed, optimize=True)
            # dense x low-rank cross: lam_r * u_r^T B_i u_r, same block
            Fb = ga.F[ga.dblk]  # [md,R,n]
            lamb = ga.lam[ga.dblk]  # [md,R]
            cross = lamb * _quadforms(Fb, B)  # [md,R]
            segb = ga.seg[ga.dblk]  # [md,R]
            Ec = jax.nn.one_hot(segb, m, dtype=U.dtype)  # [md,R,m]
            Mx = jnp.einsum("ir,im,irn->mn", cross, Ed, Ec, optimize=True)
            M = M + Mx + Mx.T

    return SchurOut(M=M, asinv=asinv, trSAS=trsas, trU=trU)


def accumulate_m(ga: GroupArrays, Q: jnp.ndarray, m: int) -> jnp.ndarray:
    """Accumulate the low-rank pairwise contributions Q [g, R, R] into the
    m x m Schur matrix WITHOUT a scatter: a gather through ga.pos when the
    slot map is injective (single block group), else a one-hot einsum."""
    if ga.pos is not None:
        Qp = jnp.pad(Q[0], ((0, 1), (0, 1)))
        return Qp[ga.pos][:, ga.pos]
    E = jax.nn.one_hot(ga.seg, m, dtype=Q.dtype)  # [g, R, m]
    return jnp.einsum("grs,grm,gsn->mn", Q, E, E, optimize=True)


def group_hsd(ga: GroupArrays, U: jnp.ndarray, m: int) -> HSDOut:
    """Self-dual embedding components (ref sdpDenseConeIGetHSDComponents,
    hdsdp_conic_sdp.c:987-1033), via the dense-C M3 path."""

    T = jnp.einsum("gpq,gqr,grs->gps", U, ga.C, U, optimize=True)  # U C U
    csinv = jnp.sum(ga.C * U)
    csinvcsinv = jnp.sum(ga.C * T)
    trUCU = jnp.trace(T, axis1=-2, axis2=-1).sum()

    if ga.dpos is not None:
        dT = jnp.diagonal(T[0])
        asinvcsinv = ga.dw * (dT if ga.dpos.shape[0] == 0 else dT[ga.dpos])
    elif ga.spos is not None:
        P, V = ga.spos, ga.sval
        Tsup = T[0][P[:, :, :, None], P[:, :, None, :]]
        asinvcsinv = jnp.sum(
            ga.lams * jnp.einsum("jiab,jia,jib->ji", Tsup, V, V), axis=0
        )
    elif ga.Fs is not None:
        FT = jnp.einsum("jan,nm->jam", ga.Fs, T[0], optimize=True)
        asinvcsinv = jnp.sum(ga.lams * jnp.sum(FT * ga.Fs, axis=-1), axis=0)
    else:
        asinvcsinv = jnp.zeros((m,), U.dtype)
        q = ga.lam * _quadforms(ga.F, T)
        asinvcsinv = asinvcsinv.at[ga.seg].add(q)
    if ga.Ad.shape[0]:
        Tb = T[ga.dblk]
        asinvcsinv = asinvcsinv.at[ga.didx].add(jnp.sum(ga.Ad * Tb, axis=(-1, -2)))

    return HSDOut(
        asinvcsinv=asinvcsinv, csinv=csinv, csinvcsinv=csinvcsinv, trUCU=trUCU
    )


def group_atx(ga: GroupArrays, X: jnp.ndarray, m: int) -> jnp.ndarray:
    """A(X): per-constraint traces <A_i, X_blk> given X [g,n,n]."""
    if ga.dpos is not None:
        dX = jnp.diagonal(X[0])
        out = ga.dw * (dX if ga.dpos.shape[0] == 0 else dX[ga.dpos])
    elif ga.spos is not None:
        P, V = ga.spos, ga.sval
        Xsup = X[0][P[:, :, :, None], P[:, :, None, :]]
        out = jnp.sum(
            ga.lams * jnp.einsum("jiab,jia,jib->ji", Xsup, V, V), axis=0
        )
    elif ga.Fs is not None:
        FX = jnp.einsum("jan,nm->jam", ga.Fs, X[0], optimize=True)
        out = jnp.sum(ga.lams * jnp.sum(FX * ga.Fs, axis=-1), axis=0)
    else:
        out = jnp.zeros((m,), X.dtype)
        FX = jnp.einsum("grn,gnm->grm", ga.F, X, optimize=True)
        out = out.at[ga.seg].add(ga.lam * jnp.sum(FX * ga.F, axis=-1))
    if ga.Ad.shape[0]:
        Xb = X[ga.dblk]
        out = out.at[ga.didx].add(jnp.sum(ga.Ad * Xb, axis=(-1, -2)))
    return out


# ----------------------------------------------------------------------
# Matrix-free Schur operator (the analogue of the reference's
# sparse m x m Schur storage, ref interface/hdsdp_schur.c:46-139 symbolic
# aggregation + the dense-vs-sparse decision at hdsdp_schur.c:60,227).
#
# Where the reference switches to a sparse CSC Schur matrix when the
# aggregated pattern has < 0.3 m^2 nonzeros, this solver never
# materializes M at all above the dense-feasibility scale: CG solves use
#
#     M v = A( S^-1 (sum_j v_j A_j) S^-1 )
#
# applied per bucket — O(m + n^2) memory instead of O(m^2) — with an
# exactly computed Jacobi diagonal as the preconditioner.  The diagonal
# rank-1 bucket further collapses the matvec to O(m n) gathers (no n^3).
# ----------------------------------------------------------------------


def group_schur_matvec(ga: GroupArrays, U: jnp.ndarray, v: jnp.ndarray,
                       m: int) -> jnp.ndarray:
    """(M_group @ v) without materializing M_group.

    Identity: (M v)_i = tr(A_i S^-1 W S^-1) with W = sum_j v_j A_j, so one
    weighted-sum assembly (group_dual with dC = dEye = 0), one congruence
    and one A(X) application per matvec."""
    if ga.dpos is not None and ga.Ad.shape[0] == 0:
        # diagonal rank-1 bucket: M_ij = w_i w_j (U_{p_i p_j})^2, so
        # M v = w * (Usq[p] @ segsum(w v)) — O(m n), no n^3 congruence
        U0 = U[0]
        wv = ga.dw * v
        Usq = U0 * U0
        if ga.dpos.shape[0] == 0:  # identity map
            return ga.dw * (Usq @ wv)
        z = jax.ops.segment_sum(wv, ga.dpos, num_segments=U0.shape[0])
        return ga.dw * (Usq[ga.dpos] @ z)
    W = group_dual(ga, 0.0, 1.0, v, 0.0)
    T = jnp.einsum("gpq,gqr,grs->gps", U, W, U, optimize=True)
    return group_atx(ga, T, m)


def group_schur_diag(ga: GroupArrays, U: jnp.ndarray, m: int) -> jnp.ndarray:
    """diag(M_group) exactly, without M: the Jacobi preconditioner of the
    matrix-free path.  Buckets are exclusive per (constraint, block)
    (models/problem.py packs each coefficient as low-rank OR dense), so
    there are no low-rank x dense diagonal cross terms."""
    dtype = U.dtype
    d = jnp.zeros((m,), dtype)
    if ga.dpos is not None:
        U0 = U[0]
        dU = jnp.diagonal(U0)
        d = ga.dw * ga.dw * (
            (dU if ga.dpos.shape[0] == 0 else dU[ga.dpos]) ** 2
        )
    elif ga.spos is not None:
        U0 = U[0]
        P, V = ga.spos, ga.sval
        # G[j,k,i] = v_{j,i}' U v_{k,i} over each slot pair's support
        Ucr = U0[P[:, None, :, :, None], P[None, :, :, None, :]]  # [r,r,m,c,c]
        G = jnp.einsum("jkiab,jia,kib->jki", Ucr, V, V, optimize=True)
        d = jnp.einsum("ji,ki,jki->i", ga.lams, ga.lams, G * G, optimize=True)
    elif ga.Fs is not None:
        U0 = U[0]
        FU = jnp.einsum("jan,nm->jam", ga.Fs, U0, optimize=True)
        G = jnp.einsum("jin,kin->jki", FU, ga.Fs, optimize=True)
        d = jnp.einsum("ji,ki,jki->i", ga.lams, ga.lams, G * G, optimize=True)
    else:
        FU = jnp.einsum("grn,gnm->grm", ga.F, U, optimize=True)
        W = jnp.einsum("grn,gsn->grs", FU, ga.F, optimize=True)
        Q = (ga.lam[:, :, None] * ga.lam[:, None, :]) * (W * W)
        E = jax.nn.one_hot(ga.seg, m, dtype=dtype)  # [g, R, m]
        d = jnp.einsum("grs,grm,gsm->m", Q, E, E, optimize=True)
    if ga.Ad.shape[0]:
        B, _ = _dense_congruence(ga, U)
        d = d.at[ga.didx].add(jnp.sum(B * ga.Ad, axis=(-1, -2)))
    return d


def group_schur_rows(
    ga: GroupArrays, U: jnp.ndarray, i0, chunk: int, m: int
) -> Optional[jnp.ndarray]:
    """Rows [i0, i0+chunk) of this group's Schur contribution, [chunk, m].

    The row-chunked build behind the operator-mode Cholesky
    preconditioner: each chunk is a SMALL program (the monolithic m x m
    build failed to compile at m = 25001) and the full M exists only as
    an f32 preconditioner assembled chunk by chunk.  ``i0`` may be a
    traced scalar: one compilation covers every chunk.

    Supported: the three slot-major buckets (diag / bounded-support /
    generic slot), including their (small) dense bucket — exactly the
    shapes that reach operator scale (the theta family's identity row is
    a dense slot).  Returns None when the layout is not chunkable (flat
    multi-block); the caller falls back to Jacobi.
    """
    if ga.Fs is None:
        return None
    U0 = U[0]
    md = ga.Ad.shape[0]

    def rows(a, axis):
        return jax.lax.dynamic_slice_in_dim(a, i0, chunk, axis)

    if ga.dpos is not None:
        w = ga.dw
        wr = rows(w, 0)
        ident = ga.dpos.shape[0] == 0
        if ident:
            Usub = rows(U0, 0)
        else:
            p = ga.dpos
            Usub = U0[rows(p, 0)][:, p]
        M = (wr[:, None] * w[None, :]) * (Usub * Usub)
    elif ga.spos is not None:
        P, V, w = ga.spos, ga.sval, ga.lams  # [r, m, c], [r, m]
        r, _, c = P.shape
        M = jnp.zeros((chunk, m), U.dtype)
        for j in range(r):
            Pr, Vr, wr = rows(P[j], 0), rows(V[j], 0), rows(w[j], 0)
            for k in range(r):
                T = jnp.zeros((chunk, m), U.dtype)
                for a in range(c):
                    G = U0[Pr[:, a]]  # [chunk, n]
                    for b in range(c):
                        T = T + (Vr[:, a, None] * V[k][None, :, b]) * G[
                            :, P[k][:, b]
                        ]
                M = M + (wr[:, None] * w[k][None, :]) * (T * T)
    else:
        # generic slot-major: r^2 [chunk, n] x [n, m] matmuls
        r = ga.Fs.shape[0]
        M = jnp.zeros((chunk, m), U.dtype)
        for j in range(r):
            FUr = rows(ga.Fs[j], 0) @ U0  # [chunk, n]
            wr = rows(ga.lams[j], 0)
            for k in range(r):
                T = FUr @ ga.Fs[k].T  # [chunk, m]
                M = M + (wr[:, None] * ga.lams[k][None, :]) * (T * T)

    if md:
        # dense slots (md is small — e.g. the theta identity row).
        # cross[d, i] = contribution of dense slot d against constraint
        # i's low-rank part; dense constraints hold no low-rank slot, so
        # no entry is double-counted.
        B, _ = _dense_congruence(ga, U)  # [md, n, n]
        if ga.dpos is not None:
            dB = jnp.diagonal(B, axis1=-2, axis2=-1)  # [md, n]
            cross = ga.dw[None, :] * (
                dB if ga.dpos.shape[0] == 0 else dB[:, ga.dpos]
            )
        elif ga.spos is not None:
            P, V = ga.spos, ga.sval
            Bsup = B[:, P[:, :, :, None], P[:, :, None, :]]  # [md,r,m,c,c]
            cross = jnp.einsum(
                "djiab,jia,jib,ji->di", Bsup, V, V, ga.lams, optimize=True
            )
        else:
            def cross_one(Bi):
                FB = jnp.einsum("jan,nm->jam", ga.Fs, Bi, optimize=True)
                return jnp.sum(
                    ga.lams * jnp.sum(FB * ga.Fs, axis=-1), axis=0
                )

            cross = jax.lax.map(cross_one, B)  # [md, m]
        Mdd = jnp.einsum("ipq,jpq->ij", B, ga.Ad, optimize=True)  # [md, md]
        Ed = jax.nn.one_hot(ga.didx, m, dtype=U.dtype)  # [md, m]
        # low-rank rows of the chunk x dense columns
        cross_chunk = jax.lax.dynamic_slice(cross, (0, i0), (md, chunk))
        M = M + cross_chunk.T @ Ed
        # dense rows that fall inside the chunk (full row incl. dense-
        # dense block); out-of-chunk slots one_hot to zero rows
        rowvals = cross + Mdd @ Ed  # [md, m]
        Erel = jax.nn.one_hot(ga.didx - i0, chunk, dtype=U.dtype)  # [md,chunk]
        M = M + Erel.T @ rowvals
    return M


def lp_schur_rows(lp: LPArrays, s: jnp.ndarray, i0, chunk: int) -> jnp.ndarray:
    """Rows [i0, i0+chunk) of the LP cone's A diag(s^-2) A^T."""
    si2 = 1.0 / (s * s)
    Ar = jax.lax.dynamic_slice_in_dim(lp.A, i0, chunk, 0)
    return (Ar * si2[None, :]) @ lp.A.T


def lp_schur_matvec(lp: LPArrays, s: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(A diag(s^-2) A' ) v for the LP cone (ref hdsdp_conic_lp.c:294-313)."""
    si2 = 1.0 / (s * s)
    return lp.A @ (si2 * (v @ lp.A))


def lp_schur_diag(lp: LPArrays, s: jnp.ndarray) -> jnp.ndarray:
    si2 = 1.0 / (s * s)
    return (lp.A * lp.A) @ si2


# ----------------------------------------------------------------------
# LP cone contributions (ref interface/hdsdp_conic_lp.c:254-330)
# ----------------------------------------------------------------------


class LPArrays(NamedTuple):
    A: jnp.ndarray  # [m, nlp]
    c: jnp.ndarray  # [nlp]


def lp_dual(lp: LPArrays, dC, scal, y, dEye) -> jnp.ndarray:
    """s = dEye*1 + scal*(A'y) + dC*c."""
    return dEye + scal * (y @ lp.A) + dC * lp.c


def lp_schur(lp: LPArrays, s: jnp.ndarray, m: int, with_m: bool = True) -> SchurOut:
    si = 1.0 / s
    asinv = lp.A @ si
    trsas = lp.A @ (si * si)
    M = None
    if with_m:
        M = jnp.einsum("ij,j,kj->ik", lp.A, si * si, lp.A, optimize=True)
    return SchurOut(M=M, asinv=asinv, trSAS=trsas, trU=jnp.sum(si))


def lp_hsd(lp: LPArrays, s: jnp.ndarray, m: int) -> HSDOut:
    si = 1.0 / s
    csi = lp.c * si
    # NOTE: the reference omits the LP CSinvRdSinv term
    # (ref hdsdp_conic_lp.c:315-327); we reproduce that behavior.
    return HSDOut(
        asinvcsinv=lp.A @ (lp.c * si * si),
        csinv=jnp.sum(csi),
        csinvcsinv=jnp.sum(csi * csi),
        trUCU=jnp.zeros((), s.dtype),
    )
