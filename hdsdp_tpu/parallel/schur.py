"""Row-sharded Schur-complement assembly over a device mesh.

The per-iteration hot loop (SURVEY.md section 3.2) is

    M_ij = sum_cones tr(A_i S^-1 A_j S^-1),   plus fused RHS vectors,

with cost O(g R^2 n + g R n^2 + md n^3) per block group.  Here the
coefficient-slot axes (low-rank rows R, dense slots md) are partitioned
over the mesh axis ``"row"``: each device contracts its slice of
constraint slots against the full (replicated, iteration-invariant)
coefficient arrays and scatter-adds into a local m x m partial of M, and
one ``psum`` per output combines the partials across devices.  This
replaces the reference's per-row M1-M5 strategy loop
(ref interface/hdsdp_conic_sdp.c:1770-1804), which is inherently serial.

Per-device Cholesky of the (small) cone blocks is replicated; the m x m
Schur factorization stays replicated below the CG crossover (see
hdsdp_tpu.parallel.cg for the row-sharded iterative path).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from jax.sharding import NamedSharding

from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.ops import chol as chol_ops
from hdsdp_tpu.ops.schur import GroupArrays, LPArrays
from hdsdp_tpu.parallel.mesh import ROW_AXIS
from hdsdp_tpu.solver.cones import ConeSystem, KKTOut, _build_kkt


def _pad_axis(a: np.ndarray, axis: int, target: int) -> np.ndarray:
    pad = target - a.shape[axis]
    if pad <= 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths)


def pad_group(ga: GroupArrays, ndev: int) -> GroupArrays:
    """Pad the R and md axes to multiples of ndev (zero weight = no-op rows)."""
    R = ga.F.shape[1]
    Rp = max(-(-R // ndev) * ndev, ndev)
    md = ga.Ad.shape[0]
    mdp = -(-md // ndev) * ndev if md else 0
    return GroupArrays(
        C=ga.C,
        F=jnp.asarray(_pad_axis(np.asarray(ga.F), 1, Rp)),
        lam=jnp.asarray(_pad_axis(np.asarray(ga.lam), 1, Rp)),
        seg=jnp.asarray(_pad_axis(np.asarray(ga.seg), 1, Rp)),
        Ad=jnp.asarray(_pad_axis(np.asarray(ga.Ad), 0, mdp)),
        didx=jnp.asarray(_pad_axis(np.asarray(ga.didx), 0, mdp)),
        dblk=jnp.asarray(_pad_axis(np.asarray(ga.dblk), 0, mdp)),
        pos=None,  # sharded partials use the one-hot path
    )


def _slice1(a, idx, size, axis):
    return jax.lax.dynamic_slice_in_dim(a, idx * size, size, axis)


# ----------------------------------------------------------------------
# per-device partial kernels
# ----------------------------------------------------------------------


def _group_dual_part(ga: GroupArrays, idx, ndev: int, scal, y):
    """Device-local partial of scal * A'y for one group, [g, n, n]."""
    g, R, n = ga.F.shape
    Rloc = R // ndev
    F = _slice1(ga.F, idx, Rloc, 1)
    lam = _slice1(ga.lam, idx, Rloc, 1)
    seg = _slice1(ga.seg, idx, Rloc, 1)
    w = lam * y[seg]
    W = jnp.einsum("grn,gr,grm->gnm", F, w, F, optimize=True)
    md = ga.Ad.shape[0]
    if md:
        mdloc = md // ndev
        Ad = _slice1(ga.Ad, idx, mdloc, 0)
        didx = _slice1(ga.didx, idx, mdloc, 0)
        dblk = _slice1(ga.dblk, idx, mdloc, 0)
        W = W + jax.ops.segment_sum(
            Ad * y[didx][:, None, None], dblk, num_segments=g
        )
    return scal * W


def _group_schur_part(ga: GroupArrays, U, m: int, idx, ndev: int, with_m: bool):
    """Device-local partials (M, asinv, trSAS) of one group given U = S^-1."""
    g, R, n = ga.F.shape
    Rloc = R // ndev
    F = _slice1(ga.F, idx, Rloc, 1)
    lam = _slice1(ga.lam, idx, Rloc, 1)
    seg = _slice1(ga.seg, idx, Rloc, 1)

    FU = jnp.einsum("grn,gnm->grm", F, U, optimize=True)  # [g, Rloc, n]
    asinv = jnp.zeros((m,), U.dtype)
    trsas = jnp.zeros((m,), U.dtype)
    asinv = asinv.at[seg].add(lam * jnp.sum(FU * F, axis=-1))
    trsas = trsas.at[seg].add(lam * jnp.sum(FU * FU, axis=-1))

    M = jnp.zeros((m, m), U.dtype) if with_m else None
    if with_m:
        # local rows x all columns of the low-rank Gram: covers every
        # ordered pair exactly once after psum (its transpose partner is
        # produced by the device owning the other row).  Accumulation is
        # a one-hot matmul contraction instead of a scatter-add.
        W = jnp.einsum("grn,gsn->grs", FU, ga.F, optimize=True)  # [g,Rloc,R]
        Q = (lam[:, :, None] * ga.lam[:, None, :]) * (W * W)
        El = jax.nn.one_hot(seg, m, dtype=U.dtype)  # [g,Rloc,m]
        Ef = jax.nn.one_hot(ga.seg, m, dtype=U.dtype)  # [g,R,m]
        M = jnp.einsum("grs,grm,gsn->mn", Q, El, Ef, optimize=True)

    md = ga.Ad.shape[0]
    if md:
        mdloc = md // ndev
        Ad = _slice1(ga.Ad, idx, mdloc, 0)
        didx = _slice1(ga.didx, idx, mdloc, 0)
        dblk = _slice1(ga.dblk, idx, mdloc, 0)
        Ub = U[dblk]
        B = jnp.einsum("ipq,iqr,irs->ips", Ub, Ad, Ub, optimize=True)
        asinv = asinv.at[didx].add(jnp.sum(Ad * Ub, axis=(-1, -2)))
        trsas = trsas.at[didx].add(jnp.trace(B, axis1=-2, axis2=-1))
        if with_m:
            same = (dblk[:, None] == ga.dblk[None, :]).astype(U.dtype)
            Mdd = jnp.einsum("ipq,jpq->ij", B, ga.Ad, optimize=True) * same
            Edl = jax.nn.one_hot(didx, m, dtype=U.dtype)  # [mdloc,m]
            Edf = jax.nn.one_hot(ga.didx, m, dtype=U.dtype)  # [md,m]
            M = M + jnp.einsum(
                "ij,im,jn->mn", Mdd, Edl, Edf, optimize=True
            )
            # dense x low-rank cross terms, both orientations, from the
            # device that owns the dense slot
            Fb = ga.F[dblk]  # [mdloc, R, n]
            lamb = ga.lam[dblk]
            cross = lamb * jnp.einsum(
                "irn,inm,irm->ir", Fb, B, Fb, optimize=True
            )
            segb = ga.seg[dblk]  # [mdloc, R]
            Ec = jax.nn.one_hot(segb, m, dtype=U.dtype)  # [mdloc,R,m]
            Mx = jnp.einsum("ir,im,irn->mn", cross, Edl, Ec, optimize=True)
            M = M + Mx + Mx.T

    return M, asinv, trsas


def _group_hsd_part(ga: GroupArrays, U, T, m: int, idx, ndev: int):
    """Device-local partial of ASinvCSinv given T = U C U (replicated)."""
    g, R, n = ga.F.shape
    Rloc = R // ndev
    F = _slice1(ga.F, idx, Rloc, 1)
    lam = _slice1(ga.lam, idx, Rloc, 1)
    seg = _slice1(ga.seg, idx, Rloc, 1)
    out = jnp.zeros((m,), U.dtype)
    q = lam * jnp.einsum("grn,gnm,grm->gr", F, T, F, optimize=True)
    out = out.at[seg].add(q)
    md = ga.Ad.shape[0]
    if md:
        mdloc = md // ndev
        Ad = _slice1(ga.Ad, idx, mdloc, 0)
        didx = _slice1(ga.didx, idx, mdloc, 0)
        dblk = _slice1(ga.dblk, idx, mdloc, 0)
        out = out.at[didx].add(jnp.sum(Ad * T[dblk], axis=(-1, -2)))
    return out


# ----------------------------------------------------------------------
# sharded cone system
# ----------------------------------------------------------------------


class _ShardedOperatorMixin:
    """Mesh composition for the matrix-free Schur operator: the per-group
    inverses U = S^-1 are RESHARDED over their row axis, so the operator
    matvec's congruences and gathers partition across devices (GSPMD
    inserts the psum/all-gathers over ICI).  M still never materializes
    anywhere — the memory contract of operator mode survives the mesh."""

    def _shard_inverses(self, Us):
        sh = NamedSharding(self.mesh, P(None, self.axis, None))
        return tuple(jax.device_put(U, sh) for U in Us)

    def inverses(self, L):
        return self._shard_inverses(super().inverses(L))


class ShardedConeSystem(_ShardedOperatorMixin, ConeSystem):
    """ConeSystem whose assembly / KKT build are row-sharded over a mesh.

    Everything the outer IPM touches keeps the same interface; only the
    two hot entry points (``assemble`` and ``build_kkt``) are replaced by
    shard_map'ped versions.  Factors, ratio tests and barrier values are
    computed replicated: they are O(g n^3) against the O(m R n^2 + m^2 R)
    assembly and their inputs are already replicated on the mesh.

    The Schur matrix is combined with ``psum_scatter`` over the row
    axis, NOT ``psum``: each device keeps only its m/ndev row shard
    (padded to a multiple of ndev with an identity tail, exactly like
    RowShardedConeSystem), and the factorization downstream is the
    distributed blocked Cholesky / row-sharded CG — no device ever
    materializes the full m x m matrix on the multi-block path either.
    """

    is_row_sharded = True

    def __init__(
        self,
        prob: SDPProblem,
        mesh: Mesh,
        obj_scal: float = 1.0,
        dtype=jnp.float64,
    ):
        # flat layout: the sharded kernels partition the packed R axis
        super().__init__(prob, obj_scal=obj_scal, dtype=dtype, layout="flat")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.ndev = int(np.prod(mesh.devices.shape))
        self.groups = tuple(pad_group(ga, self.ndev) for ga in self.groups)
        # M is handed out padded to a multiple of ndev with an identity
        # tail so its P("row", None) sharding is even (same contract as
        # RowShardedConeSystem; the solver pads/slices its m-vectors)
        self.m_pad = -(-self.m // self.ndev) * self.ndev

        spec_all = P()  # replicated inputs/outputs; work is split by index
        spec_mrow = P(self.axis, None)  # row-sharded Schur matrix

        def _assemble_body(groups, lp, dC, scal, y, dEye):
            idx = jax.lax.axis_index(self.axis)
            S_parts = tuple(
                _group_dual_part(ga, idx, self.ndev, scal, y) for ga in groups
            )
            S_parts = jax.lax.psum(S_parts, self.axis)
            S = tuple(
                Wp + dC * ga.C + dEye * jnp.eye(ga.C.shape[-1], dtype=ga.C.dtype)
                for Wp, ga in zip(S_parts, groups)
            )
            s_lp = (
                dEye + scal * (y @ lp.A) + dC * lp.c if lp is not None else None
            )
            return S, s_lp

        def _kkt_body(groups, lp, L, s_lp, Rd, kind):
            idx = jax.lax.axis_index(self.axis)
            is0 = (idx == 0).astype(self.dtype)
            m = self.m
            with_m = kind != "corr"
            M = jnp.zeros((m, m), self.dtype) if with_m else None
            asinv = jnp.zeros((m,), self.dtype)
            trsas = jnp.zeros((m,), self.dtype)
            tr_u = jnp.zeros((), self.dtype)
            asinvcsinv = jnp.zeros((m,), self.dtype) if kind == "hsd" else None
            csinv = jnp.zeros((), self.dtype)
            csinvcsinv = jnp.zeros((), self.dtype)
            csinvrdsinv = jnp.zeros((), self.dtype)

            for ga, Lg in zip(groups, L):
                U = chol_ops.chol_inverse(Lg)
                Mp, ap, tp = _group_schur_part(
                    ga, U, m, idx, self.ndev, with_m
                )
                if with_m:
                    M = M + Mp
                asinv = asinv + ap
                trsas = trsas + tp
                tr_u = tr_u + is0 * jnp.trace(U, axis1=-2, axis2=-1).sum()
                if kind == "hsd":
                    T = jnp.einsum("gpq,gqr,grs->gps", U, ga.C, U, optimize=True)
                    asinvcsinv = asinvcsinv + _group_hsd_part(
                        ga, U, T, m, idx, self.ndev
                    )
                    csinv = csinv + is0 * jnp.sum(ga.C * U)
                    csinvcsinv = csinvcsinv + is0 * jnp.sum(ga.C * T)
                    csinvrdsinv = csinvrdsinv + is0 * Rd * jnp.trace(
                        T, axis1=-2, axis2=-1
                    ).sum()

            if lp is not None:
                # LP cone replicated on device 0 (small next to SDP work)
                si = 1.0 / s_lp
                asinv = asinv + is0 * (lp.A @ si)
                trsas = trsas + is0 * (lp.A @ (si * si))
                tr_u = tr_u + is0 * jnp.sum(si)
                if with_m:
                    M = M + is0 * jnp.einsum(
                        "ij,j,kj->ik", lp.A, si * si, lp.A, optimize=True
                    )
                if kind == "hsd":
                    csi = lp.c * si
                    asinvcsinv = asinvcsinv + is0 * (lp.A @ (csi * si))
                    csinv = csinv + is0 * jnp.sum(csi)
                    csinvcsinv = csinvcsinv + is0 * jnp.sum(csi * csi)
                    # LP CSinvRdSinv omitted (ref hdsdp_conic_lp.c:315-327)

            outs = (asinv, trsas, asinvcsinv, csinv, csinvcsinv, csinvrdsinv, tr_u)
            outs = jax.lax.psum(outs, self.axis)
            asinv, trsas, asinvcsinv, csinv, csinvcsinv, csinvrdsinv, tr_u = outs
            if with_m:
                # combine the m x m partials with a reduce-scatter: each
                # device keeps only its row shard (identity tail added by
                # device 0 so the sum carries exactly one copy)
                pad = self.m_pad - m
                Mp = jnp.pad(M, ((0, pad), (0, pad)))
                if pad:
                    tail = jnp.concatenate(
                        [jnp.zeros(m, Mp.dtype), jnp.ones(pad, Mp.dtype)]
                    )
                    Mp = Mp + is0 * jnp.diag(tail)
                M = jax.lax.psum_scatter(
                    Mp, self.axis, scatter_dimension=0, tiled=True
                )
            return KKTOut(
                M=M,
                asinv=asinv,
                asinvrdsinv=Rd * trsas,
                asinvcsinv=asinvcsinv,
                csinv=csinv,
                csinvcsinv=csinvcsinv,
                csinvrdsinv=csinvrdsinv,
                trace_sinv=tr_u,
            )

        def _shmap(body, out_specs=spec_all):
            try:
                return shard_map(
                    body,
                    mesh=self.mesh,
                    in_specs=spec_all,
                    out_specs=out_specs,
                    check_vma=False,
                )
            except TypeError:  # older jax uses check_rep
                return shard_map(
                    body,
                    mesh=self.mesh,
                    in_specs=spec_all,
                    out_specs=out_specs,
                    check_rep=False,
                )

        def _kkt_out_specs(kind):
            hsd = kind == "hsd"
            return KKTOut(
                M=spec_mrow if kind != "corr" else None,
                asinv=spec_all,
                asinvrdsinv=spec_all,
                asinvcsinv=spec_all if hsd else None,
                csinv=spec_all,
                csinvcsinv=spec_all,
                csinvrdsinv=spec_all,
                trace_sinv=spec_all,
            )

        self._assemble_sharded = jax.jit(
            lambda groups, lp, dC, scal, y, dEye: _shmap(_assemble_body)(
                groups, lp, dC, scal, y, dEye
            )
        )
        self._kkt_sharded = {
            kind: jax.jit(
                lambda groups, lp, L, s_lp, Rd, _k=kind: _shmap(
                    partial(_kkt_body, kind=_k), out_specs=_kkt_out_specs(_k)
                )(groups, lp, L, s_lp, Rd)
            )
            for kind in ("inf", "hsd", "corr")
        }

    # -- overridden hot entry points ------------------------------------
    def assemble(self, dC, scal, y, dEye):
        return self._assemble_sharded(self.groups, self.lp, dC, scal, y, dEye)

    def build_kkt(self, L, s_lp, Rd, kind: str) -> KKTOut:
        return self._kkt_sharded[kind](self.groups, self.lp, L, s_lp, Rd)


# ----------------------------------------------------------------------
# row-sharded cone system (slot-major, single-block groups)
# ----------------------------------------------------------------------


class RowShardedConeSystem(_ShardedOperatorMixin, ConeSystem):
    """Constraint-row-sharded assembly for single-block groups at scale.

    The slot-major layout (ops.schur.GroupArrays) indexes the low-rank
    factors directly by constraint, so sharding the constraint axis of
    Fs/lams over the mesh makes every device compute exactly its own rows
    of the Schur matrix

        M[rows_d, :] = sum_{j,k} (lams_j[rows_d] x lams_k)
                        * (Fs_j[rows_d] U Fs_k^T)^2

    with ZERO communication for M itself (XLA inserts one all-gather of
    the iteration-invariant Fs_k right operand).  M is born with sharding
    P("row", None) and stays sharded through regularization, the
    distributed Cholesky (parallel.dchol) and the row-sharded CG
    (parallel.cg): no device ever materializes the full m x m matrix.
    This is the scalable replacement for ShardedConeSystem's
    slot-partitioned + psum-replicated scheme (kept for multi-block
    problems, whose M is small).
    """

    is_row_sharded = True

    def __init__(
        self,
        prob: SDPProblem,
        mesh: Mesh,
        obj_scal: float = 1.0,
        dtype=jnp.float64,
    ):
        super().__init__(prob, obj_scal=obj_scal, dtype=dtype, layout="auto")
        if any(ga.Fs is None for ga in self.groups):
            raise ValueError(
                "RowShardedConeSystem requires single-block groups "
                "(slot-major layout); use ShardedConeSystem instead"
            )
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.ndev = int(np.prod(mesh.devices.shape))
        m = self.m

        s_con3 = NamedSharding(mesh, P(None, self.axis, None))  # Fs/spos
        s_con2 = NamedSharding(mesh, P(None, self.axis))  # lams
        s_con1 = NamedSharding(mesh, P(self.axis))  # dpos/dw
        repl = NamedSharding(mesh, P())
        self._m_shard = NamedSharding(mesh, P(self.axis, None))

        def _place(ga: GroupArrays) -> GroupArrays:
            # problem data is replicated (iteration-invariant, broadcast
            # once at setup); the per-iteration COMPUTE is what shards —
            # the build constrains Fs/lams to the constraint-row sharding
            # in-graph, so each device contracts only its rows of M
            return jax.device_put(ga, repl)

        self.groups = tuple(_place(ga) for ga in self.groups)
        if self.lp is not None:
            self.lp = jax.device_put(self.lp, repl)

        # M is returned PADDED to a multiple of ndev with an identity
        # tail (padding rows solve trivially) so the output sharding is
        # even and sticks at the jit boundary; the solver's mesh path
        # pads/slices the m-vectors it exchanges with the KKT system.
        self.m_pad = -(-m // self.ndev) * self.ndev

        def _constrain(ga: GroupArrays) -> GroupArrays:
            # shard every CONSTRAINT-indexed array over the row axis so
            # GSPMD partitions the per-row build (matmul, diag-gather,
            # or support-gather alike) instead of replicating it: each
            # bucket kernel's output rows follow its index arrays
            wsc = jax.lax.with_sharding_constraint
            rep = {"lams": wsc(ga.lams, s_con2)}
            if ga.Fs.shape[1] > 1:  # [r,1,n] = shape-only placeholder
                rep["Fs"] = wsc(ga.Fs, s_con3)
            if ga.spos is not None:
                rep["spos"] = wsc(ga.spos, s_con3)
                rep["sval"] = wsc(ga.sval, s_con3)
            if ga.dpos is not None:
                rep["dpos"] = wsc(ga.dpos, s_con1)
                rep["dw"] = wsc(ga.dw, s_con1)
            return ga._replace(**rep)

        def _build(groups, lp, L, s_lp, Rd, kind: str):
            # row side reads the constrained (row-sharded) arrays; the
            # COLUMN side of M reads the original replicated views, so
            # GSPMD never reshards the [m_loc, m] intermediates
            groups_row = tuple(_constrain(ga) for ga in groups)
            out = _build_kkt(
                groups_row, lp, L, s_lp, Rd, m=m, kind=kind,
                col_groups=groups,
            )
            if out.M is not None:
                pad = self.m_pad - m
                Mp = jnp.pad(out.M, ((0, pad), (0, pad)))
                tail = jnp.concatenate(
                    [jnp.zeros(m, Mp.dtype), jnp.ones(pad, Mp.dtype)]
                )
                Mp = Mp + jnp.diag(tail)
                out = out._replace(
                    M=jax.lax.with_sharding_constraint(Mp, self._m_shard)
                )
            return out

        def _out_shardings(kind):
            v = repl
            return KKTOut(
                M=None if kind == "corr" else self._m_shard,
                asinv=v,
                asinvrdsinv=v,
                asinvcsinv=v if kind == "hsd" else None,
                csinv=v,
                csinvcsinv=v,
                csinvrdsinv=v,
                trace_sinv=v,
            )

        self._kkt_jit = {
            kind: jax.jit(
                partial(_build, kind=kind), out_shardings=_out_shardings(kind)
            )
            for kind in ("inf", "hsd", "corr")
        }

    def build_kkt(self, L, s_lp, Rd, kind: str) -> KKTOut:
        return self._kkt_jit[kind](self.groups, self.lp, L, s_lp, Rd)
