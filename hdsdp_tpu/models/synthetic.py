"""Synthetic SDP instance generator.

Produces random primal-dual strictly feasible problems in the same raw COO
form as the SDPA reader (hdsdp_tpu.io.sdpa.SDPAData), so benchmarks and the
multi-chip dry-run exercise the exact presolve + solve path used for real
files.  Feasibility construction: pick X0 ≻ 0 and (y0, S0 ≻ 0), set
b = A(X0) and C = S0 + A'y0; then both primal and dual are strictly
feasible, hence the problem is solvable with zero duality gap.

The constraint mix (rank-1 vs sparse vs dense coefficients) mirrors the
structures the reference classifies into its five coefficient types
(ref linalg/hdsdp_sdpdata.c:2321-2345).  Constraints are generated in COO
form directly — no dense [m, n, n] stack — so million-entry instances
generate in seconds.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from hdsdp_tpu.io.sdpa import BlockEntries, LPEntries, SDPAData


def _tri(entries: dict, i, j, v):
    """Accumulate a lower-triangle COO entry."""
    key = (max(i, j), min(i, j))
    entries[key] = entries.get(key, 0.0) + v


def random_sdpa(
    m: int = 32,
    block_dims: Optional[List[int]] = None,
    n_lp: int = 0,
    rank1_frac: float = 0.5,
    density: float = 0.3,
    seed: int = 0,
) -> SDPAData:
    """Generate a strictly feasible random SDP in raw SDPA COO form."""

    if block_dims is None:
        block_dims = [16, 16]
    rng = np.random.default_rng(seed)

    y0 = rng.normal(size=m) * 0.1
    b = np.zeros(m)
    A_lp = rng.normal(size=(m, n_lp)) if n_lp else np.zeros((m, 0))

    data = SDPAData(m=m, block_dims=list(block_dims), b=b)
    nnz = 0

    for n in block_dims:
        # strictly feasible primal/dual certificates for this block
        G = rng.normal(size=(n, n)) / np.sqrt(n)
        X0 = G @ G.T + 0.5 * np.eye(n)
        H = rng.normal(size=(n, n)) / np.sqrt(n)
        S0 = H @ H.T + 0.5 * np.eye(n)

        C_acc = S0.copy()  # C = S0 + sum_i y0_i A_i, accumulated sparsely
        cons, rows, cols, vals = [], [], [], []

        for i in range(m):
            if rng.random() < rank1_frac:
                # sparse rank-1: A_i = +/- v v^T on a small support
                k = max(1, min(n, int(round(density * n))))
                sup = rng.choice(n, size=k, replace=False)
                v = rng.normal(size=k)
                sgn = 1.0 if rng.random() < 0.5 else -1.0
                Ai_sub = sgn * np.outer(v, v)
                # b_i += tr(A_i X0) on the support
                b[i] += sgn * float(v @ X0[np.ix_(sup, sup)] @ v)
                C_acc[np.ix_(sup, sup)] += y0[i] * Ai_sub
                il, jl = np.tril_indices(k)
                keep = Ai_sub[il, jl] != 0.0
                gi, gj = sup[il[keep]], sup[jl[keep]]
                lo = np.maximum(gi, gj)
                hi = np.minimum(gi, gj)
                cons.append(np.full(keep.sum(), i + 1, np.int32))
                rows.append(lo.astype(np.int32))
                cols.append(hi.astype(np.int32))
                vals.append(Ai_sub[il, jl][keep])
            else:
                # sparse symmetric general matrix
                k = max(2, min(n, int(round(density * n))))
                sup = rng.choice(n, size=k, replace=False)
                B = rng.normal(size=(k, k))
                Ai_sub = 0.5 * (B + B.T)
                b[i] += float(np.sum(Ai_sub * X0[np.ix_(sup, sup)]))
                C_acc[np.ix_(sup, sup)] += y0[i] * Ai_sub
                il, jl = np.tril_indices(k)
                gi, gj = sup[il], sup[jl]
                lo = np.maximum(gi, gj)
                hi = np.minimum(gi, gj)
                cons.append(np.full(len(il), i + 1, np.int32))
                rows.append(lo.astype(np.int32))
                cols.append(hi.astype(np.int32))
                vals.append(Ai_sub[il, jl])

        il, jl = np.tril_indices(n)
        cv = C_acc[il, jl]
        keep = cv != 0.0
        cons.append(np.zeros(keep.sum(), np.int32))
        rows.append(il[keep].astype(np.int32))
        cols.append(jl[keep].astype(np.int32))
        vals.append(cv[keep])

        blk = BlockEntries(
            dim=n,
            con=np.concatenate(cons),
            row=np.concatenate(rows),
            col=np.concatenate(cols),
            val=np.concatenate(vals),
        )
        nnz += len(blk.val)
        data.blocks.append(blk)

    if n_lp:
        x0 = 0.5 + rng.random(n_lp)
        b += A_lp @ x0
        s0 = 0.5 + rng.random(n_lp)
        c_lp = s0 + A_lp.T @ y0
        con_idx = [np.zeros(n_lp, np.int32)]
        var_idx = [np.arange(n_lp, dtype=np.int32)]
        val_l = [c_lp]
        for i in range(m):
            con_idx.append(np.full(n_lp, i + 1, np.int32))
            var_idx.append(np.arange(n_lp, dtype=np.int32))
            val_l.append(A_lp[i])
        data.lp = LPEntries(
            ncols=n_lp,
            con=np.concatenate(con_idx),
            var=np.concatenate(var_idx),
            val=np.concatenate(val_l),
        )
        nnz += n_lp * (m + 1)

    data.nnz = nnz
    return data


def theta_sdpa(n: int = 300, n_edges: int = 4374, seed: int = 0) -> SDPAData:
    """Lovász theta-function SDP of a random graph, in SDPA COO form.

    Exactly the structure of SDPLIB's theta* / thetaG* family (theta6:
    n = 300, m = 4375):

        max <J, X>  s.t.  tr(X) = 1,  X_ij = 0 for (i,j) in E,  X >= 0

    written as min <-J, X>: constraint 1 is the identity (rank n ->
    dense bucket + implied-trace feature), constraints 2..m are
    e_i e_j^T + e_j e_i^T (rank-2, support-2 -> slot-major low-rank
    bucket).  The optimum is the theta number of the graph (>= 1).
    """
    rng = np.random.default_rng(seed)
    max_edges = n * (n - 1) // 2
    n_edges = min(n_edges, max_edges)
    # sample distinct edges
    flat = rng.choice(max_edges, size=n_edges, replace=False)
    iu, ju = np.triu_indices(n, 1)
    return theta_from_edges(n, iu[flat], ju[flat])


def theta_from_edges(n: int, ei, ej) -> SDPAData:
    """Lovász theta SDP (see :func:`theta_sdpa`) of the graph on n
    vertices with edges (ei[k], ej[k])."""
    ei, ej = np.minimum(ei, ej), np.maximum(ei, ej)  # ei < ej
    n_edges = len(ei)
    m = 1 + n_edges
    b = np.zeros(m)
    b[0] = 1.0

    cons, rows, cols, vals = [], [], [], []
    # C = -J (min form), lower triangle
    il, jl = np.tril_indices(n)
    cons.append(np.zeros(len(il), np.int32))
    rows.append(il.astype(np.int32))
    cols.append(jl.astype(np.int32))
    vals.append(np.full(len(il), -1.0))
    # A_1 = I
    d = np.arange(n, dtype=np.int32)
    cons.append(np.full(n, 1, np.int32))
    rows.append(d)
    cols.append(d)
    vals.append(np.ones(n))
    # A_{k+1} = e_i e_j^T + e_j e_i^T  (one lower-tri entry of 1.0)
    cons.append(np.arange(2, m + 1, dtype=np.int32))
    rows.append(ej.astype(np.int32))
    cols.append(ei.astype(np.int32))
    vals.append(np.ones(n_edges))

    data = SDPAData(m=m, block_dims=[n], b=b)
    data.blocks.append(
        BlockEntries(
            dim=n,
            con=np.concatenate(cons),
            row=np.concatenate(rows),
            col=np.concatenate(cols),
            val=np.concatenate(vals),
        )
    )
    data.nnz = sum(len(v) for v in vals)
    return data


def control_sdpa(k: int = 30, n_sys: int = 2, seed: int = 0) -> SDPAData:
    """Lyapunov/control SDP (SDPLIB control* family structure).

    SDPLIB's control1-11 instances are control-theory SDPs whose dual
    variable is a symmetric matrix P and whose blocks are Lyapunov
    operators of P (Vandenberghe-Boyd SP test set).  This generator
    reproduces that structure exactly:

        min  tr(P)
        s.t. -(A_s' P + P A_s) >= I   for s = 1..n_sys
             P >= 0

    with y = vech(P) (m = k(k+1)/2 dual variables) and n_sys + 1 blocks
    of dimension k.  Each Lyapunov coefficient A_s' E_i + E_i A_s has
    rank <= 4 but full support — the multi-slot (r = 4) slot-major
    Schur path, which neither the theta (rank 2, support 2) nor maxcut
    (rank 1) families exercise.

    The A_s are made strictly dissipative (A_s + A_s' < -c I) so P = a I
    is strictly feasible.  For n_sys = 1 the optimum is known in closed
    form: tr(P*) with A' P* + P* A = -I (scipy.linalg.solve_lyapunov),
    since any feasible P satisfies P >= P* by the integral representation
    of the Lyapunov solution.
    """
    rng = np.random.default_rng(seed)

    # basis E_i of symmetric k x k matrices, i = PACK index of (a, b)
    au, bu = np.tril_indices(k)
    m = len(au)  # k(k+1)/2

    # strictly dissipative stable systems
    systems = []
    for _ in range(n_sys):
        G = rng.normal(size=(k, k)) / np.sqrt(k)
        lam = 0.5 * np.linalg.norm(G + G.T, 2) + 0.5
        systems.append(G - lam * np.eye(k))

    # b_i = -tr(E_i): -1 on diagonal basis entries (max b'y = -min tr P)
    b = np.where(au == bu, -1.0, 0.0)

    data = SDPAData(m=m, block_dims=[k] * (n_sys + 1), b=b)
    nnz = 0

    # block 0: S_0 = P  (C_0 = 0, A_{i,0} = -E_i)
    cons = [np.arange(1, m + 1, dtype=np.int32)]
    rows = [au.astype(np.int32)]
    cols = [bu.astype(np.int32)]
    vals = [np.full(m, -1.0)]
    data.blocks.append(
        BlockEntries(
            dim=k,
            con=np.concatenate(cons),
            row=np.concatenate(rows),
            col=np.concatenate(cols),
            val=np.concatenate(vals),
        )
    )
    nnz += m

    # blocks s: S_s = -I - sum_i y_i (A_s' E_i + E_i A_s)
    for A in systems:
        entries: dict = {}
        cons, rows, cols, vals = [], [], [], []
        d = np.arange(k, dtype=np.int32)
        cons.append(np.zeros(k, np.int32))
        rows.append(d)
        cols.append(d)
        vals.append(np.full(k, -1.0))
        for i in range(m):
            a_idx, b_idx = int(au[i]), int(bu[i])
            E = np.zeros((k, k))
            E[a_idx, b_idx] = 1.0
            E[b_idx, a_idx] = 1.0
            Ai = A.T @ E + E @ A
            il, jl = np.tril_indices(k)
            v = Ai[il, jl]
            keep = v != 0.0
            cons.append(np.full(keep.sum(), i + 1, np.int32))
            rows.append(il[keep].astype(np.int32))
            cols.append(jl[keep].astype(np.int32))
            vals.append(v[keep])
        data.blocks.append(
            BlockEntries(
                dim=k,
                con=np.concatenate(cons),
                row=np.concatenate(rows),
                col=np.concatenate(cols),
                val=np.concatenate(vals),
            )
        )
        nnz += sum(len(v) for v in vals)

    data.nnz = nnz
    return data


def maxcut_sdpa(n: int = 1000, seed: int = 0, degree: int = 6) -> SDPAData:
    """MaxCut SDP relaxation of a random graph (SDPLIB maxG* family:
    maxG51 is n = m = 1000).

        min <C, X>  s.t.  X_ii = 1/4 ... (SDPLIB convention: diag(X) = b)

    C is the (scaled) graph Laplacian; every constraint is e_i e_i^T
    (rank-1): m = n, the pure slot-major r = 1 path at scale.
    """
    rng = np.random.default_rng(seed)
    n_edges = min(n * degree // 2, n * (n - 1) // 2)
    flat = rng.choice(n * (n - 1) // 2, size=n_edges, replace=False)
    iu, ju = np.triu_indices(n, 1)
    ei, ej = iu[flat], ju[flat]
    w = rng.choice([-1.0, 1.0], size=n_edges)
    return _maxcut_from_edges(n, ei, ej, w)


def torus_sdpa(side: int = 8, pm: bool = True, seed: int = 0) -> SDPAData:
    """MaxCut SDP of a 3-D periodic lattice (SDPLIB torus* family:
    toruspm3-8-50 is side=8 / n=512 with +-1 weights; torusg3-15 is
    side=15 / n=3375 with Gaussian weights).  Each vertex couples to its
    +x/+y/+z neighbors with wraparound, so the graph is 6-regular and
    m = n = side^3 — the same rank-1 diagonal-constraint structure as
    maxG*, at the lattice sizes that reach m >= 10k (side >= 22).
    """
    if side < 3:
        raise ValueError("torus_sdpa needs side >= 3 (wraparound edges collide)")
    n = side * side * side
    idx = np.arange(n, dtype=np.int64)
    x, rem = divmod(idx, side * side)
    y, z = divmod(rem, side)

    def flat(a, b, c):
        return (a % side) * side * side + (b % side) * side + (c % side)

    ei = np.concatenate([idx, idx, idx])
    ej = np.concatenate([flat(x + 1, y, z), flat(x, y + 1, z), flat(x, y, z + 1)])
    rng = np.random.default_rng(seed)
    w = (
        rng.choice([-1.0, 1.0], size=3 * n)
        if pm
        else rng.standard_normal(3 * n)
    )
    lo, hi = np.minimum(ei, ej), np.maximum(ei, ej)
    return _maxcut_from_edges(n, lo.astype(np.int64), hi.astype(np.int64), w)


def _maxcut_from_edges(n: int, ei, ej, w) -> SDPAData:
    """Shared maxcut builder: C = -Laplacian/4, constraints diag(X)=1/4."""
    n_edges = len(w)
    # C = -(diag(W e) - W) / 4  (negated Laplacian / 4, min form)
    deg = np.zeros(n)
    np.add.at(deg, ei, w)
    np.add.at(deg, ej, w)

    cons, rows, cols, vals = [], [], [], []
    d = np.arange(n, dtype=np.int32)
    cons.append(np.zeros(n, np.int32))
    rows.append(d)
    cols.append(d)
    vals.append(-deg / 4.0)
    cons.append(np.zeros(n_edges, np.int32))
    rows.append(ej.astype(np.int32))
    cols.append(ei.astype(np.int32))
    vals.append(w / 4.0)
    # constraints diag(X)_i = 1/4  (so that sum b = n/4, trace-implied)
    cons.append(np.arange(1, n + 1, dtype=np.int32))
    rows.append(d)
    cols.append(d)
    vals.append(np.ones(n))

    data = SDPAData(m=n, block_dims=[n], b=np.full(n, 0.25))
    data.blocks.append(
        BlockEntries(
            dim=n,
            con=np.concatenate(cons),
            row=np.concatenate(rows),
            col=np.concatenate(cols),
            val=np.concatenate(vals),
        )
    )
    data.nnz = sum(len(v) for v in vals)
    return data


def gpp_sdpa(n: int = 500, seed: int = 0, degree: int = 10) -> SDPAData:
    """Graph-partitioning SDP (SDPLIB gpp*/equalG* families: gpp100 is
    n=100/m=101, gpp500-x is n=500, equalG11 is n=801).

        min <C, X>  s.t.  <ee', X> = 0,  diag(X) = 1,  X >= 0 (psd)

    with C = -Laplacian/4 exactly as the bundled gpp100.dat-s fixture
    (constraint 1 = dense rank-1 all-ones with b=0; constraints
    2..n+1 = e_i e_i' with b=1 — ref examples/gpp100.dat-s).  Exercises
    the diagonal rank-1 bucket WITH a dense-classified leftover
    coefficient (the all-ones row), i.e. the mixed diag+dense cross
    terms in ops.schur._diag_schur."""
    rng = np.random.default_rng(seed)
    n_edges = min(n * degree // 2, n * (n - 1) // 2)
    flat = rng.choice(n * (n - 1) // 2, size=n_edges, replace=False)
    iu, ju = np.triu_indices(n, 1)
    ei, ej = iu[flat], ju[flat]
    w = np.ones(n_edges)

    deg = np.zeros(n)
    np.add.at(deg, ei, w)
    np.add.at(deg, ej, w)

    d = np.arange(n, dtype=np.int32)
    cons, rows, cols, vals = [], [], [], []
    # objective C = -(diag(W e) - W)/4: diag -deg/4, off-diag +w/4
    cons.append(np.zeros(n, np.int32)); rows.append(d); cols.append(d)
    vals.append(-deg / 4.0)
    cons.append(np.zeros(n_edges, np.int32))
    rows.append(ej.astype(np.int32)); cols.append(ei.astype(np.int32))
    vals.append(w / 4.0)
    # constraint 1: all-ones lower triangle (rank-1 e e'), b = 0
    il, jl = np.tril_indices(n)
    cons.append(np.ones(il.size, np.int32))
    rows.append(il.astype(np.int32)); cols.append(jl.astype(np.int32))
    vals.append(np.ones(il.size))
    # constraints 2..n+1: diag(X) = 1
    cons.append(np.arange(2, n + 2, dtype=np.int32))
    rows.append(d); cols.append(d); vals.append(np.ones(n))

    b = np.concatenate([[0.0], np.ones(n)])
    data = SDPAData(m=n + 1, block_dims=[n], b=b)
    data.blocks.append(
        BlockEntries(
            dim=n,
            con=np.concatenate(cons),
            row=np.concatenate(rows),
            col=np.concatenate(cols),
            val=np.concatenate(vals),
        )
    )
    data.nnz = sum(len(v) for v in vals)
    return data


def qpg_sdpa(n: int = 800, seed: int = 0, degree: int = 6) -> SDPAData:
    """QP-relaxation maxcut (SDPLIB qpG* family shape: qpG11 pairs the
    maxG11 graph, n=800, with a diagonal/LP block of the same size;
    qpG51 likewise at n=1000).

        min <C, X>  s.t.  X_ii + s_i = 1/4,  s >= 0,  X psd

    i.e. the maxG* equality diag constraints relaxed to inequalities via
    LP slacks — the one SDPLIB structure that couples an SDP cone and an
    LP cone in every constraint row at scale.  C = -Laplacian/4 on the
    same random graph as maxcut_sdpa.  Exercises the LP-cone Schur
    diagonal (ref interface/hdsdp_conic_lp.c:294-313) together with the
    diagonal rank-1 SDP bucket in the same rows.
    """
    rng = np.random.default_rng(seed)
    n_edges = min(n * degree // 2, n * (n - 1) // 2)
    flat = rng.choice(n * (n - 1) // 2, size=n_edges, replace=False)
    iu, ju = np.triu_indices(n, 1)
    ei, ej = iu[flat], ju[flat]
    w = rng.choice([-1.0, 1.0], size=n_edges)
    data = _maxcut_from_edges(n, ei, ej, w)
    # one LP slack per diag row: A_i gains +e_i on the LP block, c_lp = 0
    data.lp = LPEntries(
        ncols=n,
        con=np.arange(1, n + 1, dtype=np.int32),
        var=np.arange(n, dtype=np.int32),
        val=np.ones(n),
    )
    data.nnz += n
    return data
