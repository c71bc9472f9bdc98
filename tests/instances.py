"""The in-repo test instances under tests/data and the goldens they carry.

Every file under tests/data is written by this module from a seeded
generator, so the suite needs nothing outside the repository:

    python tests/instances.py        # rewrite tests/data

The SDP goldens are independent of the solver: closed forms (the Lovász
theta of the 5-cycle is sqrt(5), of the Petersen graph 4; a one-system
control instance is solved by a Lyapunov equation), or the reference
binary's optimum on the byte-identical instance (gpp100).  The other SDP
instances are checked by an independent primal-dual certificate
(:func:`certificate`).  The LP goldens come from
``scipy.optimize.linprog(method="highs")`` on the same data.
"""

from __future__ import annotations

import io
import os

import numpy as np

from hdsdp_tpu.io.sdpa import write_sdpa
from hdsdp_tpu.models import synthetic

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _petersen():
    outer = [(i, (i + 1) % 5) for i in range(5)]
    inner = [(5 + i, 5 + (i + 2) % 5) for i in range(5)]
    spokes = [(i, i + 5) for i in range(5)]
    e = np.asarray(outer + inner + spokes)
    return 10, e[:, 0], e[:, 1]


def _cycle(n):
    i = np.arange(n)
    return n, i, (i + 1) % n


# file name -> generator of its SDPAData
SDPA = {
    "maxcut100.dat-s": lambda: synthetic.maxcut_sdpa(n=100, seed=0),
    "theta50.dat-s": lambda: synthetic.theta_sdpa(n=50, n_edges=103, seed=1),
    "theta_c5.dat-s": lambda: synthetic.theta_from_edges(*_cycle(5)),
    "theta_petersen.dat-s": lambda: synthetic.theta_from_edges(*_petersen()),
    "gpp100.dat-s": lambda: synthetic.gpp_sdpa(n=100, seed=1),
    "control10.dat-s": lambda: synthetic.control_sdpa(k=10, n_sys=1, seed=7),
}


def control10_optimum() -> float:
    """min tr(P) s.t. -(A'P + PA) >= I is attained at the Lyapunov solution
    of A'P + PA = -I (see synthetic.control_sdpa); the solver maximizes
    b'y = -tr(P).  A is rebuilt from the generator's seed path."""
    import scipy.linalg

    rng = np.random.default_rng(7)
    k = 10
    G = rng.normal(size=(k, k)) / np.sqrt(k)
    lam = 0.5 * np.linalg.norm(G + G.T, 2) + 0.5
    A = G - lam * np.eye(k)
    return -float(np.trace(scipy.linalg.solve_lyapunov(A.T, -np.eye(k))))


# file name -> dual objective (b'y, the solver's sign convention)
SDP_GOLDEN = {
    "theta_c5.dat-s": -np.sqrt(5.0),
    "theta_petersen.dat-s": -4.0,
    # reference binary on gpp_sdpa(n=100, seed=1): dObj -3.7773118717e+02
    "gpp100.dat-s": -377.73118717,
    "control10.dat-s": None,  # control10_optimum(), computed on use
}


def sdp_golden(name: str) -> float:
    if name == "control10.dat-s":
        return control10_optimum()
    return SDP_GOLDEN[name]


def sdpa_text(name: str) -> str:
    buf = io.StringIO()
    write_sdpa(SDPA[name](), buf)
    return buf.getvalue()


def path(name: str) -> str:
    return os.path.join(DATA_DIR, name)


# ---------------------------------------------------------------------------
# LP instances
# ---------------------------------------------------------------------------

# file name -> (rows, cols, density, seed)
LP = {
    "lp_small.mps": (20, 30, 0.3, 1),
    "lp_medium.mps": (60, 110, 0.3, 2),
    "lp_large.mps": (240, 500, 0.02, 3),
}


def random_lp(m: int, n: int, density: float, seed: int):
    """A feasible, bounded LP with E, L and G rows and some upper bounds:
    (c, A, senses, rhs, ub) with 0 <= x <= ub."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)) * (rng.random((m, n)) < density)
    A[np.arange(m), rng.integers(0, n, size=m)] += 1.0  # no empty row
    x0 = rng.random(n) + 0.1
    ub = np.where(rng.random(n) < 0.5, x0 + 1.0 + rng.random(n), np.inf)
    ax = A @ x0
    senses = np.array(["E", "L", "G"])[np.arange(m) % 3]
    slack = rng.random(m) + 0.1
    rhs = np.where(senses == "L", ax + slack,
                   np.where(senses == "G", ax - slack, ax))
    # negative costs only where x is bounded above: bounded objective
    c = np.where(np.isfinite(ub), rng.normal(size=n), rng.random(n) + 0.1)
    return c, A, senses, rhs, ub


def mps_text(name: str) -> str:
    return format_mps(name.split(".")[0].upper(), *random_lp(*LP[name]))


def format_mps(title, c, A, senses, rhs, ub) -> str:
    """Free-format MPS text of min c'x s.t. A x (senses) rhs, 0 <= x <= ub."""
    m, n = A.shape
    out = [f"NAME          {title}", "ROWS", " N  COST"]
    out += [f" {s}  R{i}" for i, s in enumerate(senses)]
    out.append("COLUMNS")
    for j in range(n):
        out.append(f"    X{j}  COST  {float(c[j])!r}")
        for i in np.nonzero(A[:, j])[0]:
            out.append(f"    X{j}  R{i}  {float(A[i, j])!r}")
    out.append("RHS")
    out += [f"    RHS  R{i}  {float(v)!r}" for i, v in enumerate(rhs)]
    out.append("BOUNDS")
    out += [f" UP BND  X{j}  {float(v)!r}" for j, v in enumerate(ub) if np.isfinite(v)]
    out.append("ENDATA")
    return "\n".join(out) + "\n"


def lp_golden(name: str) -> float:
    return linprog_optimum(*random_lp(*LP[name]))


def linprog_optimum(c, A, senses, rhs, ub) -> float:
    from scipy.optimize import linprog

    le = senses == "L"
    ge = senses == "G"
    eq = senses == "E"
    r = linprog(
        c,
        A_ub=np.vstack([A[le], -A[ge]]),
        b_ub=np.concatenate([rhs[le], -rhs[ge]]),
        A_eq=A[eq], b_eq=rhs[eq],
        bounds=[(0.0, None if not np.isfinite(u) else u) for u in ub],
        method="highs",
    )
    assert r.status == 0, r.message
    return float(r.fun)


# ---------------------------------------------------------------------------
# independent primal-dual certificate
# ---------------------------------------------------------------------------


def _dense_blocks(data):
    """Per SDP block: C [n, n] and A [m, n, n], symmetric, from raw COO."""
    out = []
    for blk in data.blocks:
        n = blk.dim
        T = np.zeros((data.m + 1, n, n))
        np.add.at(T, (blk.con, blk.row, blk.col), blk.val)
        off = blk.row != blk.col
        np.add.at(T, (blk.con[off], blk.col[off], blk.row[off]), blk.val[off])
        out.append((T[0], T[1:]))
    return out


def certificate(data, X_blocks, y):
    """DIMACS-style relative errors of a primal-dual pair, computed with
    numpy from the raw instance alone: (primal infeasibility, primal cone
    violation, dual cone violation, duality gap).  Weak duality makes a
    pair with all four small a certificate of b'y's optimality."""
    y = np.asarray(y)
    b = np.asarray(data.b)
    ax = np.zeros(data.m)
    cx = 0.0
    x_eig = 0.0
    s_eig = 0.0
    c_norm = 0.0
    for (C, A), X in zip(_dense_blocks(data), X_blocks):
        X = np.asarray(X)
        ax += np.einsum("ipq,pq->i", A, X)
        cx += float(np.sum(C * X))
        x_eig = min(x_eig, float(np.linalg.eigvalsh(X)[0]))
        S = C - np.einsum("i,ipq->pq", y, A)
        s_eig = min(s_eig, float(np.linalg.eigvalsh(S)[0]))
        c_norm = max(c_norm, float(np.abs(C).max()))
    by = float(b @ y)
    return (
        float(np.linalg.norm(ax - b)) / (1.0 + float(np.abs(b).sum())),
        -x_eig / (1.0 + float(np.abs(b).sum())),
        -s_eig / (1.0 + c_norm),
        abs(cx - by) / (1.0 + abs(cx) + abs(by)),
    )


if __name__ == "__main__":
    os.makedirs(DATA_DIR, exist_ok=True)
    for name in SDPA:
        with open(path(name), "w") as f:
            f.write(sdpa_text(name))
    for name in LP:
        with open(path(name), "w") as f:
            f.write(mps_text(name))
