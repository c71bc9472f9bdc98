"""SDPLIB-class end-to-end benchmark (theta / maxcut families).

Generates instances with the exact structure of SDPLIB's theta* and
maxG* families at their published sizes (theta6: n=300 m=4375;
maxG51: n=m=1000) and solves them end-to-end, recording s/iter and
DIMACS errors.  Usage:

    python benchmarks/sdplib_bench.py theta6
    python benchmarks/sdplib_bench.py maxG51
    python benchmarks/sdplib_bench.py theta12   # n=600, m=17979-class
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hdsdp_tpu  # noqa: E402,F401  (x64, matmul precision)
from hdsdp_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.models.synthetic import (
    gpp_sdpa, maxcut_sdpa, qpg_sdpa, theta_sdpa, torus_sdpa,
)
from hdsdp_tpu.solver.solver import HDSDPSolver

# SDPLIB-published sizes (Borchers 1999): name -> generator args
CONFIGS = {
    "theta2": ("theta", dict(n=100, n_edges=1949)),
    "theta4": ("theta", dict(n=200, n_edges=1949)),
    "theta6": ("theta", dict(n=300, n_edges=4374)),
    "theta12": ("theta", dict(n=600, n_edges=17978)),
    "thetaG51": ("theta", dict(n=1001, n_edges=5910)),
    "maxG11": ("maxcut", dict(n=800)),
    "maxG51": ("maxcut", dict(n=1000)),
    "maxG55": ("maxcut", dict(n=5000)),
    "toruspm3-8-50": ("torus", dict(side=8)),
    "torusg3-15": ("torus", dict(side=15, pm=False)),
    "toruspm3-22": ("torus", dict(side=22)),  # m = 10648 >= 10k
    "qpG11": ("qpg", dict(n=800)),
    "qpG51": ("qpg", dict(n=1000)),
    "gpp500": ("gpp", dict(n=500)),
    "equalG11": ("gpp", dict(n=801)),
    "equalG51": ("gpp", dict(n=1001)),
}


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "theta6"
    fam, kw = CONFIGS[name]
    overrides = {}
    for arg in sys.argv[2:]:
        k, v = arg.split("=")
        overrides[k] = json.loads(v)

    t0 = time.time()
    gen = {"theta": theta_sdpa, "maxcut": maxcut_sdpa, "torus": torus_sdpa,
           "gpp": gpp_sdpa, "qpg": qpg_sdpa}[fam]
    data = gen(**kw)
    prob = SDPProblem.from_sdpa(data)
    t_pre = time.time() - t0
    print(f"[{name}] m={prob.m} n={max(prob.block_dims)} presolve {t_pre:.1f}s",
          flush=True)

    t0 = time.time()
    solver = HDSDPSolver(prob, **overrides)
    r = solver.optimize()
    t_cold = time.time() - t0
    print(f"[{name}] cold: {r.status} dObj={r.d_obj:.6e} iters={r.n_iters} "
          f"{t_cold:.1f}s", flush=True)

    t0 = time.time()
    r = HDSDPSolver(prob, **overrides).optimize()
    t_warm = time.time() - t0
    print(json.dumps({
        "instance": name,
        "m": prob.m,
        "n": int(max(prob.block_dims)),
        "status": r.status,
        "d_obj": r.d_obj,
        "iters": r.n_iters,
        "warm_s": round(t_warm, 2),
        "s_per_iter": round(t_warm / max(r.n_iters, 1), 3),
        "dimacs_max": float(np.max(np.abs(r.dimacs))),
    }), flush=True)


if __name__ == "__main__":
    main()
