"""Size sweep: end-to-end solve time and per-iteration Schur+Cholesky cost
across synthetic instances, single chip.

    python benchmarks/scale_bench.py [--sizes m:n,m:n,...] [--json]

mcp100-class problems (m = n = 100) are latency-floor-limited on an
accelerator.  The reference's
own published baseline is mcp100 in 0.1 s on one CPU thread
(doc/hdsdp_doc.tm:1598); everything larger has no published number, so
this sweep is the rebuild's scaling record.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hdsdp_tpu  # noqa: E402,F401  (x64, matmul precision)
from hdsdp_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def run_case(m: int, n: int, seed: int = 11):
    from hdsdp_tpu.models.problem import SDPProblem
    from hdsdp_tpu.models.synthetic import random_sdpa
    from hdsdp_tpu.solver.solver import HDSDPSolver

    t0 = time.time()
    data = random_sdpa(m=m, block_dims=[n], rank1_frac=1.0, density=0.05, seed=seed)
    prob = SDPProblem.from_sdpa(data)
    gen_s = time.time() - t0

    t0 = time.time()
    r = HDSDPSolver(prob, verbose=False).optimize()
    cold_s = time.time() - t0

    t0 = time.time()
    r = HDSDPSolver(prob, verbose=False).optimize()
    warm_s = time.time() - t0

    return {
        "m": m,
        "n": n,
        "status": r.status,
        "iters": r.n_iters,
        "gen_s": round(gen_s, 2),
        "cold_s": round(cold_s, 2),
        "warm_s": round(warm_s, 2),
        "s_per_iter": round(warm_s / max(r.n_iters, 1), 3),
        "dimacs_max": float(np.max(np.abs(r.dimacs))),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="100:100,256:128,512:256,1024:512")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    rows = []
    for tok in args.sizes.split(","):
        m, n = (int(x) for x in tok.split(":"))
        row = run_case(m, n)
        rows.append(row)
        if args.json:
            print(json.dumps(row), flush=True)
        else:
            print(
                f"m={row['m']:5d} n={row['n']:5d}  {row['status']:22s} "
                f"iters={row['iters']:3d}  cold={row['cold_s']:8.1f}s  "
                f"warm={row['warm_s']:7.1f}s  {row['s_per_iter']:6.3f}s/iter  "
                f"dimacs={row['dimacs_max']:.1e}",
                flush=True,
            )
    return rows


if __name__ == "__main__":
    main()
