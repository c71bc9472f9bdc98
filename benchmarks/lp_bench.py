"""LP primal vs primal-dual benchmark harness.

Counterpart of the reference's ``test_primal_primal_dual_bench``
(ref tests/test_file_io.c:506-717): repeated solves of an MPS instance
with the primal-only phase enabled vs disabled, comparing wall time,
iteration count and status.

    python benchmarks/lp_bench.py tests/data/lp_medium.mps [--repeats 3]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hdsdp_tpu  # noqa: E402,F401  (x64, matmul precision)
from hdsdp_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("file")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    from hdsdp_tpu.solver.lpsolve import solve_mps_file

    print(f"{'mode':14s} {'rep':>3s} {'status':22s} {'pObj':>16s} "
          f"{'iters':>5s} {'time':>8s}")
    for primal in (True, False):
        mode = "hybrid+primal" if primal else "primal-dual"
        for rep in range(args.repeats):
            t0 = time.time()
            r = solve_mps_file(
                args.file, verbose=False, primal_method=primal
            )
            print(
                f"{mode:14s} {rep:3d} {r.status:22s} {r.p_obj:16.8e} "
                f"{r.n_iters:5d} {time.time()-t0:7.2f}s",
                flush=True,
            )


if __name__ == "__main__":
    main()
