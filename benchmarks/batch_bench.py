"""Throughput of batched multi-instance solving vs solo solves.

The small-m latency floor (dominated by ~34 dispatch-bound IPM
iterations) amortizes across a vmapped fleet:
one set of fused dispatches solves every instance.  Usage:

    python benchmarks/batch_bench.py [n] [batch]   # default n=100 batch=8
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hdsdp_tpu  # noqa: E402,F401  (x64, matmul precision)
from hdsdp_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import json

from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.models.synthetic import maxcut_sdpa
from hdsdp_tpu.solver.batch import solve_batch
from hdsdp_tpu.solver.solver import HDSDPSolver


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    bs = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    probs = [
        SDPProblem.from_sdpa(maxcut_sdpa(n=n, seed=s)) for s in range(bs)
    ]

    solve_batch(probs)  # cold: compile
    t0 = time.time()
    rb = solve_batch(probs)
    t_batch = time.time() - t0
    assert all(r.status == "PRIMAL_DUAL_OPTIMAL" for r in rb)

    HDSDPSolver(probs[0], verbose=False).optimize()  # warm solo program
    t0 = time.time()
    for p in probs:
        r = HDSDPSolver(p, verbose=False).optimize()
        assert r.status == "PRIMAL_DUAL_OPTIMAL"
    t_solo = time.time() - t0

    print(json.dumps({
        "n": n,
        "batch": bs,
        "batch_s": round(t_batch, 2),
        "solo_s": round(t_solo, 2),
        "throughput_x": round(t_solo / t_batch, 2),
        "s_per_instance_batched": round(t_batch / bs, 3),
    }))


if __name__ == "__main__":
    main()
