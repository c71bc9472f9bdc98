"""Stage-profile a maxG51-class solve through the host loop.

Usage: python benchmarks/profile_maxg.py [n] [mode]
  n    — maxcut size (default 1000)
  mode — "host" (stage regions, default) or "iter"/"phase" (end-to-end only)

Prints the Region report (per-stage wall seconds) so the dominant cost
of one IPM iteration is visible (≙ HDSDP_LINSYS_PROFILE output,
ref linalg/hdsdp_linsolver.c:1092-1131).
"""

import os
import sys
import time


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hdsdp_tpu  # noqa: E402,F401  (x64, matmul precision)
from hdsdp_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    mode = sys.argv[2] if len(sys.argv) > 2 else "host"

    from hdsdp_tpu.models.problem import SDPProblem
    from hdsdp_tpu.models.synthetic import maxcut_sdpa
    from hdsdp_tpu.solver.params import Params
    from hdsdp_tpu.solver.solver import HDSDPSolver

    prob = SDPProblem.from_sdpa(maxcut_sdpa(n=n))
    fused = False if mode == "host" else mode
    kw = dict(verbose=False, fused=fused, profile=(mode == "host"))

    s = HDSDPSolver(prob, **kw)
    t0 = time.time()
    r = s.optimize()
    cold = time.time() - t0

    s2 = HDSDPSolver(prob, **kw)
    t0 = time.time()
    r = s2.optimize()
    warm = time.time() - t0
    print(f"n={n} mode={mode} cold={cold:.1f}s warm={warm:.1f}s "
          f"status={r.status} dObj={r.d_obj:.9g} iters={r.n_iters}")
    ipm = getattr(s2, "_ipm", None) or getattr(s2, "ipm", None)
    if ipm is not None and getattr(ipm, "region", None) is not None:
        print(ipm.region.report())


if __name__ == "__main__":
    main()
