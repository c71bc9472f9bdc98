"""Command-line driver: extension-dispatched solves.

Equivalent of the reference's ``sdpasolve`` binary
(ref tests/sdpasolve.c:12-19, tests/test_file_io.c:339-354):
``.dat-s`` files go to the SDP solver, ``.mps`` to the LP solver.

    python -m hdsdp_tpu problem.dat-s [--dual-only] [--quiet]
    python -m hdsdp_tpu problem.mps
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hdsdp_tpu",
        description="dual-scaling interior-point SDP/LP solver",
    )
    ap.add_argument("file", help="problem file (.dat-s for SDP, .mps for LP)")
    ap.add_argument("--dual-only", action="store_true",
                    help="stop at a dual optimal solution (SDP only)")
    ap.add_argument("--quiet", action="store_true", help="suppress logs")
    ap.add_argument("--json", action="store_true",
                    help="print a one-line JSON summary")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--time-limit", type=float, default=None)
    ap.add_argument("--no-fused", action="store_true",
                    help="use the host-driven reference loop")
    args = ap.parse_args(argv)

    from hdsdp_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    fname = args.file.lower()
    overrides = {"verbose": not args.quiet}
    if args.max_iter is not None:
        overrides["max_iter"] = args.max_iter
    if args.time_limit is not None:
        overrides["time_limit"] = args.time_limit

    if fname.endswith(".mps"):
        from hdsdp_tpu.solver.lpsolve import solve_mps_file

        overrides.pop("fused", None)
        r = solve_mps_file(args.file, **overrides)
        summary = {
            "status": r.status,
            "pObj": r.p_obj,
            "dObj": r.d_obj,
            "iters": r.n_iters,
            "time_s": round(r.solve_time, 3),
        }
    elif fname.endswith(".dat-s") or fname.endswith(".dat"):
        from hdsdp_tpu.solver.solver import solve_sdpa_file

        if args.no_fused:
            overrides["fused"] = False
        r = solve_sdpa_file(args.file, d_only=args.dual_only, **overrides)
        summary = {
            "status": r.status,
            "pObj": r.p_obj,
            "dObj": r.d_obj,
            "iters": r.n_iters,
            "time_s": round(r.solve_time, 3),
            "dimacs_max": float(abs(r.dimacs).max()),
        }
    else:
        print(f"unrecognized extension: {args.file}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(summary))
    ok = summary["status"] in ("PRIMAL_DUAL_OPTIMAL", "DUAL_OPTIMAL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
