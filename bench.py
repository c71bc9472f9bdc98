"""Benchmark driver: one JSON line per case, on one NVIDIA GPU.

    python bench.py                 # every case in ORDER
    python bench.py maxG51 maxG55   # the named cases

Each case runs in a subprocess of its own, one at a time, so that a
single JAX process holds the card; this parent never imports JAX.  The
child refuses to run (exit 2) unless JAX's first device is a GPU.  Each
case solves its instance three times through HDSDPSolver(prob).optimize()
with no overrides: a cold run (compile + solve, against the persistent
compile cache of hdsdp_tpu.utils.cache) and two warm runs; the metric is
the faster warm run.  A case passes at status PRIMAL_DUAL_OPTIMAL, dObj
within 1e-6 relative of its golden and DIMACS max at or under its gate;
otherwise, or when it exceeds its time limit (HDSDP_BENCH_CASE_TIMEOUT_S,
default 1200 s), its line says FAILED and carries no time.  The exit
code is 1 if any case failed.

Every line names the platform, device_kind, device count and the card's
name and power limit as nvidia-smi reports them.

Goldens and baselines: the reference binary, built with cmake against
netlib BLAS and run on one CPU thread on byte-identical instances written
with hdsdp_tpu.io.sdpa.write_sdpa (ref driver: tests/sdpasolve.c:185-278):
  maxG51  (n=m=1000):  23.7 s, dObj -2.6142702231e+02, 35 iters
  maxG55  (n=m=5000):  2931.9 s opt (3070.0 total), dObj -1.3466413695e+03,
                       DIMACS max 5.81e-09
  torus22 (n=m=10648): 22274.8 s opt (23274.5 total), dObj -2.7298678860e+03,
                       DIMACS max 1.87e-09
"""

import json
import os
import subprocess
import sys
import time

# name: (family, generator kwargs, reference-binary seconds, golden dObj,
#        DIMACS gate)
CASES = {
    "maxG51": ("maxcut", dict(n=1000), 23.7, -261.4270223, 1e-5),
    "maxG55": ("maxcut", dict(n=5000), 2931.9, -1346.6413695, 1e-5),
    "torus22": ("torus", dict(side=22), 22274.8, -2729.8678860, 1e-5),
}
ORDER = ["maxG51", "maxG55", "torus22"]


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _run_case(name: str) -> None:
    """Child-process body: solve the case cold + twice warm, print ONE
    JSON line."""
    import jax
    import numpy as np

    import hdsdp_tpu  # noqa: F401  (x64, matmul precision)
    from hdsdp_tpu.models.problem import SDPProblem
    from hdsdp_tpu.models.synthetic import maxcut_sdpa, torus_sdpa
    from hdsdp_tpu.solver.solver import HDSDPSolver
    from hdsdp_tpu.utils.cache import enable_compile_cache
    from hdsdp_tpu.utils.device import gpu_name_and_power_limit, require_gpu

    dev = require_gpu()
    enable_compile_cache()
    fam, kw, baseline_s, golden, gate = CASES[name]
    gen = {"maxcut": maxcut_sdpa, "torus": torus_sdpa}[fam]
    prob = SDPProblem.from_sdpa(gen(**kw))

    times = []
    for _ in range(3):
        solver = HDSDPSolver(prob, verbose=False)
        t0 = time.perf_counter()
        r = solver.optimize()
        times.append(time.perf_counter() - t0)
    warm = min(times[1:])
    dmax = float(np.max(np.abs(r.dimacs)))
    ok = (
        r.status == "PRIMAL_DUAL_OPTIMAL"
        and abs(r.d_obj - golden) <= 1e-6 * abs(golden)
        and dmax <= gate
    )
    driver, schur = solver.ipm.plan()
    _emit({
        "metric": f"{name}_warm_solve_s" + ("" if ok else "_FAILED"),
        "value": warm if ok else None,
        "unit": "s",
        "vs_baseline": baseline_s / warm if ok else None,
        "cold_s": times[0],
        "warm_runs_s": times[1:],
        "iters": r.n_iters,
        "status": r.status,
        "dobj": r.d_obj,
        "dimacs_max": dmax,
        "driver": driver,
        "schur": schur,
        "peak_bytes_in_use": (
            jax.local_devices()[0].memory_stats() or {}
        ).get("peak_bytes_in_use"),
        "platform": dev["platform"],
        "device_kind": dev["kind"],
        "device_count": dev["count"],
        "card": gpu_name_and_power_limit(),
    })


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--case":
        _run_case(sys.argv[2])
        return 0
    names = sys.argv[1:] or ORDER
    unknown = [n for n in names if n not in CASES]
    if unknown:
        print(f"unknown case(s) {unknown}; known: {ORDER}", file=sys.stderr)
        return 2
    timeout = float(os.environ.get("HDSDP_BENCH_CASE_TIMEOUT_S", "1200"))
    failed = False
    for name in names:
        fail = {"metric": f"{name}_warm_solve_s_FAILED", "value": None,
                "unit": "s"}
        try:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--case", name],
                timeout=timeout, capture_output=True, text=True,
            )
        except subprocess.TimeoutExpired:
            _emit(dict(fail, reason=f"exceeded {timeout:.0f} s"))
            failed = True
            continue
        line = None
        for ln in (p.stdout or "").splitlines():
            if ln.startswith("{"):
                line = json.loads(ln)
        if line is None:
            tail = ((p.stderr or "") + (p.stdout or ""))[-600:]
            _emit(dict(fail, reason=f"rc={p.returncode}", tail=tail))
            failed = True
            continue
        _emit(line)
        failed = failed or line["value"] is None
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
