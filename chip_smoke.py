"""Smoke test of the solver on one NVIDIA GPU, through its user entry points.

    python chip_smoke.py              # default phases, one card
    python chip_smoke.py --flagship   # torus22 (m = n = 10648) only
    python chip_smoke.py --multi      # the 4-card mesh path only

Default phases, all in this one process on device 0:

  maxG51    maxcut_sdpa(n=1000), m = n = 1000, HDSDPSolver(prob).optimize()
  maxG55    maxcut_sdpa(n=5000), m = n = 5000, the same
  cli       a theta instance written with write_sdpa and solved through
            ``python -m hdsdp_tpu``'s main(argv), in-process
  precision each f32 path that the f64 solver keeps, against its f64
            counterpart at n = m = 5000, and maxG51's iteration counts
            on the card against the CPU, driver by driver

Goldens are the reference binary's dual objectives on the byte-identical
instances; a solve passes at status PRIMAL_DUAL_OPTIMAL, dObj within 1e-6
relative of its golden and DIMACS max <= 1e-5.  The script refuses to run,
exit code 2 and no result, unless JAX's first device is a GPU.  Any failed
phase makes the exit code 1.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import traceback

import jax
import numpy as np

# reference binary on the byte-identical instances (see bench.py)
GOLDEN = {
    "maxG51": -261.4270223,
    "maxG55": -1346.6413695,
    "torus22": -2729.8678860,
}
REL_GATE = 1e-6
DIMACS_GATE = 1e-5


def log(rec: dict) -> None:
    print(json.dumps(rec, default=str), flush=True)


def _peak_bytes():
    return (jax.local_devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use")


def solve_phase(name: str, data, golden, **overrides):
    """Cold (compile + solve) and warm solve of one instance through
    HDSDPSolver(prob).optimize(); returns (record, solver of the warm run).
    ``golden`` None skips the objective gate (instances without one)."""
    from hdsdp_tpu.models.problem import SDPProblem
    from hdsdp_tpu.solver.solver import HDSDPSolver

    prob = SDPProblem.from_sdpa(data)
    times = []
    for _ in range(2):
        solver = HDSDPSolver(prob, verbose=False, **overrides)
        t0 = time.perf_counter()
        r = solver.optimize()
        times.append(time.perf_counter() - t0)
    driver, schur = solver.ipm.plan()
    dmax = float(np.max(np.abs(r.dimacs)))
    rel = None if golden is None else abs(r.d_obj - golden) / abs(golden)
    rec = {
        "phase": name, "m": prob.m, "n": max(prob.block_dims),
        "driver": driver, "schur": schur, "status": r.status,
        "iters": r.n_iters, "d_obj": r.d_obj, "golden": golden,
        "rel_err": rel, "dimacs_max": dmax,
        "cold_s": times[0], "warm_s": times[1],
        "peak_bytes_in_use": _peak_bytes(),
        "ok": bool(r.status == "PRIMAL_DUAL_OPTIMAL"
                   and (rel is None or rel <= REL_GATE)
                   and dmax <= DIMACS_GATE),
    }
    log(rec)
    return rec, solver


def cli_phase():
    """A theta instance (Petersen graph: theta = 4 exactly) solved through
    the command-line entry point, called in-process."""
    from hdsdp_tpu.__main__ import main as cli_main
    from hdsdp_tpu.io.sdpa import write_sdpa
    from hdsdp_tpu.models.synthetic import theta_from_edges

    outer = [(i, (i + 1) % 5) for i in range(5)]
    inner = [(5 + i, 5 + (i + 2) % 5) for i in range(5)]
    spokes = [(i, i + 5) for i in range(5)]
    e = np.asarray(outer + inner + spokes)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "theta_petersen.dat-s")
        write_sdpa(theta_from_edges(10, e[:, 0], e[:, 1]), path)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_main([path, "--quiet", "--json"])
        dt = time.perf_counter() - t0
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    rel = abs(summary["dObj"] + 4.0) / 4.0
    rec = {"phase": "cli", "rc": rc, **summary, "golden": -4.0,
           "rel_err": rel, "wall_s": dt,
           "ok": bool(rc == 0 and summary["status"] == "PRIMAL_DUAL_OPTIMAL"
                      and rel <= REL_GATE
                      and summary["dimacs_max"] <= DIMACS_GATE)}
    log(rec)
    return rec


def precision_probe(solver, prob51=None, iters51=None):
    """Each f32 path the f64 solver keeps, against its f64 counterpart, at
    a real iterate of ``solver`` (the final y, moved into the interior by
    a 1e-2 * max diag(S) shift so that S and M have mid-solve
    conditioning: kappa(S) ~ 1e2, kappa(M) ~ 1e4)."""
    import jax.numpy as jnp

    from hdsdp_tpu.ops import cg as cg_ops
    from hdsdp_tpu.ops import ratio as ratio_ops
    from hdsdp_tpu.solver import dimacs

    ipm = solver.ipm
    cones = ipm.cones
    shift0 = -ipm.Rd + ipm.perturb
    S, s_lp = cones.assemble(1.0, -1.0, ipm.y, shift0)
    delta = 1e-2 * float(jnp.max(jnp.abs(jnp.diagonal(S[0][0]))))
    S, s_lp = cones.assemble(1.0, -1.0, ipm.y, shift0 + delta)
    ok, L = cones.factor(S, s_lp)
    assert bool(ok), "probe iterate is not interior"
    recs = []

    # 1. Lanczos ratio test in f32 vs f64 Lanczos and the exact eigh test
    dy = jax.random.normal(jax.random.PRNGKey(3), (ipm.m,), ipm.dtype)
    dS, _ = cones.assemble(0.0, -1.0, dy, 0.0)
    L0, dS0 = L[0], dS[0]
    exact = float(ratio_ops.exact_ratio_test(L0, dS0)[0])
    lz32 = float(ratio_ops.block_ratio(L0, dS0, mode="lanczos")[0])
    lz64 = float(ratio_ops.block_ratio(L0, dS0, mode="lanczos",
                                       use_f32=False)[0])
    # f32's unit roundoff is 6e-8; through 30 reorthogonalized Lanczos
    # steps at kappa(S) ~ 1e2 the bound moves by well under 1e-5.  TF32
    # (10-bit mantissa, ~1e-3) would move it by about 1e-3.
    tol = 1e-5
    rel = abs(lz32 / 0.995 - lz64) / lz64
    recs.append({"probe": "ratio_f32_lanczos", "exact_step": exact,
                 "lanczos_f32_step": lz32, "lanczos_f64_step": lz64,
                 "rel_diff_f32_f64": rel, "tol": tol,
                 "tol_reason": "f32 roundoff (6e-8) through 30 "
                               "reorthogonalized Lanczos steps at "
                               "kappa(S) ~ 1e2 stays under 1e-5; TF32 "
                               "would move the bound ~1e-3; the f32 "
                               "bound must not exceed the exact step",
                 "ok": bool(rel <= tol and lz32 <= exact * (1 + 1e-9))})

    # 2. refine_solve: f32 factor, f64 residuals, on the card and on the
    # CPU
    kkt = cones.build_kkt(L, s_lp, ipm.Rd, "inf")
    M = kkt.M
    B = jnp.stack([ipm.b, kkt.asinv, kkt.asinvrdsinv], axis=1)
    bn = float(jnp.max(jnp.linalg.norm(B, axis=0)))

    def refine(M, B):
        Lf, s, okf = cg_ops._equilibrated_factor(M, f32=True)
        X, st, it = cg_ops.refine_solve(M, Lf, s, B)
        res = float(jnp.max(jnp.linalg.norm(B - M @ X, axis=0))) / bn
        return bool(okf), int(st), int(it), res, X

    g = refine(M, B)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        c = refine(jax.device_put(M, cpu), jax.device_put(B, cpu))
    # both converge to the f64 backward-stable floor; f32 rounding in
    # another summation order may cost or save a sweep, never more
    # than 2 (a TF32 factor would need many more or stall)
    sweep_tol = 2
    xdiff = float(jnp.max(jnp.abs(g[4] - jax.device_put(c[4], g[4].device)))
                  / jnp.max(jnp.abs(g[4])))
    recs.append({
        "probe": "refine_solve_f32_factor", "m": int(M.shape[0]),
        "gpu": {"status": g[1], "sweeps": g[2], "rel_resid": g[3]},
        "cpu": {"status": c[1], "sweeps": c[2], "rel_resid": c[3]},
        "rel_diff_gpu_vs_cpu": xdiff,
        "sweep_tol": sweep_tol, "resid_tol": 1e-10, "x_tol": 1e-10,
        "tol_reason": "refinement with f64 residuals reaches the f64 "
                      "floor (kappa(M) ~ 1e4 * eps64 << 1e-10) on both "
                      "devices; rounding in another order costs at most "
                      "2 sweeps, a TF32 factor many more",
        "ok": bool(all(r[0] and r[1] == cg_ops.STATUS_OK and r[3] <= 1e-10
                       for r in (g, c))
                   and abs(g[2] - c[2]) <= sweep_tol
                   and xdiff <= 1e-10),
    })

    # 3. DIMACS min-eigenvalue fast path (f32 eigh + f64 Rayleigh) vs f64
    X = jnp.asarray(solver.get_primal()[0][0])
    fast = float(dimacs._batch_min_eval(X[None]))
    exact_eig = float(jnp.min(jnp.linalg.eigvalsh(X)))
    # Rayleigh-quotient error O(||X|| theta^2) for the f32 eigenvector
    # angle theta; the value feeds a 1e-2-scale DIMACS gate
    tol_eig = 1e-6 * max(1.0, float(jnp.max(jnp.abs(X))))
    recs.append({"probe": "dimacs_min_eig_f32", "n": int(X.shape[0]),
                 "fast": fast, "f64_eigvalsh": exact_eig,
                 "abs_diff": abs(fast - exact_eig), "tol": tol_eig,
                 "tol_reason": "Rayleigh quotient error O(|X| theta^2) "
                               "for the f32 eigenvector's angle theta; "
                               "the value feeds a 1e-2-scale DIMACS gate",
                 "ok": bool(abs(fast - exact_eig) <= tol_eig)})

    # 4. maxG51's iterations on the card vs the CPU (f64 both), driver
    # by driver: the same algorithm on two devices differs only in
    # rounding, so a TF32 product or a device-specific defect shows as
    # drift.  The rounding on the card changes with the GEMM algorithms
    # XLA's autotuner picks at compile time: over fresh compiles the
    # iter-fused count took two values, 34 (as on the CPU) and 36, and
    # the host loop's one, 33 (as on the CPU).  The tolerance is that
    # spread plus one.  The two drivers differ by design (the fused
    # bodies run a warm-started, fixed-depth Lanczos), so across drivers
    # the counts are reported, not gated.
    if prob51 is not None:
        from hdsdp_tpu.solver.solver import HDSDPSolver

        def iters(device, **kw):
            t0 = time.perf_counter()
            with jax.default_device(device):
                r = HDSDPSolver(prob51, verbose=False, **kw).optimize()
            return r.n_iters, r.status, time.perf_counter() - t0

        gpu = jax.devices()[0]
        cpu_iter = iters(cpu, fused="iter")
        cpu_host = iters(cpu, fused=False)
        gpu_host = iters(gpu, fused=False)
        iter_tol = 3
        recs.append({
            "probe": "maxG51_iters_card_vs_cpu",
            "iter_fused": {"gpu": iters51, "cpu": cpu_iter[0]},
            "host_loop": {"gpu": gpu_host[0], "cpu": cpu_host[0]},
            "iter_fused_gpu_minus_host_loop_cpu": iters51 - cpu_host[0],
            "reference_binary": 35, "tol": iter_tol,
            "tol_reason": "the same driver on two devices differs only "
                          "in rounding, which on the card depends on "
                          "the autotuner's GEMM choices: fresh compiles "
                          "gave 34 or 36 iter-fused (CPU 34), 33 host "
                          "loop (CPU 33); tolerance = that spread + 1; "
                          "drivers differ by design and are not gated "
                          "against each other",
            "wall_s": {"cpu_iter": cpu_iter[2], "cpu_host": cpu_host[2],
                       "gpu_host": gpu_host[2]},
            "ok": bool(abs(iters51 - cpu_iter[0]) <= iter_tol
                       and abs(gpu_host[0] - cpu_host[0]) <= iter_tol
                       and all(r[1] == "PRIMAL_DUAL_OPTIMAL"
                               for r in (cpu_iter, cpu_host, gpu_host))),
        })
    for rec in recs:
        log(rec)
    return recs


def multi_phase(n_dev: int = 4, n: int = 1000):
    """The mesh path on n_dev cards: the multi-device dry run, then a
    maxG51-class solve on an n_dev mesh against the one-card solve."""
    import jax.numpy as jnp

    import __graft_entry__
    from hdsdp_tpu.models.problem import SDPProblem
    from hdsdp_tpu.models.synthetic import maxcut_sdpa
    from hdsdp_tpu.parallel import make_mesh
    from hdsdp_tpu.parallel.schur import RowShardedConeSystem

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n_dev)
    log({"phase": "dryrun_multichip", "devices": n_dev,
         "wall_s": time.perf_counter() - t0, "ok": True})

    data = maxcut_sdpa(n=n)
    golden = GOLDEN["maxG51"] if n == 1000 else None
    prob = SDPProblem.from_sdpa(data)
    mesh = make_mesh(n_dev)
    # where M's row shards live
    cones = RowShardedConeSystem(prob, mesh)
    y = jnp.zeros((prob.m,), jnp.float64)
    S, s_lp = cones.assemble(1.0, -1.0, y,
                             10.0 + float(prob.features.obj_fro_norm))
    ok, L = cones.factor(S, s_lp)
    kkt = cones.build_kkt(L, s_lp, -1.0, "inf")
    shards = sorted((str(s.device), tuple(s.data.shape))
                    for s in kkt.M.addressable_shards)
    n_shard_dev = len({d for d, _ in shards})
    log({"phase": "row_shards_of_M", "shards": shards,
         "ok": bool(ok) and n_shard_dev == n_dev})
    del kkt, S, L

    single, _ = solve_phase("single_card", data, golden)
    multi, _ = solve_phase("mesh", data, golden, mesh=mesh)
    rel = abs(multi["d_obj"] - single["d_obj"]) / abs(single["d_obj"])
    rec = {"phase": "mesh_vs_single", "rel_diff_d_obj": rel,
           "single_dimacs": single["dimacs_max"],
           "mesh_dimacs": multi["dimacs_max"],
           "ok": bool(single["ok"] and multi["ok"] and rel <= REL_GATE
                      and n_shard_dev == n_dev)}
    log(rec)
    return rec["ok"]


def run(args) -> bool:
    from hdsdp_tpu.models.problem import SDPProblem
    from hdsdp_tpu.models.synthetic import maxcut_sdpa, torus_sdpa

    failed = []

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            ok = fn()
        except Exception:  # report the phase, go on with the others
            traceback.print_exc()
            ok = False
        log({"phase_done": name, "ok": bool(ok),
             "wall_s": time.perf_counter() - t0})
        if not ok:
            failed.append(name)

    if args.multi:
        phase("multi", lambda: multi_phase(4))
    elif args.flagship:
        phase("torus22", lambda: solve_phase(
            "torus22", torus_sdpa(side=22), GOLDEN["torus22"])[0]["ok"])
    else:
        kept = {}

        def g51():
            data = maxcut_sdpa(n=1000)
            rec, _ = solve_phase("maxG51", data, GOLDEN["maxG51"])
            kept["prob51"] = SDPProblem.from_sdpa(data)
            kept["iters51"] = rec["iters"]
            return rec["ok"]

        def g55():
            rec, kept["solver55"] = solve_phase(
                "maxG55", maxcut_sdpa(n=5000), GOLDEN["maxG55"])
            return rec["ok"]

        phase("maxG51", g51)
        phase("maxG55", g55)
        phase("cli", lambda: cli_phase()["ok"])
        phase("precision", lambda: all(
            r["ok"] for r in precision_probe(
                kept["solver55"], kept.get("prob51"), kept.get("iters51"))))
    if failed:
        log({"failed_phases": failed})
    return not failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--flagship", action="store_true",
                   help="torus22 (m = n = 10648) only")
    g.add_argument("--multi", action="store_true",
                   help="the 4-card mesh path only")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's first device is {dev.platform} "
              f"({dev.device_kind}), not a GPU; refusing to run",
              file=sys.stderr)
        return 2

    import hdsdp_tpu  # noqa: F401  (x64, matmul precision)
    from hdsdp_tpu.utils.cache import enable_compile_cache
    from hdsdp_tpu.utils.device import describe, gpu_name_and_power_limit

    cache = enable_compile_cache()
    card = gpu_name_and_power_limit()
    log({"card": card, "device_kind": dev.device_kind,
         "jax": jax.__version__,
         "bytes_limit": (dev.memory_stats() or {}).get("bytes_limit"),
         "matmul_precision": jax.config.jax_default_matmul_precision,
         "compile_cache": cache})
    t0 = time.perf_counter()
    ok = run(args)
    log({"total_s": time.perf_counter() - t0})
    if not ok:
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": describe()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
