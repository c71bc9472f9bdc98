"""Accuracy probe: which DIMACS error dominates at scale, and why.

Solves one instance, then decomposes the final DIMACS vector and
cross-checks the min-eigenvalue estimator against alternatives:

    python benchmarks/acc_probe.py maxG55 [solver_kw=json ...]

Reports per-error values, the maker (mu, which), the min-eig estimate
from the production path vs a deeper Lanczos vs (n small enough) f32
eigh + f64 Rayleigh, and the raw primal-infeasibility/compl parts —
the evidence for VERDICT round-4 item #2 (torus-22 DIMACS -> <= 1e-6).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hdsdp_tpu  # noqa: E402,F401  (x64, matmul precision)
from hdsdp_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.models.synthetic import maxcut_sdpa, theta_sdpa, torus_sdpa

INSTANCES = {
    "maxG51": (maxcut_sdpa, dict(n=1000)),
    "maxG55": (maxcut_sdpa, dict(n=5000)),
    "torus22": (torus_sdpa, dict(side=22)),
    "theta6": (theta_sdpa, dict(n=300, n_edges=4374)),
}

name = sys.argv[1] if len(sys.argv) > 1 else "maxG55"
overrides = {"fused": False, "verbose": False}
for arg in sys.argv[2:]:
    k, v = arg.split("=", 1)
    try:
        overrides[k] = json.loads(v)
    except ValueError:
        overrides[k] = v

gen, kw = INSTANCES[name]
prob = SDPProblem.from_sdpa(gen(**kw))

from hdsdp_tpu.solver import dimacs as dimacs_mod
from hdsdp_tpu.solver.solver import HDSDPSolver

t0 = time.time()
solver = HDSDPSolver(prob, **overrides)
r = solver.optimize()
wall = time.time() - t0
ipm = solver.ipm

print(f"[{name}] status={r.status} iters={r.n_iters} wall={wall:.1f}s "
      f"dObj={r.d_obj:+.10e}", flush=True)
print("DIMACS errs:", " ".join(f"{e:9.2e}" for e in r.dimacs), flush=True)
labels = ["p_infeas/(1+|b|1)", "-minev(X)", "d_infeas", "0",
          "gap/(|p|+|d|+1)", "compl/(|p|+|d|+1)"]
imax = int(np.argmax(np.abs(r.dimacs)))
print(f"dominant: errs[{imax}] = {r.dimacs[imax]:.3e}  ({labels[imax]})",
      flush=True)
print(f"makers: acc.mu={ipm.maker_acc.mu:.3e} inacc.mu={ipm.maker_inacc.mu:.3e}",
      flush=True)
for ev in getattr(ipm, "_maker_trace", [])[-25:]:
    print("  trace:", json.dumps(
        {k: (f"{v:.3e}" if isinstance(v, float) else v) for k, v in ev.items()}
    ), flush=True)

# ---- re-derive the raw parts for the maker the check used -------------
use_acc = ipm.maker_acc.mu > 0.0 and ipm.status == "PRIMAL_DUAL_OPTIMAL"
maker = ipm.maker_acc if use_acc else ipm.maker_inacc
cm = dimacs_mod._consistent_maker_solve(ipm, maker)
if cm is None:
    print(json.dumps({"maker_used": None}), flush=True)
    sys.exit(0)
Us, sbar_lp, dy = cm
out = dimacs_mod._dimacs_eval(
    ipm.cones.groups, ipm.cones.lp, ipm.b,
    jnp.asarray(ipm.y, ipm.dtype), jnp.asarray(ipm.Rd, ipm.dtype),
    jnp.asarray(ipm.perturb, ipm.dtype),
    jnp.asarray(maker.mu, ipm.dtype), dy, Us, sbar_lp, ipm.m,
)
p_obj, d_obj, compl, min_evals, lp_min, p_inf_norm, _X = out
p_obj, d_obj, compl, p_inf_norm = (
    float(v) for v in (p_obj, d_obj, compl, p_inf_norm)
)
min_eval = min(
    [float(v) for v in min_evals] + [float(lp_min)]
)
print(json.dumps({
    "maker_used": "acc" if use_acc else "inacc",
    "maker_mu": maker.mu,
    "p_obj_raw": p_obj, "d_obj_raw": d_obj,
    "gap_raw": p_obj - d_obj, "compl_raw": compl,
    "min_eval_prod": min_eval, "p_inf_norm": p_inf_norm,
    "perturb": float(ipm.perturb),
}), flush=True)

# ---- min-eig cross-checks on the recovered X --------------------------
rec = dimacs_mod.recover_primal(ipm, maker)
if rec is not None:
    X_list, _ = rec
    X0 = X_list[0][0]
    n = X0.shape[-1]
    checks = {}
    t = time.time()
    checks["lanczos_prod(k=64,r=3)"] = float(dimacs_mod._lanczos_min_one(X0))
    checks["t_prod"] = round(time.time() - t, 2)
    t = time.time()
    checks["lanczos_deep(k=128,r=8)"] = float(
        dimacs_mod._lanczos_min_one(X0, krylov=128, restarts=8))
    checks["t_deep"] = round(time.time() - t, 2)
    if n <= 6000:
        t = time.time()
        _, V = jnp.linalg.eigh(X0.astype(jnp.float32))
        v = V[:, 0].astype(X0.dtype)
        v = v / jnp.linalg.norm(v)
        checks["f32eigh+rayleigh"] = float(v @ (X0 @ v))
        checks["t_eigh32"] = round(time.time() - t, 2)
    print(json.dumps({"min_eig_checks": checks}), flush=True)
