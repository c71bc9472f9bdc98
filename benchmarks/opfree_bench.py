"""Matrix-free operator-mode scale benchmark: solve a theta-class
instance whose dense Schur matrix could not exist on the device.

At m = 40001 a dense f64 M is 12.8 GB.  Operator mode (kkt_mode="free",
auto where a dense M would crowd the device, solver.memory.kkt_free)
never forms M:
every KKT solve is Jacobi-PCG on M v = A(S^-1 (sum_j v_j A_j) S^-1).

Usage:
    python benchmarks/opfree_bench.py [n] [edges]   # default 800 40000
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import hdsdp_tpu  # noqa: E402,F401  (x64, matmul precision)
from hdsdp_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.models.synthetic import theta_sdpa
from hdsdp_tpu.solver.solver import HDSDPSolver

n = int(sys.argv[1]) if len(sys.argv) > 1 else 800
edges = int(sys.argv[2]) if len(sys.argv) > 2 else 40000

t0 = time.time()
data = theta_sdpa(n=n, n_edges=edges)
prob = SDPProblem.from_sdpa(data)
print(f"[opfree] m={prob.m} n={max(prob.block_dims)} presolve "
      f"{time.time() - t0:.1f}s  dense-M-would-be "
      f"{prob.m * prob.m * 8 / 2**30:.1f} GB", flush=True)

STATE = os.path.join(tempfile.gettempdir(), f"opfree_{n}_{edges}_state.npz")

t0 = time.time()
_tl = float(os.environ.get("HDSDP_OPFREE_TL", "0"))
solver = HDSDPSolver(prob, **({"time_limit": _tl} if _tl > 0 else {}))
if os.path.exists(STATE) and os.environ.get("OPFREE_RESUME"):
    # resume the post-solve DIMACS check from a saved end state (the
    # flaky remote-compile pipeline can kill the one-time check
    # program compile; the 50-min solve should not have to repeat)
    from hdsdp_tpu.solver import algo, dimacs as dm
    import jax.numpy as jnp

    z = np.load(STATE)
    ipm = algo.DualIPM(prob, solver.params)
    ipm.y = jnp.asarray(z["y"]); ipm.Rd = float(z["Rd"])
    ipm.perturb = float(z["perturb"]); ipm.n_iter = int(z["n_iter"])
    ipm.status = str(z["status"])
    ipm.maker_acc = algo.Maker(mu=float(z["acc_mu"]), y=jnp.asarray(z["acc_y"]), dy=None)
    ipm.maker_inacc = algo.Maker(mu=float(z["inacc_mu"]), y=jnp.asarray(z["inacc_y"]), dy=None)
    solver.ipm = ipm
    errs = dm.check_solution(ipm)
    from hdsdp_tpu.solver.solver import Result
    r = Result(status=ipm.status, p_obj=ipm.p_obj_val, d_obj=ipm.d_obj_val,
               gap=ipm.p_obj_val - ipm.d_obj_val, y=np.asarray(ipm.y),
               dimacs=errs, n_iters=ipm.n_iter,
               solve_time=float(z["solve_s"]), stats=dict(ipm._factor_stats))
    t = float(z["solve_s"])
else:
    from hdsdp_tpu.solver import algo

    ipm = algo.DualIPM(prob, solver.params)
    solver.ipm = ipm
    ipm.solve()
    solve_s = time.time() - t0
    np.savez(
        STATE, y=np.asarray(ipm.y), Rd=ipm.Rd, perturb=ipm.perturb,
        n_iter=ipm.n_iter, status=ipm.status, solve_s=solve_s,
        acc_mu=ipm.maker_acc.mu,
        acc_y=np.asarray(ipm.maker_acc.y) if ipm.maker_acc.mu > 0 else np.zeros(1),
        inacc_mu=ipm.maker_inacc.mu,
        inacc_y=np.asarray(ipm.maker_inacc.y) if ipm.maker_inacc.mu > 0 else np.zeros(1),
    )
    print(f"[opfree] solve done {ipm.status} {solve_s:.1f}s; state saved",
          flush=True)
    from hdsdp_tpu.solver import dimacs as dm

    errs = dm.check_solution(ipm)
    from hdsdp_tpu.solver.solver import Result
    r = Result(status=ipm.status, p_obj=ipm.p_obj_val, d_obj=ipm.d_obj_val,
               gap=ipm.p_obj_val - ipm.d_obj_val, y=np.asarray(ipm.y),
               dimacs=errs, n_iters=ipm.n_iter, solve_time=time.time() - t0,
               stats=dict(ipm._factor_stats))
    t = time.time() - t0

ipm = solver.ipm
peak = None
try:
    stats = jax.devices()[0].memory_stats()
    peak = stats.get("peak_bytes_in_use")
except Exception:
    pass

print(json.dumps({
    "instance": f"theta-n{n}-m{prob.m}",
    "m": prob.m,
    "status": r.status,
    "d_obj": r.d_obj,
    "iters": r.n_iters,
    "wall_s": round(t, 2),
    "s_per_iter": round(t / max(r.n_iters, 1), 3),
    "dimacs_max": float(np.max(np.abs(r.dimacs))),
    "opcg_iters": ipm._factor_stats.get("opcg_iters"),
    "kkt_free": ipm.kkt_free,
    "peak_hbm_gb": round(peak / 2**30, 2) if peak else None,
}), flush=True)
