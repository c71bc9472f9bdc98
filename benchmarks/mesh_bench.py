"""Scaling of the distributed Schur path on a virtual CPU mesh.

Times the three distributed stages of one KKT iteration (SURVEY.md
section 3.2 hot loop) at a fixed problem size over growing meshes
(strong scaling), plus a grown-problem row (per-device rows fixed):

  * row-sharded Schur assembly (parallel.schur.RowShardedConeSystem),
  * distributed blocked Cholesky of M (parallel.dchol.sharded_cholesky),
  * the 3-RHS triangular solves (parallel.dchol.sharded_chol_solve).

Run with virtual devices (several real devices run the same code):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python benchmarks/mesh_bench.py

Host CPU caveat: virtual devices share the machine's physical cores,
so the total compute throughput is CONSTANT
across mesh sizes here; the strong-scaling signal is therefore "time
stays flat as devices split the same work" -- any rise is pure
collective/partition overhead, which is the thing worth measuring on a
host.  Real speedup needs real devices.  The numbers also certify that
per-device memory scales: M is born row-sharded and no device ever
holds all of it.
"""

import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import hdsdp_tpu  # noqa: E402,F401  (x64, matmul precision)

import jax.numpy as jnp
import numpy as np

from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.models.synthetic import theta_sdpa
from hdsdp_tpu.parallel import make_mesh
from hdsdp_tpu.parallel.dchol import sharded_chol_solve, sharded_cholesky
from hdsdp_tpu.parallel.schur import RowShardedConeSystem

ROWS_PER_DEV = int(os.environ.get("ROWS_PER_DEV", 512))
REPS = 5


def run(ndev: int, m: int) -> dict:
    data = theta_sdpa(n=128, n_edges=m - 1, seed=7)
    prob = SDPProblem.from_sdpa(data)
    mesh = make_mesh(ndev)
    cones = RowShardedConeSystem(prob, mesh)
    y = jnp.zeros((prob.m,), jnp.float64)
    rd = -float(prob.features.obj_fro_norm) - 10.0
    S, s_lp = cones.assemble(1.0, -1.0, y, -rd)
    ok, L = cones.factor(S, s_lp)
    assert bool(ok)

    def assemble():
        return cones.build_kkt(L, s_lp, rd, "inf")

    kkt = assemble()  # compile
    kkt.M.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(REPS):
        assemble().M.block_until_ready()
    t_asm = (time.perf_counter() - t0) / REPS

    fac = sharded_cholesky(mesh, kkt.M)  # compile
    jax.block_until_ready(fac.L)
    t0 = time.perf_counter()
    for _ in range(REPS):
        jax.block_until_ready(sharded_cholesky(mesh, kkt.M).L)
    t_fac = (time.perf_counter() - t0) / REPS

    rhs = jnp.stack([jnp.asarray(prob.b), kkt.asinv, kkt.asinvrdsinv], 1)
    rhs = jnp.pad(rhs, ((0, fac.m - prob.m), (0, 0)))
    sharded_chol_solve(fac, rhs).block_until_ready()  # compile
    t0 = time.perf_counter()
    for _ in range(REPS):
        sharded_chol_solve(fac, rhs).block_until_ready()
    t_sol = (time.perf_counter() - t0) / REPS

    local_rows = max(s.data.shape[0] for s in kkt.M.addressable_shards)
    assert ndev == 1 or local_rows < prob.m
    return {
        "ndev": ndev,
        "m": prob.m,
        "rows_per_dev_local": int(local_rows),
        "assemble_s": round(t_asm, 4),
        "factor_s": round(t_fac, 4),
        "solve3_s": round(t_sol, 4),
    }


def main():
    m = int(os.environ.get("MESH_BENCH_M", 2048))
    ndevs = [int(t) for t in sys.argv[1:]] or [1, 2, 4, 8]
    avail = len(jax.devices())
    rows = []
    for nd in ndevs:
        if nd > avail:
            continue
        r = run(nd, m)
        rows.append(r)
        print(json.dumps(r), flush=True)
    if len(rows) > 1:
        base = rows[0]
        ovh = {
            f"strong_overhead_ndev{r['ndev']}": round(
                (r["assemble_s"] + r["factor_s"])
                / (base["assemble_s"] + base["factor_s"]),
                3,
            )
            for r in rows[1:]
        }
        print(json.dumps(ovh), flush=True)


if __name__ == "__main__":
    main()
