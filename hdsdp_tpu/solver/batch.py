"""Batched multi-instance solving: N same-shape SDPs in ONE fused program.

No reference counterpart — the reference (like every CPU SDP solver) is
single-instance.  On an accelerator, small-m instances are pure latency
(~34 dispatch-bound iterations); a fleet of same-shape instances (parameter sweeps, maxcut
over graph ensembles, SDP relaxation batches) can instead ride ONE set
of fused phase dispatches via ``jax.vmap``:

  * every cone kernel (batched Cholesky, Schur einsums, Lanczos) gains a
    leading instance axis and keeps the device busy;
  * the phase ``lax.while_loop`` batches by running until the LAST
    instance converges while finished instances freeze (jax's while-loop
    batching selects per-element between old and new state), so each
    instance's trajectory is exactly its solo trajectory;
  * total wall time ~= slowest instance + one dispatch set, instead of
    sum over instances.

Instances whose paths diverge from the common case (suspected
infeasibility -> HSD, numerical failures) fall back to solo solves —
correctness first, the batch fast-path covers the well-posed majority.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.solver import algo, dimacs, fused
from hdsdp_tpu.solver.params import Params
from hdsdp_tpu.solver.solver import HDSDPSolver, Result


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _index(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


# (corrector_a, max_iter, allow_reset) / (corrector_b, max_iter) -> program
_BATCH_CACHE: dict = {}


def solve_batch(
    probs: Sequence[SDPProblem], **param_overrides
) -> List[Result]:
    """Solve N structurally-identical instances in one batched program.

    Requirements: every instance must produce the same bucketed cone
    shapes (same m, same block layout — e.g. one generator at one size
    with different data).  Instances that leave the common Phase A -> B
    path (HSD fallback, numerical failure, non-optimal Phase B exits)
    are re-solved solo and their solo Result returned.
    """
    t0 = time.time()
    if not probs:
        return []

    param_overrides.setdefault("verbose", False)
    ipms = []
    for prob in probs:
        params = Params(**param_overrides)
        ipms.append(algo.DualIPM(prob, params))
    p0 = ipms[0].params

    shapes = [
        tuple((ga.F.shape, ga.Ad.shape, ga.C.shape,
               None if ga.Fs is None else ga.Fs.shape)
              for ga in ipm.cones.groups)
        for ipm in ipms
    ]
    if any(s != shapes[0] for s in shapes) or any(
        ipm.m != ipms[0].m for ipm in ipms
    ):
        raise ValueError(
            "solve_batch needs structurally identical instances "
            "(same m and bucketed cone shapes); solve mixed shapes solo"
        )

    def solo(i: int) -> Result:
        return HDSDPSolver(probs[i], **param_overrides).optimize()

    # trace-time kernel config, shared by the batch (mirrors solve_fused)
    fused._RATIO_CFG["mode"] = p0.ratio_test
    fused._RATIO_CFG["krylov"] = p0.lanczos_dim
    fused._RATIO_CFG["kwarm"] = p0.lanczos_warm_dim

    # ---- Phase A prologue per instance (mirrors solve_fused)
    live = []
    results: List[Result] = [None] * len(probs)  # type: ignore[list-item]
    allow_resets = set()
    for i, ipm in enumerate(ipms):
        ipm.psdp = None
        ipm.which_method = "infeas"
        f = ipm.f
        allow_resets.add(not (f.many_cones or f.implied_trace or f.very_dense))
        ipm.set_start("infeas", False)
        if not ipm.check_is_interior(ipm.tau, ipm.y):
            ipm.reset_start()
            if not ipm.check_is_interior(ipm.tau, ipm.y):
                ipm.status = algo.NUMERICAL
                results[i] = solo(i)
                continue
        live.append(i)
    if len(allow_resets) != 1:
        # feature-divergent fleet: the fused program is shape-identical
        # but policy-divergent; solve everything solo
        return [results[i] or solo(i) for i in range(len(probs))]
    allow_reset = allow_resets.pop()
    if not live:
        return results

    def batched_a():
        key = ("a", shapes[0], ipms[0].m, p0.corrector_a, p0.max_iter,
               allow_reset)
        if key not in _BATCH_CACHE:
            run = fused.make_phase_a(
                p0.corrector_a, p0.max_iter, allow_reset, raw=True
            )
            _BATCH_CACHE[key] = jax.jit(jax.vmap(run), donate_argnums=(0,))
        return _BATCH_CACHE[key]

    def batched_b():
        key = ("b", shapes[0], ipms[0].m, p0.corrector_b, p0.max_iter)
        if key not in _BATCH_CACHE:
            run = fused.make_phase_b(
                p0.corrector_b, p0.max_iter, psdp_eligible=False, raw=True
            )
            _BATCH_CACHE[key] = jax.jit(jax.vmap(run), donate_argnums=(0,))
        return _BATCH_CACHE[key]

    # ---- batched Phase A
    sts = _stack([fused._state_from_ipm(ipms[i]) for i in live])
    cs = _stack([fused._cones_from_ipm(ipms[i]) for i in live])
    pas = _stack([fused._pars_from_ipm(ipms[i], "a") for i in live])
    rrd = jnp.asarray(
        [
            max(-max(ipms[i].f.obj_fro_norm, 1e02) * 1e06, -1e15)
            for i in live
        ],
        ipms[0].dtype,
    )
    sts = jax.block_until_ready(batched_a()(sts, cs, pas, rrd))

    go_b = []
    for k, i in enumerate(live):
        st_i = _index(sts, k)
        fused._sync_to_ipm(st_i, ipms[i])
        code = int(st_i.status)
        if code == fused.DUAL_FEASIBLE:
            go_b.append(i)
        else:
            # HSD fallback / numerical / maxiter: solo re-solve
            results[i] = solo(i)
    if not go_b:
        return results

    # ---- Phase B prologue per instance (mirrors solve_fused)
    for i in go_b:
        ipm = ipms[i]
        ipm.which_method = "potential"
        ipm.perturb = -10.0 * ipm.Rd
        ipm.Rd = 0.0
        if ipm.perturb != 0.0:
            ipm.check_is_interior(1.0, ipm.y)

    sts = _stack([
        fused._state_from_ipm(ipms[i])._replace(
            perturb=jnp.asarray(ipms[i].perturb, ipms[i].dtype)
        )
        for i in go_b
    ])
    cs = _stack([fused._cones_from_ipm(ipms[i]) for i in go_b])
    pbs = _stack([fused._pars_from_ipm(ipms[i], "b") for i in go_b])
    sts = jax.block_until_ready(batched_b()(sts, cs, pbs))

    for k, i in enumerate(go_b):
        st_i = _index(sts, k)
        ipm = ipms[i]
        fused._sync_to_ipm(st_i, ipm)
        code = int(st_i.status)
        ipm.status = fused._STATUS_MAP.get(code, algo.NUMERICAL)
        if ipm.status != algo.PRIMAL_DUAL_OPTIMAL:
            results[i] = solo(i)
            continue
        errs = dimacs.check_solution(ipm)
        results[i] = Result(
            status=ipm.status,
            p_obj=ipm.p_obj_val,
            d_obj=ipm.d_obj_val,
            gap=ipm.p_obj_val - ipm.d_obj_val,
            y=np.asarray(ipm.y),
            dimacs=errs,
            n_iters=ipm.n_iter,
            solve_time=time.time() - t0,
            stats=dict(ipm._factor_stats),
        )
    return results
