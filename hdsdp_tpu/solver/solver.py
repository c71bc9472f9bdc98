"""Top-level solver API (ref interface/hdsdp.h:108-120: HDSDPCreate /
SetCone / SetDualObjective / Optimize / GetRowDual / CheckSolution)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from hdsdp_tpu.io.sdpa import read_sdpa
from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.solver import algo, dimacs
from hdsdp_tpu.solver.params import Params


@dataclass
class Result:
    status: str
    p_obj: float
    d_obj: float
    gap: float
    y: np.ndarray
    dimacs: np.ndarray
    n_iters: int
    solve_time: float
    stats: dict = field(default_factory=dict)

    def __repr__(self):
        return (
            f"Result(status={self.status}, pObj={self.p_obj:+.10e}, "
            f"dObj={self.d_obj:+.10e}, iters={self.n_iters}, "
            f"time={self.solve_time:.2f}s)"
        )


class HDSDPSolver:
    """Drives presolve -> 3-phase IPM -> DIMACS check (ref HDSDPOptimize,
    interface/hdsdp.c:647-719)."""

    def __init__(self, prob: SDPProblem, mesh=None, **param_overrides):
        self.prob = prob
        self.params = Params(**param_overrides)
        self.mesh = mesh
        self.ipm: Optional[algo.DualIPM] = None
        self._dual_start = None

    def set_dual_start(self, y) -> None:
        """Dual warm start (ref HDSDPSetDualStart, interface/hdsdp.c:617)."""
        self._dual_start = np.asarray(y, dtype=np.float64)

    def optimize(
        self,
        d_only: bool = False,
        resume_from: Optional[str] = None,
        checkpoint_to: Optional[str] = None,
    ) -> Result:
        t0 = time.time()
        ipm = algo.DualIPM(self.prob, self.params, mesh=self.mesh)
        if self._dual_start is not None:
            import jax.numpy as jnp

            ipm.y0 = jnp.asarray(self._dual_start, ipm.dtype)
        if resume_from is not None:
            from hdsdp_tpu.utils.checkpoint import apply_checkpoint, load_checkpoint

            apply_checkpoint(ipm, load_checkpoint(resume_from))
        self.ipm = ipm
        if self.params.verbose:
            print("\nhdsdp_tpu: dual-scaling interior-point semidefinite programming solver\n")
            if self.params.model_notes:
                print(ipm.params.model_notes)

        ipm.solve(d_only=d_only)

        if checkpoint_to is not None:
            from hdsdp_tpu.utils.checkpoint import save_checkpoint

            save_checkpoint(checkpoint_to, ipm)

        errs = np.ones(6)
        if ipm.status not in (
            algo.INFEAS_OR_UNBOUNDED,
            algo.SUSPECT_INFEAS_OR_UNBOUNDED,
        ):
            errs = dimacs.check_solution(ipm)

        if self.params.verbose:
            print(
                "DIMACS error metric:\n    "
                + " ".join(f"{e:5.2e}" for e in errs)
            )
            print(f"\nSDP Status: {ipm.status}")
            print(f"  pObj {ipm.p_obj_val:+15.10e}")
            print(f"  dObj {ipm.d_obj_val:+15.10e}")
            print(f"  Time {time.time() - t0:3.1f} seconds\n")

        return Result(
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


    # -- solution extraction (ref HDSDPGetRowDual / HDSDPGetConeValues,
    #    interface/hdsdp.c) --------------------------------------------
    def get_row_dual(self) -> np.ndarray:
        if self.ipm is None:
            raise RuntimeError("call optimize() first")
        return np.asarray(self.ipm.y)

    def get_primal(self):
        """Recovered primal per ORIGINAL block (list of [n, n]) + LP x."""
        if self.ipm is None:
            raise RuntimeError("call optimize() first")
        ipm = self.ipm
        from hdsdp_tpu.solver import dimacs as dimacs_mod

        if getattr(ipm, "psdp", None) is not None and getattr(ipm.psdp, "X", None) is not None:
            X_groups, x_lp = ipm.psdp.get_primal()
        else:
            maker = (
                ipm.maker_acc if ipm.maker_acc.mu > 0.0 else ipm.maker_inacc
            )
            if maker.mu <= 0.0:
                return None
            rec = dimacs_mod.recover_primal(ipm, maker)
            if rec is None:
                return None
            X_groups, x_lp = rec
        n_blocks = len(self.prob.block_dims)
        X_by_block = [None] * n_blocks
        for grp, Xg in zip(self.prob.groups, X_groups):
            for slot, ib in enumerate(grp.block_ids):
                X_by_block[ib] = np.asarray(Xg[slot])
        return X_by_block, (np.asarray(x_lp) if x_lp is not None else None)

    def get_dual_slacks(self):
        """Dual slack S per ORIGINAL block + LP s at the final iterate."""
        if self.ipm is None:
            raise RuntimeError("call optimize() first")
        ipm = self.ipm
        S, s_lp = ipm.cones.assemble(1.0, -1.0, ipm.y, -ipm.Rd + ipm.perturb)
        n_blocks = len(self.prob.block_dims)
        S_by_block = [None] * n_blocks
        for grp, Sg in zip(self.prob.groups, S):
            for slot, ib in enumerate(grp.block_ids):
                S_by_block[ib] = np.asarray(Sg[slot])
        return S_by_block, (np.asarray(s_lp) if s_lp is not None else None)


def solve_sdpa_file(path: str, d_only: bool = False, **param_overrides) -> Result:
    data = read_sdpa(path)
    prob = SDPProblem.from_sdpa(data)
    solver = HDSDPSolver(prob, **param_overrides)
    return solver.optimize(d_only=d_only)
