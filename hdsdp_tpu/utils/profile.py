"""Tracing / profiling utilities.

Equivalent of the reference's macro-based profiling
(ref interface/hdsdp_utils.h:55-70 HDSDP_PROFILER /
HDSDP_CODE_PROFILER_START/END, and the per-backend counters of
linalg/hdsdp_linsolver.c):

  * ``timed`` / ``Region``  — wall-clock region timers with named
    accumulators (the HDSDP_CODE_PROFILER analogue);
  * ``profile_fn``          — repeat-and-time a callable (HDSDP_PROFILER);
  * ``trace``               — context manager around ``jax.profiler.trace``
    producing a TensorBoard-loadable device trace;
  * ``PhaseStats``          — per-phase counters incl. the factor:solve
    time ratio the reference uses as a policy input
    (ref def_hdsdp_lpkkt.h:42-46, hdsdp_lpsolve.c:501-503).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict

import jax


class Region:
    """Named wall-clock accumulators."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.total[name] += time.time() - t0
            self.count[name] += 1

    def report(self) -> str:
        rows = sorted(self.total.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{k:30s} {v:10.3f}s  x{self.count[k]}" for k, v in rows
        )


def profile_fn(fn: Callable, *args, n: int = 10, block: bool = True):
    """Repeat-and-time (ref HDSDP_PROFILER): returns seconds per call."""
    out = fn(*args)
    if block:
        jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(n):
        out = fn(*args)
    if block:
        jax.block_until_ready(out)
    return (time.time() - t0) / n


@contextlib.contextmanager
def trace(log_dir: str):
    """Device trace for TensorBoard (wraps jax.profiler.trace)."""
    with jax.profiler.trace(log_dir):
        yield


@dataclass
class PhaseStats:
    """Per-phase counters; factor:solve ratio is a policy signal."""

    assemble_s: float = 0.0
    factor_s: float = 0.0
    solve_s: float = 0.0
    n_assemble: int = 0
    n_factor: int = 0
    n_solve: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def factor_solve_ratio(self) -> float:
        if self.solve_s <= 0:
            return float("inf")
        return self.factor_s / self.solve_s
