"""Memory-based choices of the IPM driver and the Schur-system mode.

Every gate here is a fraction of the memory the solver can allocate: the
first local device's ``memory_stats()["bytes_limit"]``, or the host's
physical memory where the backend reports none (the CPU).  No device
size is assumed.

  * driver: "phase" (whole-phase fused while-loops) for small shapes,
    "iter" (iteration-fused) while its resident state fits, else the
    host loop;
  * schur: "direct" dense Cholesky, "cg" (AdaptiveCG on a dense M, host
    loop at m >= Params.kkt_cg_threshold) or "free" (matrix-free
    operator, where a dense M would crowd the device: the analogue of
    the reference's sparse-Schur storage decision, hdsdp_schur.c:60,227,
    there by pattern density, here by absolute size).  On a row-sharded
    mesh "direct" is the distributed Cholesky and "cg" row-sharded CG.
"""

from __future__ import annotations

import math
import os
from typing import Optional

# the iter-fused program keeps ~16 f64 copies of the m x m Schur system
# plus the [n_max, sum n_b] cone buffers resident (double-buffered
# while-loop state + XLA temps); it may take this share of the memory
ITER_STATE_SHARE = 0.75
# matrix-free Schur operator once one dense f64 M would take this share
FREE_SHARE = 0.2
# one dense f64 M may be materialized up to this share (the rest holds
# its factor workspace and the cone buffers): the operator mode's direct
# escalation and chunk-built f32 Cholesky preconditioner, and PSDP's
# factor-once KKT
DENSE_SHARE = 0.5


def device_memory_bytes() -> float:
    """Bytes the solver can allocate on the first local device."""
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit:
        return float(limit)
    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def iter_state_bytes(m: int, n_max: int, n_sum: int) -> float:
    """Estimated resident bytes of the iteration-fused program."""
    return 8.0 * 16.0 * (float(m) ** 2 + float(n_max) * float(n_sum))


def dense_m_cap(mem: Optional[float] = None) -> int:
    """Largest m whose dense f64 M takes at most DENSE_SHARE."""
    mem = device_memory_bytes() if mem is None else mem
    return int(math.sqrt(DENSE_SHARE * mem / 8.0))


def kkt_free(m: int, mem: Optional[float] = None) -> bool:
    """True where one dense f64 m x m Schur matrix would crowd memory."""
    mem = device_memory_bytes() if mem is None else mem
    return 8.0 * float(m) ** 2 > FREE_SHARE * mem


def plan(m: int, n_max: int, n_sum: int, params,
         mem: Optional[float] = None, mesh: bool = False):
    """(driver, schur) that ``params`` give a problem with m rows and SDP
    blocks of largest dimension n_max and total dimension n_sum, given
    ``mem`` bytes.  This is the one place the choice is made: DualIPM
    runs the plan it gets from here.

    On a mesh (``mesh``) the "auto" driver is the host loop, since the
    fused programs use the single-device kernels and the mesh wants the
    sharded assembly, and operator mode engages only when asked for: the
    mesh row-shards a materialized M (explicit ``kkt_mode="free"``
    composes with it through the sharded operator matvec)."""
    mem = device_memory_bytes() if mem is None else mem
    free = params.kkt_mode == "free" or (
        params.kkt_mode == "auto" and not mesh and kkt_free(m, mem)
    )
    driver = params.fused
    if driver == "auto" and mesh:
        driver = "host"
    elif driver == "auto":
        if m <= params.fused_max_m and n_max <= params.fused_max_n:
            driver = "phase"
        elif iter_state_bytes(m, n_max, n_sum) <= ITER_STATE_SHARE * mem:
            driver = "iter"
        else:
            driver = "host"
    elif driver is True:
        driver = "phase"
    elif driver is False:
        driver = "host"
    if free:
        # the fused programs materialize M: operator mode is host-only
        return "host", "free"
    if driver != "host":
        return driver, "direct"
    cg = params.kkt_solver == "cg" or (
        params.kkt_solver == "auto" and m >= params.kkt_cg_threshold
    )
    return "host", "cg" if cg else "direct"
