"""What the solver derives from the machine: matmul precision, the
memory-based choice of driver and Schur mode, the compile-cache
directory, and the refusal of the GPU entry points to run elsewhere."""

import json
import os
import subprocess
import sys

import jax
import pytest

import hdsdp_tpu  # noqa: F401  (pins the matmul precision)
from hdsdp_tpu.solver import memory
from hdsdp_tpu.solver.params import Params
from hdsdp_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_matmul_precision_is_highest():
    assert jax.config.jax_default_matmul_precision == "highest"


# JAX's default reservation of an 80 GB card (three quarters), and of a
# 16 GB one
H100 = 0.75 * 80e9
SMALL = 0.75 * 16e9


@pytest.mark.parametrize(
    "shape,mem,want",
    [
        # maxG51: m = n = 1000
        ((1000, 1000, 1000), H100, ("iter", "direct")),
        ((1000, 1000, 1000), SMALL, ("iter", "direct")),
        # maxG55: m = n = 5000
        ((5000, 5000, 5000), H100, ("iter", "direct")),
        ((5000, 5000, 5000), SMALL, ("iter", "direct")),
        ((5000, 5000, 5000), 4e9, ("host", "cg")),
        ((5000, 5000, 5000), 0.5e9, ("host", "free")),
        # torus22: m = n = 10648
        ((10648, 10648, 10648), H100, ("iter", "direct")),
        ((10648, 10648, 10648), SMALL, ("host", "cg")),
        # small shapes run whole-phase programs
        ((100, 100, 100), SMALL, ("phase", "direct")),
    ],
)
def test_plan_from_injected_memory(shape, mem, want):
    assert memory.plan(*shape, Params(), mem=mem) == want


def test_plan_respects_explicit_settings():
    assert memory.plan(1000, 1000, 1000, Params(fused=False),
                       mem=H100) == ("host", "direct")
    assert memory.plan(1000, 1000, 1000, Params(kkt_mode="free"),
                       mem=H100) == ("host", "free")
    assert memory.plan(100, 100, 100, Params(fused="iter"),
                       mem=H100) == ("iter", "direct")


@pytest.mark.parametrize(
    "shape,params,want",
    [
        # the "auto" driver on a mesh is the host loop
        ((1000, 1000, 1000), Params(), ("host", "direct")),
        ((5000, 5000, 5000), Params(), ("host", "cg")),
        # auto operator mode never engages on a mesh; an explicit one does
        ((20001, 100, 100), Params(), ("host", "cg")),
        ((1000, 1000, 1000), Params(kkt_mode="free"), ("host", "free")),
        # an explicit fused driver is kept
        ((1000, 1000, 1000), Params(fused="iter"), ("iter", "direct")),
    ],
)
def test_plan_on_a_mesh(shape, params, want):
    assert memory.plan(*shape, params, mem=16e9, mesh=True) == want


@pytest.mark.parametrize(
    "overrides,want",
    [
        ({"fused": False}, ("host", "direct")),
        ({"fused": False, "kkt_solver": "cg"}, ("host", "cg")),
        ({"kkt_mode": "free"}, ("host", "free")),
        ({}, ("phase", "direct")),
    ],
)
def test_dual_ipm_runs_the_plan_it_was_given(overrides, want):
    """DualIPM takes driver and Schur mode from memory.plan once, and its
    Schur backend follows that plan."""
    from hdsdp_tpu.models.problem import SDPProblem
    from hdsdp_tpu.models.synthetic import random_sdpa
    from hdsdp_tpu.solver.algo import DualIPM

    prob = SDPProblem.from_sdpa(random_sdpa(m=20, block_dims=[10], seed=8))
    params = Params(verbose=False, **overrides)
    ipm = DualIPM(prob, params)
    assert ipm.plan() == want
    assert ipm.plan() == memory.plan(20, 10, 10, params)
    assert ipm.kkt_free == (want[1] == "free")


def test_memory_shares_reproduce_the_sixteen_gigabyte_sizes():
    """The shares were chosen so that a 16 GB device gets the sizes that
    were tuned on one: operator mode above m = 20000, materialization up
    to m ~ 32k, iter-fused state up to 12 GB."""
    assert not memory.kkt_free(20000, 16e9)
    assert memory.kkt_free(20001, 16e9)
    assert 31000 < memory.dense_m_cap(16e9) < 33000
    assert memory.ITER_STATE_SHARE * 16e9 == 12e9


def test_device_memory_from_stats_or_host(monkeypatch):
    # the CPU backend reports no bytes_limit: the host's memory is used
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert memory.device_memory_bytes() == float(host)

    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 12345}

    monkeypatch.setattr(jax, "local_devices", lambda: [Dev()])
    assert memory.device_memory_bytes() == 12345.0


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = cache.cache_dir()
    assert first == cache.cache_dir()
    assert first == os.path.join(REPO, ".jax_cache")


def _run(args, **env):
    e = {k: v for k, v in os.environ.items()
         if k != "JAX_COMPILATION_CACHE_DIR"}
    e.update(JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, cwd=REPO, env=e, timeout=300)


def test_enable_compile_cache_sets_jax_config(tmp_path):
    code = ("import jax; from hdsdp_tpu.utils.cache import "
            "enable_compile_cache as f; p = f(); "
            "print(p, jax.config.jax_compilation_cache_dir)")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr[-1000:]
    path, configured = out.stdout.split()
    assert path == configured == os.path.join(REPO, ".jax_cache")
    out = _run(["-c", code], JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert out.returncode == 0, out.stderr[-1000:]
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_chip_smoke_refuses_cpu():
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not a GPU" in out.stderr


def test_bench_case_refuses_cpu():
    out = _run(["bench.py", "--case", "maxG51"])
    assert out.returncode != 0
    assert not any(ln.startswith("{") for ln in out.stdout.splitlines())
    assert "no GPU" in out.stderr


def test_bench_reports_cpu_case_as_failed():
    """The parent prints a FAILED line with no time, and exits 1."""
    out = _run(["bench.py", "maxG51"])
    assert out.returncode == 1
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "maxG51_warm_solve_s_FAILED"
    assert line["value"] is None
