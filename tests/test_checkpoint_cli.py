"""Checkpoint/resume, dual warm start, and the CLI driver."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import instances
from hdsdp_tpu.models.problem import SDPProblem
from hdsdp_tpu.models.synthetic import random_sdpa
from hdsdp_tpu.solver.solver import HDSDPSolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def prob():
    return SDPProblem.from_sdpa(random_sdpa(m=20, block_dims=[10], seed=6))


def test_checkpoint_roundtrip(tmp_path, prob):
    ck = str(tmp_path / "state.npz")
    s1 = HDSDPSolver(prob, verbose=False)
    r1 = s1.optimize(checkpoint_to=ck)
    assert r1.status == "PRIMAL_DUAL_OPTIMAL"

    s2 = HDSDPSolver(prob, verbose=False)
    r2 = s2.optimize(resume_from=ck)
    assert r2.status == "PRIMAL_DUAL_OPTIMAL"
    assert r2.d_obj == pytest.approx(r1.d_obj, rel=1e-8)
    # warm-started solve should not need more iterations
    assert r2.n_iters <= r1.n_iters + 2


def test_dual_start(prob):
    s1 = HDSDPSolver(prob, verbose=False)
    r1 = s1.optimize()
    s2 = HDSDPSolver(prob, verbose=False)
    s2.set_dual_start(np.asarray(r1.y))
    r2 = s2.optimize()
    assert r2.status == "PRIMAL_DUAL_OPTIMAL"


def test_checkpoint_mismatch_rejected(tmp_path, prob):
    ck = str(tmp_path / "state.npz")
    HDSDPSolver(prob, verbose=False).optimize(checkpoint_to=ck)
    other = SDPProblem.from_sdpa(random_sdpa(m=12, block_dims=[6], seed=1))
    with pytest.raises(ValueError):
        HDSDPSolver(other, verbose=False).optimize(resume_from=ck)


def _cli(path):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    for k in ("HOME", "TMPDIR"):
        if k in os.environ:
            env[k] = os.environ[k]
    out = subprocess.run(
        [sys.executable, "-m", "hdsdp_tpu", path, "--quiet", "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=560, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cli_sdpa():
    summary = _cli(instances.path("theta_petersen.dat-s"))
    assert summary["status"] == "PRIMAL_DUAL_OPTIMAL"
    assert summary["dObj"] == pytest.approx(-4.0, rel=1e-6)


def test_cli_mps():
    summary = _cli(instances.path("lp_small.mps"))
    assert summary["status"] == "PRIMAL_DUAL_OPTIMAL"
    assert summary["pObj"] == pytest.approx(
        instances.lp_golden("lp_small.mps"), rel=1e-6)
