"""What the solver runs on: the JAX device and, on a GPU, the card."""

from __future__ import annotations

import subprocess


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, one per line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def describe() -> dict:
    """platform, device_kind and count of JAX's devices."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> dict:
    """describe(), or SystemExit(2) when JAX's first device is no GPU:
    a measurement never falls back to another device."""
    dev = describe()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev['platform']} "
            f"({dev['kind']}); refusing to run"
        )
    return dev
