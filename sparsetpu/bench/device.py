"""What a measurement ran on: the JAX device and the card's own report."""

from __future__ import annotations

import subprocess


def card_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` as the card reports it,
    read by a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu() -> dict:
    """The JAX device as {platform, kind, count}; raises SystemExit when
    JAX finds no GPU, so no number is ever reported for another device."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"needs a GPU; JAX found {devs[0].platform} ({devs[0].device_kind})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
