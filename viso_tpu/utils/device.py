"""What the program runs on: the JAX device and the card behind it."""

from __future__ import annotations

import subprocess


def require_gpu(dev):
    """Return `dev` if it is a GPU; raise otherwise (no CPU fallback)."""
    if dev.platform != "gpu":
        raise RuntimeError(
            f"expected a GPU device, JAX gave {dev.platform!r} "
            f"({dev.device_kind}); a device measurement cannot run here"
        )
    return dev


def nvidia_smi_name_power() -> str:
    """`name, power.limit` of each card as nvidia-smi reports them.

    Runs in a child process that never imports JAX, so it holds no
    device memory.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(
        line.strip() for line in out.stdout.splitlines() if line.strip()
    )


def describe(devices) -> dict:
    """Platform, device kind, device count and (on a GPU) power limit."""
    d0 = devices[0]
    rec = {
        "platform": d0.platform,
        "kind": d0.device_kind,
        "count": len(devices),
    }
    if d0.platform == "gpu":
        rec["card"] = nvidia_smi_name_power()
    return rec
