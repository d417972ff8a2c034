"""The accelerator a measurement runs on.

Every number a benchmark prints names its device: JAX's platform, device
kind and device count, plus the card's name and power limit as
`nvidia-smi` reports them (a card set below its maximum power runs slower
under load).  A measurement path that finds no GPU fails; it never falls
back to the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Sequence


def require_gpu(devices: Sequence) -> None:
    """Raise unless JAX's first device is a GPU."""
    if not devices:
        raise RuntimeError("JAX found no devices")
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU; JAX's first device is {d.platform!r} "
            f"({d.device_kind})"
        )


def describe(devices: Sequence) -> dict:
    """{"platform", "kind", "count"} as JAX reports them."""
    d = devices[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    one line per card."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip()
