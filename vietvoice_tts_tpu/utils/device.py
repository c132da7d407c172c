"""What the program runs on: JAX's devices and the card's own report.

Measurement scripts (``chip_smoke.py``, ``bench.py``) print this beside every
result, and refuse to run anywhere but on a GPU: a number taken on the CPU is
never reported as a device number.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def jax_device() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_name_and_power_limit() -> str:
    """The cards' names and power limits, one line per card, as
    ``nvidia-smi`` reports them. A card below its maximum limit runs slower
    under load, so this goes beside every timing."""
    out = subprocess.run(
        NVIDIA_SMI_QUERY, capture_output=True, text=True, check=True, timeout=60
    )
    return out.stdout.strip()


def require_gpu() -> dict:
    """JAX's device report; raises when the first device is not a GPU."""
    device = jax_device()
    if device["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {device['platform']} "
            f"({device['kind']}); this script measures the GPU only"
        )
    return device
