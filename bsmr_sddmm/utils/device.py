"""What a result ran on: JAX's device and, on a GPU, the card's name and
power limit (a card set below its maximum power runs slower under load,
so a number without its limit cannot be compared with another)."""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def gpu_name_power() -> str:
    """``nvidia-smi``'s name and power limit of the card(s), one line per
    card, read in a child process that never imports JAX."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip()


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` of ``jax.devices()``, plus
    ``"gpu"`` (name and power limit) when the platform is a GPU."""
    import jax

    devices = jax.devices()
    rec = {"platform": devices[0].platform,
           "kind": devices[0].device_kind,
           "count": len(devices)}
    if rec["platform"] == "gpu":
        rec["gpu"] = gpu_name_power()
    return rec
