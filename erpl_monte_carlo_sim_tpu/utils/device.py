"""What a measurement runs on: JAX's view of the device plus the card's
name and power limit as ``nvidia-smi`` reports them.

A card may be set below its maximum power limit and then runs slower
under load, so every recorded number carries the limit beside it.
"""

from __future__ import annotations

import shutil
import subprocess

__all__ = ["card_info", "device_info"]


def card_info() -> str | None:
    """``name, power.limit`` of each GPU (one line per card, joined by
    ``"; "``), or None where ``nvidia-smi`` is absent. Runs as a child
    process, never through JAX."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def device_info() -> dict:
    """JAX's first device as ``{"platform", "kind", "count"}``."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
