"""What the program runs on: the JAX device and, on the GPU, the card's
name and power limit as ``nvidia-smi`` reports them."""

from __future__ import annotations

import shutil
import subprocess

import jax


def device_record() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def card_line() -> str:
    """``name, power.limit`` of the first card, or 'not available'."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not available"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "not available"


def peak_memory_bytes(device=None) -> int | None:
    stats = (device or jax.devices()[0]).memory_stats()
    return None if not stats else int(stats.get("peak_bytes_in_use", 0))
