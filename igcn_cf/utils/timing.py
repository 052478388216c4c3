"""Device timing by the host clock around ``block_until_ready``.

JAX returns from a dispatch before the device finishes, so a timing that
does not end in ``block_until_ready`` measures the enqueue. On the GPU
``block_until_ready`` waits for the device, so the time between a call and
its readiness is the device time plus one dispatch.
"""

from __future__ import annotations

import time
from typing import Callable

import jax


def device_ms(fn: Callable, *args, warmup: int = 2, reps: int = 10) -> float:
    """Median ms per call of ``fn(*args)``, compile and warm-up excluded.
    Pass device arrays as ``args``: a closed-over array becomes a constant
    of the compiled program."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e3
