"""Which engine and which kernel run on which platform: the one place that
decides.

Three questions, answered from the platform and from what the code can
observe (catalog size, the device's memory limit):

  * which graph engine ``graph_backend='auto'`` means (``graph_engine``);
  * whether the propagation cache is on, and whether its measured A/B runs
    (``use_pcache``, ``pcache_ab``, ``use_sharded_pcache``);
  * which kernel serves the cached gather+matmul (``pcache_kernel``).

``cpu`` answers with the plain references the tests use. ``gpu`` answers with
rules backed by measurements on an H100 (KERNEL_FINDINGS.md):

  * ``auto`` is the sparse segment-sum engine. The bit-packed dense engine
    runs as plain XLA on the GPU and does ~1,400x the useful FLOPs of the
    sparse engine at Gowalla density (0.07%); it stays reachable only by
    asking for ``graph_backend='dense'``.
  * the propagation cache is on whenever P fits the device's memory budget,
    and the model init confirms it with the measured A/B
    (kernels/pcache.py::ab_select).
  * the cached gather+matmul runs the Pallas kernel through Triton.

Any other platform raises: nothing here silently falls back to interpret
mode or to a reference on an accelerator.
"""

from __future__ import annotations

import jax

SUPPORTED = ("cpu", "gpu")

GIB = 1024**3

# Device memory kept free beside the budgeted structure: graphs, parameters,
# optimizer state, eval score blocks, build transients and XLA's workspace.
_RESERVE_FRACTION = 0.2
_RESERVE_MIN = 8 * GIB


def platform() -> str:
    """'cpu' or 'gpu'; any other backend is an error."""
    p = jax.default_backend()
    if p not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: this program runs on {SUPPORTED}"
        )
    return p


def device_memory_bytes() -> int | None:
    """The first device's allocatable memory (``bytes_limit``), or None
    where the backend reports no limit (the CPU)."""
    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"])


def memory_budget_bytes() -> int | None:
    """Bytes one large structure (the propagation cache, an unpacked
    interaction matrix) may take: the memory limit less a reserve of 20%
    (at least 8 GiB). None where the device reports no limit."""
    limit = device_memory_bytes()
    if limit is None:
        return None
    return max(0, limit - max(_RESERVE_MIN, int(limit * _RESERVE_FRACTION)))


def fits(nbytes: int) -> bool:
    budget = memory_budget_bytes()
    return budget is None or nbytes <= budget


# -- graph engine ---------------------------------------------------------------


def graph_engine(n_users: int, n_items: int, requested: str = "auto") -> str:
    """'sparse' or 'dense' for a catalog. 'auto' is the sparse engine on
    both platforms (module docstring). An explicit 'dense' on the GPU must
    fit the memory budget: its XLA path unpacks the interaction matrix to a
    dense float32 matrix per pass. 'dense_lean' is an old alias of
    'dense'."""
    from igcn_cf.kernels.dense_graph import dense_unpacked_bytes

    if requested == "dense_lean":
        requested = "dense"
    if requested not in ("auto", "dense", "sparse"):
        raise ValueError(f"unknown graph backend {requested!r}")
    if requested == "auto":
        platform()
        return "sparse"
    if requested == "dense" and platform() == "gpu":
        need = dense_unpacked_bytes(n_users, n_items)
        if not fits(need):
            raise ValueError(
                f"graph_backend='dense' needs {need / GIB:.1f} GiB for the "
                f"unpacked interaction matrix (budget "
                f"{memory_budget_bytes() / GIB:.1f} GiB); use 'sparse'"
            )
    return requested


# -- propagation cache ----------------------------------------------------------


def use_pcache(n_users: int, n_items: int, n_layers: int,
               requested="auto") -> bool:
    """Whether a model trains through the propagation cache. 'auto': on the
    GPU when P fits the memory budget (the model init then confirms it with
    the measured A/B); off on the CPU. True forces it (tests build tiny
    caches on the CPU); over budget on the GPU it raises instead of running
    out of memory mid-build. False disables."""
    from igcn_cf.kernels.pcache import pcache_bytes

    if requested not in (True, False, "auto"):
        raise ValueError(f"unknown prop_cache setting {requested!r}")
    if requested is False or n_layers < 1:
        return False
    need = pcache_bytes(n_users, n_items)
    if requested is True:
        if platform() == "gpu" and not fits(need):
            raise ValueError(
                f"prop_cache=True but P would be {need / GIB:.1f} GiB "
                f"(budget {memory_budget_bytes() / GIB:.1f} GiB): too large "
                f"for device memory; use prop_cache='auto' or False"
            )
        return True
    return platform() == "gpu" and fits(need)


def pcache_ab() -> bool:
    """Whether 'auto' confirms the cache with the measured engine A/B. Only
    a device time decides; the CPU never runs 'auto' into the cache."""
    return platform() == "gpu"


def use_sharded_pcache(n_users: int, n_items: int, n_shards: int,
                       requested="auto") -> bool:
    """The sharded cache: forced by True or 'host' (the scipy host build);
    'auto' is off on both platforms. The sharded step has not been measured
    against the sharded recompute step on four cards, so nothing turns it
    on unasked."""
    from igcn_cf.parallel.pcache import sharded_pcache_bytes_per_chip

    if requested not in (True, False, "auto", "host"):
        raise ValueError(f"unknown prop_cache setting {requested!r}")
    if requested in (True, "host"):
        need = sharded_pcache_bytes_per_chip(n_users, n_items, n_shards)
        if platform() == "gpu" and not fits(need):
            raise ValueError(
                f"sharded prop_cache needs {need / GIB:.1f} GiB per device "
                f"(budget {memory_budget_bytes() / GIB:.1f} GiB)"
            )
        return True
    platform()
    return False


def pcache_kernel() -> str:
    """Which implementation serves the cached gather+matmul: 'triton' (the
    Pallas kernel, kernels/pcache.py) on the GPU, 'xla' (gather, then dot:
    the plain reference) on the CPU."""
    return "triton" if platform() == "gpu" else "xla"
