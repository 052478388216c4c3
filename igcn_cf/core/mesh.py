"""Device mesh & sharding runtime.

The reference is single-process single-GPU (SURVEY.md §2.2). Here we define the
multi-device substrate the engine scales on: a 2-D logical mesh with

  * ``data``  — batch-parallel axis (BPR/BCE triples, VAE user rows)
  * ``table`` — node/catalog axis: rows of the (n_users+n_items, d) embedding
    tables, node representations and the item axis of score matrices are
    sharded here; the SpMM and top-k ride XLA collectives over it.

Fabric: the four GPUs of one host are joined all to all by NVLink, so every
card reaches every other at the same rate and the mesh follows the
algorithm alone: the heavy collectives (per-step all-gathers of node
representations, reduce-scatters of table gradients) run over ``table``.
Across hosts the ``table`` axis stays within a host and ``data`` spans the
processes, since ``data`` only moves scalar loss means and small batch
shards.

On one device everything degrades to a (1, 1) mesh and shardings become
no-ops. Tests force an 8-device CPU mesh via
``XLA_FLAGS=--xla_force_host_platform_device_count=8``; ``python
chip_smoke.py --four`` runs the sharded path on four cards.

Multi-process launch recipe (one process per host, all hosts run the same
program)::

    from igcn_cf.core.mesh import initialize_distributed, make_mesh
    initialize_distributed()          # no-op when single-process
    mesh = make_mesh()                # data=process_count, table=local cards

``jax.distributed.initialize`` needs the coordinator address, the process
count and this process's id: pass them, or set ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` (read here as a fallback).
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
TABLE_AXIS = "table"

_DISTRIBUTED_INITIALIZED = False


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up the multi-process JAX runtime (no-op when single-process).

    Call once at program start on every host, before any other JAX call.
    The arguments come from ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` or are passed explicitly. The reference has no
    distributed substrate at all (SURVEY.md §2.2) — this is new capability.
    """
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        # single-process run: nothing to initialize; jax.process_count()
        # stays 1
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _DISTRIBUTED_INITIALIZED = True


def make_mesh(
    devices: Sequence[jax.Device] | None = None,
    data: int | None = None,
    table: int | None = None,
) -> Mesh:
    """Build a ('data', 'table') mesh over the available devices.

    Single-process (the common case here): if axis sizes are not given, puts
    everything on the table axis (catalog size, not batch size, is the scale
    axis of this workload — SURVEY.md §5).

    Multi-process: defaults to ``data = process_count`` across hosts and
    ``table = local_device_count`` within each host, and lays the device
    array out so each mesh row is one process's devices — table-axis
    collectives (rep all-gather, grad reduce-scatter) never leave a host.
    Explicit ``data``/``table`` overrides are honored as long as a table
    group never straddles a host boundary: ``table`` must divide
    ``local_device_count`` (several groups per host) or be a whole multiple
    of it (each group spans whole hosts — heavy collectives then cross the
    host network, allowed only as that explicit choice); anything else
    raises.
    """
    n_proc = jax.process_count()
    if devices is None and n_proc > 1:
        local = jax.local_device_count()
        if data is None and table is None:
            data, table = n_proc, local
        elif table is None:
            table = (n_proc * local) // data
        elif data is None:
            data = (n_proc * local) // table
        if data * table != n_proc * local:
            raise ValueError(
                f"mesh {data}x{table} != {n_proc * local} devices"
            )
        # validate the docstring's promise instead of silently building a
        # mesh whose table groups straddle hosts:
        # with process-major ordering a table group stays inside one host iff
        # local % table == 0 (several groups per host) or table % local == 0
        # (each group is a whole number of hosts — heavy collectives then
        # cross hosts, allowed only as an explicit whole-host-multiple choice).
        if local % table != 0 and table % local != 0:
            raise ValueError(
                f"table={table} straddles host boundaries "
                f"(local_device_count={local}): pick table dividing {local} "
                f"(host-local collectives) or a multiple of it"
            )
        # order devices process-major so reshape(data, table) keeps each
        # table group inside one process when table <= local
        devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
        arr = np.asarray(devs).reshape(data, table)
        return Mesh(arr, (DATA_AXIS, TABLE_AXIS))

    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data is None and table is None:
        data, table = 1, n
    elif data is None:
        data = n // table
    elif table is None:
        table = n // data
    if data * table != n:
        raise ValueError(f"mesh {data}x{table} != {n} devices")
    arr = np.asarray(devices).reshape(data, table)
    return Mesh(arr, (DATA_AXIS, TABLE_AXIS))


def table_sharding(mesh: Mesh) -> NamedSharding:
    """Rows sharded across the table axis (embedding tables, node reps)."""
    return NamedSharding(mesh, P(TABLE_AXIS, None))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis sharded across the data axis (batches)."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)


def reshard(x, sharding: NamedSharding):
    """Reshard a global array (or put a host array) onto ``sharding``,
    multi-host-safe.

    For a ``jax.Array`` this compiles an identity with ``out_shardings`` — a
    collective reshard that works even when the source shards live on
    non-addressable devices (``jax.device_put`` host pulls do not). Host
    numpy input (identical on every process, e.g. data built from the
    dataset) goes through ``device_put``.
    """
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        return jax.jit(lambda a: a, out_shardings=sharding)(x)
    return jax.device_put(x, sharding)


def to_host_replicated(x, mesh: Mesh) -> np.ndarray:
    """Gather a (possibly multi-host) sharded array to host numpy.

    ``np.asarray`` on a sharded array requires every shard to be addressable
    — true only single-process. This first reshards to fully-replicated (an
    all-gather riding the mesh fabric), after which each process holds the
    whole array locally. Used by checkpointing (parallel/trainer.py) so
    save/eval survive ``jax.process_count() > 1``.
    """
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        x = reshard(x, replicated(mesh))
    return np.asarray(x)
