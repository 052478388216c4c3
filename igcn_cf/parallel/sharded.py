"""Multi-chip execution: row-sharded embedding tables + sharded SpMM.

New capability over the reference (which is single-process single-GPU,
SURVEY.md §2.2), following BASELINE.json's north star: embedding tables and
node representations row-sharded across the ``table`` mesh axis, graph
propagation as a shard-local SpMM over destination-row blocks with an
all-gather of the dense operand over the device interconnect, BPR loss data-parallel over the
``data`` axis, and gradients flowing back through the same collectives
(all-gather transposes to reduce-scatter under AD).

Layout
------
Rows (nodes / templates) are padded to a multiple of the table-axis size and
partitioned into contiguous blocks, one per shard. Edges are partitioned by
destination row block and padded to the max per-shard nnz, giving every shard
an identical static shape:

    rows_local (T, E_max) — destination row ids local to the shard block
    cols       (T, E_max) — GLOBAL source column ids
    vals       (T, E_max) — edge weights (0 on padding)

``sharded_spmm`` then computes, per shard t:

    Y[t] = segment_sum(vals[t] * X_full[cols[t]], rows_local[t])

where X_full is all-gathered along ``table``. For d=64 catalogs this gather
is a few MB per layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from igcn_cf.core.mesh import TABLE_AXIS
from igcn_cf.graph.build import COO


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rows_local", "cols", "vals"],
    meta_fields=["n_rows", "n_cols", "rows_per_shard", "n_shards"],
)
@dataclass(frozen=True)
class ShardedGraph:
    """Edges partitioned by destination-row block; leading axis = shard."""

    rows_local: jnp.ndarray  # (T, E_max) int32
    cols: jnp.ndarray  # (T, E_max) int32 (global)
    vals: jnp.ndarray  # (T, E_max) float32
    n_rows: int  # padded to T * rows_per_shard
    n_cols: int
    rows_per_shard: int
    n_shards: int

    @staticmethod
    def from_coo(coo: COO, n_shards: int, pad_rows_to: int = 8) -> "ShardedGraph":
        n_rows_padded = -(-coo.shape[0] // (n_shards * pad_rows_to)) * (
            n_shards * pad_rows_to
        )
        rows_per_shard = n_rows_padded // n_shards
        shard_of = coo.rows // rows_per_shard
        counts = np.bincount(shard_of, minlength=n_shards)
        e_max = max(8, int(counts.max()))
        e_max = -(-e_max // 8) * 8
        rows_local = np.zeros((n_shards, e_max), dtype=np.int32)
        cols = np.zeros((n_shards, e_max), dtype=np.int32)
        vals = np.zeros((n_shards, e_max), dtype=np.float32)
        for t in range(n_shards):
            sel = shard_of == t
            k = int(sel.sum())
            rows_local[t, :k] = coo.rows[sel] - t * rows_per_shard
            cols[t, :k] = coo.cols[sel]
            vals[t, :k] = coo.vals[sel]
            # padding points at the shard's last row with zero weight
            rows_local[t, k:] = rows_per_shard - 1
        return ShardedGraph(
            rows_local=jnp.asarray(rows_local),
            cols=jnp.asarray(cols),
            vals=jnp.asarray(vals),
            n_rows=n_rows_padded,
            n_cols=int(coo.shape[1]),
            rows_per_shard=rows_per_shard,
            n_shards=n_shards,
        )


def pad_rows(x: np.ndarray, n_rows_padded: int) -> np.ndarray:
    """Zero-pad a host array's leading axis to the sharded row count."""
    if x.shape[0] == n_rows_padded:
        return x
    pad = np.zeros((n_rows_padded - x.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad], axis=0)


# -- shard-local kernels (run inside shard_map; x_shard is this device's
#    row block, graph leaves are this device's edge partition) --------------


def spmm_local(
    rows_local: jnp.ndarray,
    cols: jnp.ndarray,
    vals: jnp.ndarray,
    rows_per_shard: int,
    x_shard: jnp.ndarray,
    axis_name: str = TABLE_AXIS,
) -> jnp.ndarray:
    """One sharded SpMM step: all-gather the dense operand along the table
    axis, gather this shard's source rows, segment-sum into the local row
    block. Under AD the all-gather transposes to a reduce-scatter of the
    cotangent — the "table gradients flow back through the same collectives"
    path."""
    # inside shard_map each device sees its (1, E_max) slice of the edge
    # partition — flatten the shard axis away
    rows_local = rows_local.reshape(-1)
    cols = cols.reshape(-1)
    vals = vals.reshape(-1)
    x_full = jax.lax.all_gather(x_shard, axis_name, axis=0, tiled=True)
    gathered = jnp.take(x_full, cols, axis=0) * vals[:, None]
    return jax.ops.segment_sum(gathered, rows_local, num_segments=rows_per_shard)


def propagate_mean_local(
    graph_leaves: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
    rows_per_shard: int,
    x0_shard: jnp.ndarray,
    n_layers: int,
    axis_name: str = TABLE_AXIS,
) -> jnp.ndarray:
    rows_local, cols, vals = graph_leaves
    acc = x0_shard
    x = x0_shard
    for _ in range(n_layers):
        x = spmm_local(rows_local, cols, vals, rows_per_shard, x, axis_name)
        acc = acc + x
    return acc / float(n_layers + 1)


