"""Distributed full-catalog retrieval: sharded scoring matmul + top-k merge.

The eval hot path at scale (BASELINE.json): item representations row-sharded
along the table axis; each shard computes its (B, items_per_shard) score
block, masks its local slice of the exclusion/ban sets, takes a LOCAL top-k,
and the (value, GLOBAL index) pairs are all-gathered and merged — exact
global top-k with k*T instead of n_items values crossing the interconnect.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from igcn_cf.core.mesh import TABLE_AXIS

NEG_INF = -jnp.inf


def local_topk_with_global_ids(
    scores_local: jnp.ndarray, shard_offset: jnp.ndarray, k: int
):
    """Per-shard top-k over the local item block; indices shifted to global."""
    vals, idx = jax.lax.top_k(scores_local, k)
    return vals, idx + shard_offset


def merge_topk(vals_all: jnp.ndarray, idx_all: jnp.ndarray, k: int):
    """Merge T shard-local top-k lists: (B, T*k) -> global (B, k)."""
    vals, pos = jax.lax.top_k(vals_all, k)
    idx = jnp.take_along_axis(idx_all, pos, axis=1)
    return vals, idx


def sharded_topk(
    users_rep: jnp.ndarray,
    items_rep_shard: jnp.ndarray,
    k: int,
    axis_name: str = TABLE_AXIS,
    exclusion_mask_shard: jnp.ndarray | None = None,
):
    """Inside shard_map: users_rep replicated (B, d); items_rep_shard this
    device's (I_shard, d) block. Returns replicated global (B, k) ids+vals."""
    i_shard = items_rep_shard.shape[0]
    t = jax.lax.axis_index(axis_name)
    scores = users_rep @ items_rep_shard.T  # (B, I_shard)
    if exclusion_mask_shard is not None:
        scores = jnp.where(exclusion_mask_shard, NEG_INF, scores)
    kk = min(k, i_shard)
    vals, idx = local_topk_with_global_ids(scores, t * i_shard, kk)
    vals_all = jax.lax.all_gather(vals, axis_name, axis=1, tiled=True)
    idx_all = jax.lax.all_gather(idx, axis_name, axis=1, tiled=True)
    return merge_topk(vals_all, idx_all, k)
