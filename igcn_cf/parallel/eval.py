"""Distributed full-catalog retrieval evaluation.

Multi-chip version of evaluation/evaluate.py (BASELINE.json's "sharded
user·item matmul + distributed top-k merge"): item representations are
row-sharded along the ``table`` axis; each device scores its item block for
the user batch (one matmul), applies its slice of the train/val-exclusion and
banned-item masks, takes a LOCAL top-k, and the (value, global-id) pairs are
all-gathered and merged into the exact global top-k — k*T values cross the
interconnect instead of the full catalog row.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from igcn_cf.core.mesh import TABLE_AXIS, reshard
from igcn_cf.evaluation.evaluate import build_exclusion
from igcn_cf.evaluation.metrics import format_metrics

NEG_INF = -jnp.inf


def _pad_rows_np(x: np.ndarray, n: int) -> np.ndarray:
    pad = np.zeros((n - x.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad], axis=0)


def sharded_recommend(
    mesh: Mesh,
    users_rep: jnp.ndarray,  # (n_users, d) host, or a global device array
    items_rep,  # (n_items, d) host, or a (possibly table-sharded) global array
    ds,
    split: str,
    topks: Sequence[int],
    banned_items: Optional[np.ndarray] = None,
    test_batch_size: int = 512,
    return_device: bool = False,
) -> np.ndarray:
    """Top-max(topks) ids per user with the reference's masking semantics
    (reference trainer.py:140-166), scored shard-locally.

    Multi-host-safe: device inputs are resharded with compiled collectives
    (core/mesh.reshard) — no ``np.asarray`` on non-addressable shards — so
    the reps produced by the sharded trainer's ``rep_fn`` stay on device
    end-to-end."""
    n_users, n_items = ds.n_users, ds.n_items
    n_shards = mesh.shape[TABLE_AXIS]
    max_k = max(topks)

    items_pad = -(-n_items // n_shards) * n_shards
    tbl = NamedSharding(mesh, P(TABLE_AXIS, None))
    repl = NamedSharding(mesh, P())
    if isinstance(items_rep, jax.Array):
        # pad + reshard in one compiled step; the source rows stay sharded
        items_sh = jax.jit(
            lambda x: jnp.pad(x, ((0, items_pad - n_items), (0, 0))),
            out_shardings=tbl,
        )(items_rep)
    else:
        items_rep_p = _pad_rows_np(np.asarray(items_rep), items_pad)
        items_sh = jax.device_put(jnp.asarray(items_rep_p), tbl)
    users_rep = reshard(
        users_rep if isinstance(users_rep, jax.Array) else jnp.asarray(users_rep),
        repl,
    )

    if split != "train":
        exclude_np, _ = build_exclusion(ds, include_val=(split == "test"))
    else:
        exclude_np = np.full((n_users, 1), n_items, dtype=np.int32)
    exclude = jax.device_put(jnp.asarray(exclude_np), repl)

    banned_np = np.zeros(items_pad, dtype=bool)
    banned_np[n_items:] = True  # padding rows never recommended
    if banned_items is not None:
        banned_np[np.asarray(banned_items, dtype=np.int64)] = True
    banned = jax.device_put(jnp.asarray(banned_np), repl)

    i_shard = items_pad // n_shards

    # the whole eval is one jitted dispatch: a lax.scan over user blocks
    # inside shard_map, with the exact two-stage top-k per shard
    # (evaluation/evaluate.exact_topk)
    from igcn_cf.evaluation.evaluate import exact_topk, pad_user_blocks, score

    def shard_fn(users_pad_b, users_rep_full, items_shard, exclude_full,
                 banned_full):
        items_t = items_shard.reshape(i_shard, -1).T  # (d, I_shard)
        t = jax.lax.axis_index(TABLE_AXIS)
        offset = t * i_shard
        local_banned = jax.lax.dynamic_slice(banned_full, (offset,), (i_shard,))
        kk = min(max_k, i_shard)

        def body(c, users):
            scores = score(users_rep_full[users], items_t)  # (B, I_shard)
            scores = jnp.where(local_banned[None, :], NEG_INF, scores)
            # per-user exclusion ids mapped into the local range
            local = exclude_full[users] - offset
            in_range = (local >= 0) & (local < i_shard)
            b = scores.shape[0]
            ext = jnp.concatenate(
                [scores, jnp.zeros((b, 1), scores.dtype)], axis=1
            )
            rows = jnp.broadcast_to(jnp.arange(b)[:, None], local.shape)
            ext = ext.at[rows, jnp.where(in_range, local, i_shard)].set(NEG_INF)
            vals, idx = exact_topk(ext[:, :i_shard], kk)
            idx = idx + offset
            vals_all = jax.lax.all_gather(vals, TABLE_AXIS, axis=1, tiled=True)
            idx_all = jax.lax.all_gather(idx, TABLE_AXIS, axis=1, tiled=True)
            mvals, midx = jax.lax.top_k(vals_all, max_k)
            return c, jnp.take_along_axis(idx_all, midx, axis=1)

        _, recs = jax.lax.scan(body, jnp.int32(0), users_pad_b)
        return recs.reshape(-1, max_k)

    run = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(), P(TABLE_AXIS, None), P(), P()),
            out_specs=P(),
            check_vma=False,
        )
    )

    users_pad = jnp.asarray(pad_user_blocks(n_users, test_batch_size))
    rec_dev = run(users_pad, users_rep, items_sh, exclude, banned)[:n_users]
    if return_device:
        return rec_dev
    return np.asarray(rec_dev).astype(np.int64)


def sharded_evaluate(
    mesh: Mesh,
    users_rep,
    items_rep,
    ds,
    split: str,
    topks: Sequence[int],
    banned_items=None,
    test_batch_size: int = 512,
):
    from igcn_cf.evaluation.metrics import calculate_metrics_device

    eval_data = getattr(ds, split)
    # recommendations stay on device; the hit matrix and metric reductions
    # run there too and only scalars travel D2H (the replicated rec array
    # is addressable on every process, so this stays multi-host-safe)
    rec_dev = sharded_recommend(
        mesh, users_rep, items_rep, ds, split, topks, banned_items,
        test_batch_size, return_device=True,
    )
    metrics = calculate_metrics_device(
        rec_dev, eval_data, topks, cache_on=ds, cache_key=("sharded", split)
    )
    return format_metrics(metrics, topks), metrics
