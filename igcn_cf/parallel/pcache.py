"""Sharded propagation cache: the cached-operator engine on a
('data', 'table') mesh.

On one device the propagation cache P = mean_{k=0..K} A^k
(kernels/pcache.py) holds n^2 bf16 entries; at the Amazon-book shape that is
~41.5 GiB. Sharding P over the table axis divides it by the shard count.

Layout: P is symmetric (A is), so shard t's column slab

    P[:, ct]  (n, rows_per_shard)   ct = rows [t*rps, (t+1)*rps)

is its node-row block transposed, stored as the same (n, width) bf16 matrix
the single-device gather+matmul reads, so it runs unchanged per shard:

    partial_t = P[rows, ct] @ X0[ct]      gather+matmul on the local slab
    reps      = psum_t(partial_t)         one (R, d) psum over 'table'
    dX0[ct]   = P[rows, ct]^T @ d(reps)   shard-local backward, no extra
                                          collective (psum's VJP
                                          replicates d(reps))

X0[ct] is exactly the shard-local output of the sharded feat aggregation
(parallel/steps.py edge partition uses the same row blocks), padded with
zero rows from rows_per_shard up to the ALIGN'd slab width. The padding
columns: ``build_prop_cache_cols`` builds the window [t*rps, t*rps+width) of
the global P, so a shard's columns past rps are not zeros — they are the
next shard's real P columns (only columns >= n propagate to zero).
Correctness relies on the consumers zeroing the operand instead:
``cached_prop`` pads X0 with zero rows over [rps, width), and the backward
slices dx0[:rps] — so the overlap columns multiply zeros forward and are
discarded backward. The parity test (tests/test_parallel.py sharded-pcache
build oracle) pins both the overlap contents and the zero-padded-X0
contract.

Against the recompute path (parallel/sharded.py): K edge-partitioned SpMMs
with a d-wide all-gather per layer plus a full-table rep all-gather; the
cached path touches only 3*batch rows of P per step and moves one (R, d)
psum.

Build: each shard's slab is a column window of P built independently
(kernels/pcache.build_prop_cache_cols through the sparse engine), assembled
per addressable shard onto the mesh. Reference hot path being replaced:
reference model.py:434-446.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from igcn_cf.core.mesh import TABLE_AXIS
from igcn_cf.kernels.pcache import ALIGN, build_prop_cache_cols


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def shard_slab_width(rows_per_shard: int) -> int:
    """Per-shard slab column width: the shard's node-row count padded to
    the cache's column alignment."""
    return _pad_to(rows_per_shard, ALIGN)


def sharded_pcache_bytes_per_chip(n_users: int, n_items: int,
                                  n_shards: int) -> int:
    """Per-device slab bytes, computed with the same rows_per_shard formula
    the build receives (ShardedGraph.from_coo: ceil(n/(T*8))*8 — up to 7
    rows larger than ceil(n/T)); the smaller estimate could approve a cache
    whose real slab is one ALIGN column block larger than budgeted."""
    n = n_users + n_items
    rps = _pad_to(n, n_shards * 8) // n_shards
    return n * shard_slab_width(rps) * 2


def build_sharded_pcache_host(
    train_array: np.ndarray,
    n_users: int,
    n_items: int,
    mesh: Mesh,
    n_layers: int,
    rows_per_shard: int,
    block: int = 2048,
) -> jnp.ndarray:
    """Host-side (scipy CSR) build of the SAME stacked sharded cache layout
    as ``build_sharded_pcache`` — exact f32 column propagation, stored bf16.

    Purpose: mid-scale demonstrations on the virtual CPU mesh without device
    memory for the build's transients. It is O(nnz * npad), like the
    device build, and equal to it modulo bf16 rounding (parity pinned in
    tests/test_parallel.py)."""
    import scipy.sparse as sp

    n = n_users + n_items
    n_shards = mesh.shape[TABLE_AXIS]
    width = shard_slab_width(rows_per_shard)
    arr = np.asarray(train_array)
    rows = np.concatenate([arr[:, 0], n_users + arr[:, 1]])
    cols = np.concatenate([n_users + arr[:, 1], arr[:, 0]])
    a = sp.csr_matrix(
        (np.ones(rows.shape[0], np.float32), (rows, cols)), shape=(n, n)
    )
    deg = np.maximum(np.asarray(a.sum(axis=1)).ravel(), 1.0)
    s = (1.0 / np.sqrt(deg)).astype(np.float32)
    a = sp.diags(s) @ a @ sp.diags(s)
    a = a.tocsr().astype(np.float32)
    inv = np.float32(1.0 / (n_layers + 1))

    sh = NamedSharding(mesh, P(TABLE_AXIS, None, None))
    shape = (n_shards, n, width)
    built: dict = {}

    def _build_shard(t: int) -> np.ndarray:
        col0 = t * rows_per_shard
        slab = np.zeros((n, width), dtype=jnp.bfloat16.dtype)
        for b0 in range(0, width, block):
            w = min(block, width - b0)
            g0 = col0 + b0
            # one-hot columns; global ids >= n propagate to zero
            live = max(0, min(w, n - g0))
            if live == 0:
                continue
            x = np.zeros((n, w), np.float32)
            x[np.arange(g0, g0 + live), np.arange(live)] = 1.0
            acc = x * inv
            for _ in range(n_layers):
                x = a @ x
                acc += x * inv
            slab[:, b0 : b0 + w] = acc.astype(jnp.bfloat16.dtype)
        return slab[None]

    def cb(index):
        t = index[0].start or 0
        if t not in built:
            built[t] = _build_shard(t)
        return built[t]

    return jax.make_array_from_callback(shape, sh, cb)


def build_sharded_pcache(
    norm_adj,
    mesh: Mesh,
    n_layers: int,
    rows_per_shard: int,
) -> jnp.ndarray:
    """Stacked sharded cache: a (T, n, width) bf16 array with the leading
    axis sharded over 'table' — shard t holds the column window
    P[:, t*rows_per_shard : ...]. ``norm_adj`` is the single-device
    sym-norm adjacency (kernels.sparse.SparseGraph) the columns propagate
    through. ``rows_per_shard`` must match the node-row partition of the
    sharded graph (parallel/sharded.py) so X0's shard-local rows line up
    with the slab columns."""
    from igcn_cf.kernels.sparse import spmm

    n_shards = mesh.shape[TABLE_AXIS]
    n = norm_adj.n_rows
    width = shard_slab_width(rows_per_shard)
    sh = NamedSharding(mesh, P(TABLE_AXIS, None, None))
    shape = (n_shards, n, width)

    # build lazily per addressable shard (multi-host builds only local
    # blocks; a full host-side stack of P would defeat the sharding)
    built: dict = {}

    def cb(index):
        t = index[0].start or 0
        if t not in built:
            built[t] = np.asarray(
                build_prop_cache_cols((spmm, norm_adj), n, n_layers,
                                      t * rows_per_shard, width)
            )[None]
        return built[t]

    return jax.make_array_from_callback(shape, sh, cb)
