"""Device-side sparse graph containers and the SpMM propagation op.

This replaces DGL's ``gspmm(g, 'mul', 'sum')``, the reference's hottest op
(reference model.py:102,284,430,442,581; SURVEY.md §2.3). The adjacency is a
static-shape, row-sorted COO held in device memory; propagation is

    Y[r] = sum_{k: rows[k]=r} vals[k] * X[cols[k]]

implemented as gather → scale → ``jax.ops.segment_sum`` (sorted segments).
XLA fuses the gather+scale and lowers the sorted segment-sum to a
scatter-add; autodiff gives the transpose SpMM for the backward pass. Its
work is proportional to the edges, so it is the default engine
(core/platform.py).

Edge dropout keeps the reference's semantics — drop entries with prob p and
scale survivors by 1/(1-p) (reference model.py:263-275) — as a value mask,
the structure (and therefore all compiled shapes) never changes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from igcn_cf.graph.build import COO


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rows", "cols", "vals"],
    meta_fields=["n_rows", "n_cols"],
)
@dataclass(frozen=True)
class SparseGraph:
    """Row-sorted COO on device with static shape metadata."""

    rows: jnp.ndarray  # (nnz,) int32, non-decreasing
    cols: jnp.ndarray  # (nnz,) int32
    vals: jnp.ndarray  # (nnz,) float32
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @staticmethod
    def from_coo(coo: COO, pad_to: int = 8) -> "SparseGraph":
        """Upload a host COO (already row-sorted); pad nnz to a lane-friendly
        multiple with zero-valued self-entries on the last row."""
        nnz = coo.nnz
        padded = -(-max(nnz, 1) // pad_to) * pad_to
        rows = np.full(padded, coo.shape[0] - 1, dtype=np.int32)
        cols = np.zeros(padded, dtype=np.int32)
        vals = np.zeros(padded, dtype=np.float32)
        rows[:nnz] = coo.rows
        cols[:nnz] = coo.cols
        vals[:nnz] = coo.vals
        return SparseGraph(
            rows=jnp.asarray(rows),
            cols=jnp.asarray(cols),
            vals=jnp.asarray(vals),
            n_rows=int(coo.shape[0]),
            n_cols=int(coo.shape[1]),
        )

    def with_vals(self, vals: jnp.ndarray) -> "SparseGraph":
        return SparseGraph(self.rows, self.cols, vals, self.n_rows, self.n_cols)


def spmm(g: SparseGraph, x: jnp.ndarray) -> jnp.ndarray:
    """Sparse @ dense: (n_rows, n_cols) @ (n_cols, d) -> (n_rows, d)."""
    gathered = jnp.take(x, g.cols, axis=0) * g.vals[:, None]
    return jax.ops.segment_sum(
        gathered, g.rows, num_segments=g.n_rows, indices_are_sorted=True
    )


def spmm_transpose(g: SparseGraph, y: jnp.ndarray) -> jnp.ndarray:
    """Aᵀ @ dense: (n_cols, n_rows) @ (n_rows, d) -> (n_cols, d)."""
    gathered = jnp.take(y, g.rows, axis=0) * g.vals[:, None]
    return jax.ops.segment_sum(gathered, g.cols, num_segments=g.n_cols)


def edge_dropout_vals(
    g: SparseGraph, key: jax.Array, dropout: float
) -> jnp.ndarray:
    """Value vector with entries dropped at prob ``dropout`` and survivors
    scaled by 1/(1-p) (reference model.py:263-275 semantics; dropped entries
    contribute 0, identical to removing them from the structure)."""
    keep = jax.random.bernoulli(key, 1.0 - dropout, (g.vals.shape[0],))
    return jnp.where(keep, g.vals / (1.0 - dropout), 0.0)


def propagate_mean(
    g: SparseGraph, x0: jnp.ndarray, n_layers: int
) -> jnp.ndarray:
    """K rounds of SpMM, mean over layers 0..K (LightGCN propagation,
    reference model.py:96-106). Unrolled: K is tiny (<=3) and each layer is a
    distinct fused kernel."""
    acc = x0
    x = x0
    for _ in range(n_layers):
        x = spmm(g, x)
        acc = acc + x
    return acc / float(n_layers + 1)
