"""Dense-bipartite graph engine: propagation as products with the bit-packed
interaction matrix.

Every graph matrix in this workload is a binary interaction pattern with
rank-1 or row-wise scaling:

  * sym-norm adjacency (reference model.py:85-94):
        A = D^-1/2 [[0, B], [B^T, 0]] D^-1/2
    so A @ X = [ du ∘ (B @ (di ∘ X_i)) ; di ∘ (B^T @ (du ∘ X_u)) ]
  * NGCF's L1-row-normalized A+I (reference model.py:255-261):
        Y_u = (B @ X_i + X_u) / (deg_u + 1)        (and symmetrically)
  * INMO's feat_mat (reference model.py:386-421): binary train pattern
    restricted to template columns + a token column, with per-row annealed
    weights w_r = rowsum^((alpha-1)/2 - 1/2). Template selection folds into
    the embedding matrix (scatter core-template rows into full user/item
    space, zeros elsewhere), so the same B serves feat and adjacency:
        X0_u = w_u ∘ (B @ E_items_full + tok_u)

B is stored at one bit per entry (kernels/bitpack.py) with no transpose
copy. Edge dropout (reference model.py:263-275) is one bitwise AND with a
coordinate-hashed keep-word. The products unpack B and run as dense XLA
dots, so this engine pays for every user-item cell; core/platform.py picks
the sparse engine unless 'dense' is asked for.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from igcn_cf.kernels.bitpack import (
    TK,
    TM,
    bb_matmul,
    bb_matmul_dropped,
    bbt_pair,
    bbt_pair_premasked,
    mask_words,
    pack_interactions,
    pad_to,
)

PAD_ROWS = TM
PAD_COLS = TK


def _pad_rows(x: jnp.ndarray, n: int) -> jnp.ndarray:
    if x.shape[0] == n:
        return x
    return jnp.concatenate(
        [x, jnp.zeros((n - x.shape[0],) + x.shape[1:], x.dtype)], axis=0
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["B", "deg_u", "deg_i"],
    meta_fields=["n_users", "n_items"],
)
@dataclass(frozen=True)
class BipartiteDense:
    """Bit-packed binary interaction matrix (rows padded to TM=512, columns
    to TK=4096) plus logical-size degree vectors. ``B`` is (rows_pad,
    cols_pad/32) uint32 in the kernels/bitpack.py layout."""

    B: jnp.ndarray  # (nup, nip/32) uint32
    deg_u: jnp.ndarray  # (n_users,) f32
    deg_i: jnp.ndarray  # (n_items,) f32
    n_users: int
    n_items: int

    @staticmethod
    def build(train_array: np.ndarray, n_users: int,
              n_items: int) -> "BipartiteDense":
        """Pack on the device: host-to-device moves only the (nnz, 2)
        interaction array (~7 MB at the Gowalla shape) instead of the packed
        matrix. The scatter adds distinct powers of two per (row, word)
        because interaction pairs are deduplicated first, so add equals
        bitwise-or and the result is bit-identical to the host pack
        (``build_host``, kept as the test oracle)."""
        from igcn_cf.kernels.bitpack import TK, TKP, TM, pad_to

        train_array = np.asarray(train_array)
        mp, kp = pad_to(n_users, TM), pad_to(n_items, TK)
        if len(train_array):
            # upstream loaders dedupe, but add==or REQUIRES uniqueness —
            # enforce it (cheap) rather than corrupt bits on a stray dup
            uniq = np.unique(
                train_array[:, 0].astype(np.int64) * np.int64(n_items)
                + train_array[:, 1].astype(np.int64)
            )
            rows = jnp.asarray((uniq // n_items).astype(np.int32))
            cols_np = (uniq % n_items).astype(np.int32)
            cols = jnp.asarray(cols_np)
            word = (cols // TK) * TKP + (cols % TKP)
            bit = ((cols % TK) // TKP).astype(jnp.uint32)
            packed = (
                jnp.zeros((mp, kp // 32), jnp.uint32)
                .at[rows, word]
                .add(jnp.uint32(1) << bit)
            )
            deg_u = (
                jnp.zeros(n_users, jnp.float32).at[rows].add(1.0)
            )
            deg_i = jnp.zeros(n_items, jnp.float32).at[cols].add(1.0)
        else:
            packed = jnp.zeros((mp, kp // 32), jnp.uint32)
            deg_u = jnp.zeros(n_users, jnp.float32)
            deg_i = jnp.zeros(n_items, jnp.float32)
        return BipartiteDense(
            B=packed,
            deg_u=deg_u,
            deg_i=deg_i,
            n_users=n_users,
            n_items=n_items,
        )

    @staticmethod
    def build_host(train_array: np.ndarray, n_users: int,
                   n_items: int) -> "BipartiteDense":
        """Host-side pack, kept as the oracle for
        ``build``'s device scatter."""
        train_array = np.asarray(train_array)
        packed, _, _ = pack_interactions(train_array, n_users, n_items)
        deg_u = np.zeros(n_users, dtype=np.float32)
        deg_i = np.zeros(n_items, dtype=np.float32)
        if len(train_array):
            np.add.at(deg_u, train_array[:, 0], 1.0)
            np.add.at(deg_i, train_array[:, 1], 1.0)
        return BipartiteDense(
            B=jnp.asarray(packed),
            deg_u=jnp.asarray(deg_u),
            deg_i=jnp.asarray(deg_i),
            n_users=n_users,
            n_items=n_items,
        )

    @property
    def cols_padded(self) -> int:
        return int(self.B.shape[1]) * 32

    @property
    def rows_padded(self) -> int:
        return int(self.B.shape[0])

    # B @ xi -> (n_users, d)
    def mm_ui(self, xi: jnp.ndarray) -> jnp.ndarray:
        xi = _pad_rows(xi, self.cols_padded)
        return bb_matmul(self.B, xi, False)[: self.n_users]

    # B^T @ xu -> (n_items, d)
    def mm_iu(self, xu: jnp.ndarray) -> jnp.ndarray:
        xu = _pad_rows(xu, self.rows_padded)
        return bb_matmul(self.B, xu, True)[: self.n_items]

    def mm_ui_dropped(self, xi, key, p: float) -> jnp.ndarray:
        xi = _pad_rows(xi, self.cols_padded)
        return bb_matmul_dropped(self.B, xi, key, p, False)[: self.n_users]

    def mm_iu_dropped(self, xu, key, p: float) -> jnp.ndarray:
        xu = _pad_rows(xu, self.rows_padded)
        return bb_matmul_dropped(self.B, xu, key, p, True)[: self.n_items]

    def memory_bytes(self) -> int:
        return int(self.B.shape[0]) * int(self.B.shape[1]) * 4


def sym_norm_propagate(g: BipartiteDense, x: jnp.ndarray) -> jnp.ndarray:
    """One D^-1/2 A D^-1/2 @ X step (LightGCN/IGCN/IMCGAE propagation)."""
    su = jax.lax.rsqrt(jnp.maximum(g.deg_u, 1.0))[:, None]
    si = jax.lax.rsqrt(jnp.maximum(g.deg_i, 1.0))[:, None]
    xu, xi = x[: g.n_users], x[g.n_users :]
    yu = su * g.mm_ui(si * xi)
    yi = si * g.mm_iu(su * xu)
    return jnp.concatenate([yu, yi], axis=0)


def _pad_cols(xt: jnp.ndarray, n: int) -> jnp.ndarray:
    if xt.shape[1] == n:
        return xt
    return jnp.concatenate(
        [xt, jnp.zeros(xt.shape[:1] + (n - xt.shape[1],), xt.dtype)], axis=1
    )


def _sym_norm_propagate_t(g: BipartiteDense, xt: jnp.ndarray) -> jnp.ndarray:
    """One D^-1/2 A D^-1/2 step in the transposed (d, n) layout: both
    directions ride one ``bbt_pair`` call."""
    su = jax.lax.rsqrt(jnp.maximum(g.deg_u, 1.0))[None, :]
    si = jax.lax.rsqrt(jnp.maximum(g.deg_i, 1.0))[None, :]
    xu_t, xi_t = xt[:, : g.n_users], xt[:, g.n_users :]
    y1t, y2t = bbt_pair(
        g.B,
        _pad_cols(si * xi_t, g.cols_padded),
        _pad_cols(su * xu_t, g.rows_padded),
    )
    return jnp.concatenate(
        [su * y1t[:, : g.n_users], si * y2t[:, : g.n_items]], axis=1
    )


def sym_norm_propagate_mean(
    g: BipartiteDense, x0: jnp.ndarray, n_layers: int
) -> jnp.ndarray:
    """mean over layers 0..K of sym-norm propagation (reference
    model.py:96-106). Runs internally in the transposed (d, n) layout:
    one transpose in, one out."""
    xt = x0.T
    acc = xt
    for _ in range(n_layers):
        xt = _sym_norm_propagate_t(g, xt)
        acc = acc + xt
    return (acc / float(n_layers + 1)).T


def ngcf_propagate(
    g: BipartiteDense,
    x: jnp.ndarray,
    *,
    dropout: float = 0.0,
    key: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """One L1-row-norm (A + I) @ X step (NGCF message aggregation, reference
    model.py:255-261,284), with optional edge dropout over interaction AND
    self-loop entries (reference model.py:280)."""
    xu, xi = x[: g.n_users], x[g.n_users :]
    if dropout > 0.0 and key is not None:
        k_b, k_bt, k_su, k_si = jax.random.split(key, 4)
        scale = 1.0 / (1.0 - dropout)
        self_u = jax.random.bernoulli(k_su, 1.0 - dropout, (g.n_users, 1))
        self_i = jax.random.bernoulli(k_si, 1.0 - dropout, (g.n_items, 1))
        yu = (g.mm_ui_dropped(xi, k_b, dropout) + jnp.where(self_u, xu, 0.0)) * scale
        yi = (g.mm_iu_dropped(xu, k_bt, dropout) + jnp.where(self_i, xi, 0.0)) * scale
    else:
        yu = g.mm_ui(xi) + xu
        yi = g.mm_iu(xu) + xi
    yu = yu / (g.deg_u + 1.0)[:, None]
    yi = yi / (g.deg_i + 1.0)[:, None]
    return jnp.concatenate([yu, yi], axis=0)


def feat_aggregate(
    g: BipartiteDense,
    e_items_full: jnp.ndarray,  # (n_items, d); zero rows on non-template items
    e_users_full: jnp.ndarray,  # (n_users, d)
    tok_u: jnp.ndarray,  # (d,) shared user-token embedding
    tok_i: jnp.ndarray,
    w_u: jnp.ndarray,  # (n_users,) annealed row weights
    w_i: jnp.ndarray,
    *,
    dropout: float = 0.0,
    key: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """X0 = feat_mat @ E — the INMO inductive layer (reference
    model.py:423-432) — with optional edge dropout on both train edges and
    token edges (reference model.py:435 via 263-275). The user-side and
    item-side blocks of feat_mat are distinct edge sets, so their masks are
    independent: k_b drops the user-side block, k_bt the item-side.

    Both directions run in the transposed layout. Dropout pre-masks the
    packed operand once per direction (``mask_words``), so the four forward
    and backward products reuse the masks instead of rehashing."""
    x1t = _pad_rows(e_items_full, g.cols_padded).T
    x2t = _pad_rows(e_users_full, g.rows_padded).T
    if dropout > 0.0 and key is not None:
        k_b, k_bt, k_tu, k_ti = jax.random.split(key, 4)
        scale = 1.0 / (1.0 - dropout)
        tok_keep_u = jax.random.bernoulli(k_tu, 1.0 - dropout, (g.n_users, 1))
        tok_keep_i = jax.random.bernoulli(k_ti, 1.0 - dropout, (g.n_items, 1))
        y1t, y2t = bbt_pair_premasked(
            mask_words(g.B, k_b, dropout),
            mask_words(g.B, k_bt, dropout),
            x1t, x2t,
        )
        xu_t = (
            y1t[:, : g.n_users]
            + jnp.where(tok_keep_u.T, tok_u[:, None], 0.0)
        ) * scale
        xi_t = (
            y2t[:, : g.n_items]
            + jnp.where(tok_keep_i.T, tok_i[:, None], 0.0)
        ) * scale
    else:
        y1t, y2t = bbt_pair(g.B, x1t, x2t)
        xu_t = y1t[:, : g.n_users] + tok_u[:, None]
        xi_t = y2t[:, : g.n_items] + tok_i[:, None]
    x0t = jnp.concatenate(
        [w_u[None, :] * xu_t, w_i[None, :] * xi_t], axis=1
    )
    return x0t.T


def dense_unpacked_bytes(n_users: int, n_items: int) -> int:
    """Device bytes a dense-engine product can hold at once: the float32
    unpacked matrix, its keep mask and the masked copy."""
    return pad_to(n_users, PAD_ROWS) * pad_to(n_items, PAD_COLS) * 4 * 3
