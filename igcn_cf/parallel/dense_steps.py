"""Dense-sharded multichip INMO training step.

The multi-chip version of the dense-bipartite engine (kernels/dense_graph.py):
the BIT-PACKED binary interaction matrix is ROW-SHARDED by output block
across the ``table`` mesh axis — each device holds

    B_shard  (nu_pad/T, ni_pad/32) uint32 — its user-row block of B, packed
    BT_shard (ni_pad/T, nu_pad/32) uint32 — its item-row block of B^T, packed

i.e. 2/(8T) bytes per cell per chip, so catalog capacity scales linearly
with the device count (bit packing and the dim0-contraction backward need
no transposed copy — kernels/bitpack.py). Each propagation layer all-gathers
the (small, d-wide) dense operand along ``table`` and runs a shard-local
matmul; under AD the gathers transpose to reduce-scatters. The template
embedding table is row-sharded the same way; the BPR+aux batch is sharded
along ``data`` with pmean'd losses. Edge dropout folds the shard index into
the mask seed so masks are independent across shards while fwd/bwd stay
bit-identical within one (coordinate-hash keep-words, kernels/bitpack.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from igcn_cf.core.mesh import DATA_AXIS, TABLE_AXIS
from igcn_cf.kernels.bitpack import bb_matmul, bb_matmul_dropped, pack_bits


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass
class ShardedDenseINMO:
    mesh: Mesh
    step: Any
    params: Dict[str, jnp.ndarray]
    opt_state: Any
    buffers: Dict[str, Any]
    n_users: int
    n_items: int


def _mm_local(bp_shard, x, key, p):
    """Shard-local (possibly dropout-masked) bit-packed matmul; the backward
    runs the dim0-contraction over the same packed tiles."""
    if p > 0.0 and key is not None:
        return bb_matmul_dropped(bp_shard, x, key, p, False)
    return bb_matmul(bp_shard, x, False)


def build_inmo_dense_sharded_train(
    dataset,
    mesh: Mesh,
    *,
    embedding_size: int = 64,
    n_layers: int = 3,
    dropout: float = 0.3,
    lr: float = 1e-3,
    l2_reg: float = 0.0,
    aux_reg: float = 0.01,
    batch_size: int = 2048,
    seed: int = 2021,
    tile: int = 256,
) -> ShardedDenseINMO:
    """feature_ratio=1 flagship config (identity templates)."""
    n_users, n_items = dataset.n_users, dataset.n_items
    n_shards = mesh.shape[TABLE_AXIS]
    data_size = mesh.shape[DATA_AXIS]
    assert batch_size % data_size == 0

    # pack per-shard row blocks; columns pad to the 32-bit word geometry
    nup = _pad_to(n_users, n_shards * tile)
    nip = _pad_to(n_items, n_shards * tile)
    nup_w = _pad_to(nup, 4096)  # packed column space of BT
    nip_w = _pad_to(nip, 4096)  # packed column space of B
    b = np.zeros((max(nup, nup_w), max(nip, nip_w)), dtype=np.uint8)
    b[dataset.train_array[:, 0], dataset.train_array[:, 1]] = 1
    deg_u = b.sum(axis=1, dtype=np.int64)[:nup].astype(np.float32)
    deg_i = b.sum(axis=0, dtype=np.int64)[:nip].astype(np.float32)

    urows = nup // n_shards
    irows = nip // n_shards
    b_packed = pack_bits(b[:nup, :nip_w])  # (nup, nip_w/32)
    bt_packed = pack_bits(np.ascontiguousarray(b[:nup_w, :nip].T))  # (nip, nup_w/32)

    tbl2 = NamedSharding(mesh, P(TABLE_AXIS, None, None))
    tbl = NamedSharding(mesh, P(TABLE_AXIS, None))
    repl = NamedSharding(mesh, P())

    buffers = {
        "B": jax.device_put(
            jnp.asarray(b_packed.reshape(n_shards, urows, -1)), tbl2
        ),
        "BT": jax.device_put(
            jnp.asarray(bt_packed.reshape(n_shards, irows, -1)), tbl2
        ),
        "deg_u": jax.device_put(jnp.asarray(deg_u.reshape(n_shards, urows)), tbl),
        "deg_i": jax.device_put(jnp.asarray(deg_i.reshape(n_shards, irows)), tbl),
        # feat row sums = degree + 1 token edge (identity templates)
        "alpha": jax.device_put(jnp.float32(1.0), repl),
    }

    # template table = [users | items | tok_u | tok_i], padded per axis so
    # user/item blocks shard independently
    key0 = jax.random.PRNGKey(seed)
    ku, ki, kt = jax.random.split(key0, 3)
    emb_u = 0.1 * jax.random.normal(ku, (nup, embedding_size), jnp.float32)
    emb_i = 0.1 * jax.random.normal(ki, (nip, embedding_size), jnp.float32)
    toks = 0.1 * jax.random.normal(kt, (2, embedding_size), jnp.float32)
    params = {
        "emb_u": jax.device_put(
            emb_u.reshape(n_shards, urows, embedding_size), tbl2
        ),
        "emb_i": jax.device_put(
            emb_i.reshape(n_shards, irows, embedding_size), tbl2
        ),
        "toks": jax.device_put(toks, repl),
        "w": jax.device_put(jnp.ones((embedding_size,), jnp.float32), repl),
    }

    opt = optax.adam(lr)
    opt_state = opt.init(params)

    e3 = P(TABLE_AXIS, None, None)

    def f(B, BT, deg_u, deg_i, alpha,
          emb_u, emb_i, toks, w,
          users, pos, neg, a_users, a_pos, a_neg, key):
        # local shards arrive with a leading axis of size 1
        B, BT = B[0], BT[0]
        deg_u_l, deg_i_l = deg_u[0], deg_i[0]
        emb_u_l, emb_i_l = emb_u[0], emb_i[0]
        t = jax.lax.axis_index(TABLE_AXIS)
        shard_key = jax.random.fold_in(key, t)
        k_feat_u, k_feat_i, k_tok = jax.random.split(shard_key, 3)

        emb_u_full = jax.lax.all_gather(emb_u_l, TABLE_AXIS, axis=0, tiled=True)
        emb_i_full = jax.lax.all_gather(emb_i_l, TABLE_AXIS, axis=0, tiled=True)

        def padc(x, n):  # pad the gathered operand to the packed column space
            return jnp.concatenate(
                [x, jnp.zeros((n - x.shape[0], x.shape[1]), x.dtype)], axis=0
            ) if x.shape[0] < n else x

        # -- INMO feat aggregation, shard-local rows --------------------------
        exponent = (alpha - 1.0) / 2.0 - 0.5
        w_u = jnp.power(deg_u_l + 1.0, exponent)
        w_i = jnp.power(deg_i_l + 1.0, exponent)
        scale = 1.0 / (1.0 - dropout) if dropout > 0.0 else 1.0
        xu = _mm_local(B, padc(emb_i_full, nip_w), k_feat_u, dropout)
        xi = _mm_local(BT, padc(emb_u_full, nup_w), k_feat_i, dropout)
        if dropout > 0.0:
            ktu, kti = jax.random.split(k_tok)
            keep_u = jax.random.bernoulli(ktu, 1.0 - dropout, (xu.shape[0], 1))
            keep_i = jax.random.bernoulli(kti, 1.0 - dropout, (xi.shape[0], 1))
            xu = (xu + jnp.where(keep_u, toks[0][None, :], 0.0)) * scale
            xi = (xi + jnp.where(keep_i, toks[1][None, :], 0.0)) * scale
        else:
            xu = xu + toks[0][None, :]
            xi = xi + toks[1][None, :]
        xu = w_u[:, None] * xu
        xi = w_i[:, None] * xi

        # -- LightGCN propagation, mean over layers ---------------------------
        su_l = jax.lax.rsqrt(jnp.maximum(deg_u_l, 1.0))[:, None]
        si_l = jax.lax.rsqrt(jnp.maximum(deg_i_l, 1.0))[:, None]
        si_full = jax.lax.all_gather(si_l, TABLE_AXIS, axis=0, tiled=True)
        su_full = jax.lax.all_gather(su_l, TABLE_AXIS, axis=0, tiled=True)
        acc_u, acc_i = xu, xi
        cu, ci = xu, xi
        for _ in range(n_layers):
            ci_full = jax.lax.all_gather(ci, TABLE_AXIS, axis=0, tiled=True)
            cu_full = jax.lax.all_gather(cu, TABLE_AXIS, axis=0, tiled=True)
            nu_ = su_l * _mm_local(B, padc(si_full * ci_full, nip_w), None, 0.0)
            ni_ = si_l * _mm_local(BT, padc(su_full * cu_full, nup_w), None, 0.0)
            cu, ci = nu_, ni_
            acc_u = acc_u + cu
            acc_i = acc_i + ci
        rep_u = jax.lax.all_gather(
            acc_u / (n_layers + 1.0), TABLE_AXIS, axis=0, tiled=True
        )
        rep_i = jax.lax.all_gather(
            acc_i / (n_layers + 1.0), TABLE_AXIS, axis=0, tiled=True
        )

        # -- BPR + aux on the data-sharded batch ------------------------------
        u = rep_u[users]
        p_ = rep_i[pos]
        n_ = rep_i[neg]
        bpr = jnp.mean(jax.nn.softplus(jnp.sum(u * n_, 1) - jnp.sum(u * p_, 1)))
        l2 = jnp.mean(
            jnp.sum(u * u, 1) + jnp.sum(p_ * p_, 1) + jnp.sum(n_ * n_, 1)
        )
        au = emb_u_full[a_users]
        ap = emb_i_full[a_pos]
        an = emb_i_full[a_neg]
        aux = jnp.mean(
            jax.nn.softplus(
                jnp.sum(au * an * w[None, :], 1) - jnp.sum(au * ap * w[None, :], 1)
            )
        )
        loss = bpr + l2_reg * l2 + aux_reg * aux
        return jax.lax.pmean(loss, DATA_AXIS)

    shard_f = jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(
            e3, e3, P(TABLE_AXIS, None), P(TABLE_AXIS, None), P(),
            e3, e3, P(), P(),
            P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
            P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
            P(),
        ),
        out_specs=P(),
        check_vma=False,
    )

    def loss_fn(params, buffers, batch, key):
        users, pos, neg, a_users, a_pos, a_neg = batch
        return shard_f(
            buffers["B"], buffers["BT"],
            buffers["deg_u"], buffers["deg_i"], buffers["alpha"],
            params["emb_u"], params["emb_i"], params["toks"], params["w"],
            users, pos, neg, a_users, a_pos, a_neg, key,
        )

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, buffers, batch, key):
        loss, grads = jax.value_and_grad(
            lambda p: loss_fn(p, buffers, batch, key)
        )(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return ShardedDenseINMO(
        mesh=mesh,
        step=step,
        params=params,
        opt_state=opt_state,
        buffers=buffers,
        n_users=n_users,
        n_items=n_items,
    )
