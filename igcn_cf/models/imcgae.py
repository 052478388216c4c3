"""IMCGAE — inductive matrix-completion GAE baseline.

Behavior of the reference IMCGAE (reference model.py:546-591): per-node
embeddings plus three shared role embeddings ("identical", "general user",
"general item"); node representation is the 3d concat [personal, role,
identical]; K propagation layers each apply node dropout with per-layer prob
``dropout - 0.1*i``, SpMM over the sym-normalized adjacency, and scale
``1/(i+2)``; final rep is the SUM over layers (not mean)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from igcn_cf.core.registry import MODELS
from igcn_cf.graph.build import sym_norm_adjacency
from igcn_cf.core.platform import graph_engine
from igcn_cf.kernels.dense_graph import (
    BipartiteDense,
    sym_norm_propagate,
)
from igcn_cf.kernels.sparse import SparseGraph, spmm
from igcn_cf.models.base import Model, l2sq, normal_init


@MODELS.register("IMCGAE")
class IMCGAE(Model):
    dot_scored = True  # users_rep @ items_rep^T: one-dispatch fused eval

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.n_layers = config["n_layers"]
        self.dropout = config["dropout"]
        self.backend = graph_engine(
            self.n_users, self.n_items, config.get("graph_backend", "auto")
        )

    def init_params(self, key):
        return {
            "embedding": normal_init(
                key, (self.n_users + self.n_items + 3, self.embedding_size)
            )
        }

    def init_buffers(self):
        if self.backend == "dense":
            return {
                "bip": BipartiteDense.build(
                    self.dataset.train_array, self.n_users, self.n_items,
                )
            }
        coo = sym_norm_adjacency(self.dataset.train_array, self.n_users, self.n_items)
        return {"norm_adj": SparseGraph.from_coo(coo)}

    def rep(self, params, buffers, *, train, key):
        emb = params["embedding"]
        n, m = self.n_users, self.n_items
        personal_u = emb[:n]
        personal_i = emb[n : n + m]
        identical = emb[n + m]
        general_u = emb[n + m + 1]
        general_i = emb[n + m + 2]
        u_rep = jnp.concatenate(
            [
                personal_u,
                jnp.broadcast_to(general_u[None, :], personal_u.shape),
                jnp.broadcast_to(identical[None, :], personal_u.shape),
            ],
            axis=1,
        )
        i_rep = jnp.concatenate(
            [
                personal_i,
                jnp.broadcast_to(general_i[None, :], personal_i.shape),
                jnp.broadcast_to(identical[None, :], personal_i.shape),
            ],
            axis=1,
        )
        x = jnp.concatenate([u_rep, i_rep], axis=0)
        acc = x
        for i in range(self.n_layers):
            if train and self.dropout > 0.0:
                # per-layer node dropout (reference model.py:578-580) is a
                # row mask on x — exact in either backend
                key, k_node = jax.random.split(key)
                p = self.dropout - 0.1 * i
                keep = jax.random.bernoulli(k_node, 1.0 - p, (n + m,))
                x = jnp.where(keep[:, None], x / (1.0 - p), 0.0)
            if self.backend == "dense":
                x = sym_norm_propagate(buffers["bip"], x)
            else:
                x = spmm(buffers["norm_adj"], x)
            acc = acc + x / float(i + 2)
        return acc

    def bpr_pieces(self, params, buffers, users, pos, neg, *, train, key):
        rep = self.rep(params, buffers, train=train, key=key)
        u = rep[users]
        p = rep[self.n_users + pos]
        n = rep[self.n_users + neg]
        l2 = l2sq(u, axis=1) + l2sq(p, axis=1) + l2sq(n, axis=1)
        return u, p, n, l2

    def make_predict_fn(self, params, buffers):
        return self._dot_predict_fn(params, buffers)

    def make_recommend_fn(self, params, buffers):
        return self._dot_recommend_fn(params, buffers)

    def grow_params(self, params, old_n_users, old_n_items):
        """dropui recipe: new personal rows get the mean of the old personal
        embeddings; the 3 shared role rows are preserved (reference
        run/dropui/imc_gae_dropui.py:31-38)."""
        old = params["embedding"]
        mean = jnp.mean(old[:-3], axis=0)
        new = jnp.broadcast_to(
            mean[None, :], (self.n_users + self.n_items + 3, self.embedding_size)
        )
        new = new.at[-3:].set(old[-3:])
        new = new.at[:old_n_users].set(old[:old_n_users])
        new = new.at[self.n_users : self.n_users + old_n_items].set(
            old[old_n_users:-3]
        )
        return {"embedding": new}
