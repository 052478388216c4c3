"""NGCF — Neural Graph Collaborative Filtering baseline.

Behavior of the reference NGCF (reference model.py:233-302): embedding table
init kaiming-uniform; adjacency = L1-row-normalized (A + I); per layer:
SpMM message, bilinear (elementwise product) term, two Linear layers, leaky
ReLU (slope 0.2), feature dropout, L2 row normalization, and CONCAT of all
layer outputs (including layer 0). Sparse edge dropout on the adjacency per
forward; BPR L2 on the concatenated propagated reps."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from igcn_cf.core.registry import MODELS
from igcn_cf.graph.build import l1_norm_adjacency_with_self_loops
from igcn_cf.core.platform import graph_engine
from igcn_cf.kernels.dense_graph import (
    BipartiteDense,
    ngcf_propagate,
)
from igcn_cf.kernels.sparse import SparseGraph, edge_dropout_vals, spmm
from igcn_cf.models.base import (
    Model,
    kaiming_uniform,
    l2sq,
    linear_apply,
    linear_init,
)


@MODELS.register("NGCF")
class NGCF(Model):
    dot_scored = True  # users_rep @ items_rep^T: one-dispatch fused eval

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.layer_sizes = list(config["layer_sizes"])
        self.dropout = config["dropout"]
        self.n_layers = len(self.layer_sizes)
        self.backend = graph_engine(
            self.n_users, self.n_items, config.get("graph_backend", "auto")
        )

    def init_params(self, key):
        keys = jax.random.split(key, 1 + 2 * self.n_layers)
        params = {
            "embedding": kaiming_uniform(
                keys[0], (self.n_users + self.n_items, self.embedding_size)
            )
        }
        sizes = [self.embedding_size] + self.layer_sizes
        gc, bi = [], []
        for i in range(self.n_layers):
            gc.append(linear_init(keys[1 + 2 * i], sizes[i], sizes[i + 1]))
            bi.append(linear_init(keys[2 + 2 * i], sizes[i], sizes[i + 1]))
        params["gc_layers"] = gc
        params["bi_layers"] = bi
        return params

    def init_buffers(self):
        if self.backend == "dense":
            return {
                "bip": BipartiteDense.build(
                    self.dataset.train_array, self.n_users, self.n_items,
                )
            }
        coo = l1_norm_adjacency_with_self_loops(
            self.dataset.train_array, self.n_users, self.n_items
        )
        return {"norm_adj": SparseGraph.from_coo(coo)}

    def rep(self, params, buffers, *, train, key):
        dropout_on = train and self.dropout > 0.0
        # the reference samples ONE dropped adjacency per forward and reuses
        # it across layers (reference model.py:280-284); the dense path gets
        # the same behavior by reusing one mask key (the coordinate-hash mask
        # is a pure function of the key)
        k_edge = None
        if dropout_on:
            key, k_edge = jax.random.split(key)
        g = None
        if not self.backend == "dense":
            g = buffers["norm_adj"]
            if dropout_on:
                g = g.with_vals(edge_dropout_vals(g, k_edge, self.dropout))
        x = params["embedding"]
        outs = [x]
        for i in range(self.n_layers):
            if self.backend == "dense":
                if dropout_on:
                    m0 = ngcf_propagate(
                        buffers["bip"], x, dropout=self.dropout, key=k_edge
                    )
                else:
                    m0 = ngcf_propagate(buffers["bip"], x)
            else:
                m0 = spmm(g, x)
            m1 = x * m0
            h = linear_apply(params["gc_layers"][i], m0) + linear_apply(
                params["bi_layers"][i], m1
            )
            h = jax.nn.leaky_relu(h, negative_slope=0.2)
            if train and self.dropout > 0.0:
                key, k_feat = jax.random.split(key)
                keep = jax.random.bernoulli(k_feat, 1.0 - self.dropout, h.shape)
                h = jnp.where(keep, h / (1.0 - self.dropout), 0.0)
            x = h
            norm = jnp.sqrt(jnp.maximum(l2sq(h, axis=1), 1e-24))[:, None]
            outs.append(h / norm)
        return jnp.concatenate(outs, axis=1)

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
