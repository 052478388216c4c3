"""LightGCN.

Behavior of the reference LightGCN (reference model.py:75-123): one
(n_users+n_items, d) table, symmetric-normalized adjacency, K SpMM rounds with
mean over layers 0..K; BPR L2 penalizes the ego (layer-0) embeddings while
scores use the propagated representations; predict is users_rep @ items_repᵀ.

Design: the adjacency lives as a static row-sorted SparseGraph buffer;
propagation is the fused gather/segment-sum SpMM (kernels/sparse.py), all
under one jit per train step, with the eval representation computed once and
cached (exact — no dropout in this model)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from igcn_cf.core.registry import MODELS
from igcn_cf.graph.build import sym_norm_adjacency
from igcn_cf.core.platform import graph_engine, use_pcache
from igcn_cf.kernels.dense_graph import BipartiteDense, sym_norm_propagate_mean
from igcn_cf.kernels.pcache import attach_pcache, cached_prop
from igcn_cf.kernels.sparse import SparseGraph, propagate_mean
from igcn_cf.models.base import Model, l2sq, normal_init


@MODELS.register("LightGCN")
class LightGCN(Model):
    dot_scored = True  # users_rep @ items_rep^T: one-dispatch fused eval

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.n_layers = config["n_layers"]
        self.backend = graph_engine(
            self.n_users, self.n_items, config.get("graph_backend", "auto")
        )
        # LightGCN has no dropout at all (reference model.py:95-106), so the
        # whole propagated representation of a train batch is a cached-P row
        # gather times the embedding table (kernels/pcache.py).
        self.pcache = use_pcache(
            self.n_users, self.n_items, self.n_layers,
            config.get("prop_cache", "auto"),
        )
        self.engine_ab = None  # measured A/B entry, set by init_buffers

    def init_params(self, key):
        return {
            "embedding": normal_init(
                key, (self.n_users + self.n_items, self.embedding_size)
            )
        }

    def init_buffers(self):
        if self.backend == "dense":
            buffers = {
                "bip": BipartiteDense.build(
                    self.dataset.train_array, self.n_users, self.n_items,
                )
            }
        else:
            coo = sym_norm_adjacency(
                self.dataset.train_array, self.n_users, self.n_items
            )
            buffers = {"norm_adj": SparseGraph.from_coo(coo)}
        if self.pcache:
            attach_pcache(self, buffers)
        return buffers

    def rep(self, params, buffers, *, train, key):
        if self.backend == "dense":
            return sym_norm_propagate_mean(
                buffers["bip"], params["embedding"], self.n_layers
            )
        return propagate_mean(buffers["norm_adj"], params["embedding"], self.n_layers)

    def bpr_pieces(self, params, buffers, users, pos, neg, *, train, key):
        emb = params["embedding"]
        if train and self.pcache:
            rows = jnp.concatenate([users, self.n_users + pos, self.n_users + neg])
            reps = cached_prop(buffers["pcache"], rows, emb)
            b = users.shape[0]
            u, p, n = reps[:b], reps[b : 2 * b], reps[2 * b :]
        else:
            rep = self.rep(params, buffers, train=train, key=key)
            u = rep[users]
            p = rep[self.n_users + pos]
            n = rep[self.n_users + neg]
        # L2 on ego embeddings, scores on propagated reps (model.py:108-116)
        l2 = (
            l2sq(emb[users], axis=1)
            + l2sq(emb[self.n_users + pos], axis=1)
            + l2sq(emb[self.n_users + neg], axis=1)
        )
        return u, p, n, l2

    def make_predict_fn(self, params, buffers):
        return self._dot_predict_fn(params, buffers)

    def make_recommend_fn(self, params, buffers):
        return self._dot_recommend_fn(params, buffers)

    def rebuild_for(self, new_dataset):
        """dropit recipe: rebuild norm_adj only (reference
        run/dropit/lgcn_dropit.py:33-35). The propagation cache is
        train-only and the flows only evaluate after a rebuild; skipping it
        avoids holding two multi-GB caches (see IGCN.rebuild_for)."""
        self.backend = graph_engine(
            new_dataset.n_users,
            new_dataset.n_items,
            self.config.get("graph_backend", "auto"),
        )
        self.pcache = False
        return super().rebuild_for(new_dataset)

    def grow_params(self, params, old_n_users, old_n_items):
        """dropui recipe: grow the table to the new node count; new rows get
        the MEAN of the old embeddings, old user/item rows are copied into
        their shifted slots (reference run/dropui/lgcn_dropui.py:31-38).
        Call after rebuild_for (self.n_users/n_items already new)."""
        old = params["embedding"]
        mean = jnp.mean(old, axis=0)
        new = jnp.broadcast_to(
            mean[None, :], (self.n_users + self.n_items, self.embedding_size)
        )
        new = new.at[:old_n_users].set(old[:old_n_users])
        new = new.at[self.n_users : self.n_users + old_n_items].set(
            old[old_n_users:]
        )
        return {"embedding": new}
