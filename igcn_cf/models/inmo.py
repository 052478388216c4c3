"""INMO — inductive template aggregation models: IGCN (INMO-LGCN) and IMF
(INMO-MF).

Behavior of the reference IGCN (reference model.py:354-466):

  * embeddings attach to TEMPLATE (core) users/items + 2 shared tokens, not to
    all nodes: the feature matrix ``feat_mat`` has one row per node listing
    its train neighbors in template space plus its role token (reference
    model.py:386-421);
  * layer-0 representation = feat_mat @ E (the inductive aggregation,
    reference model.py:423-432), followed by LightGCN-style K-layer
    propagation with mean over layers (reference model.py:434-446);
  * feat_mat edge weights are ``row_sum[row]^((alpha-1)/2 - 1/2)`` with alpha
    annealed per epoch by delta=0.99 (reference model.py:374-381) — at
    alpha=1 this is rowsum^-0.5, annealing toward rowsum^-1 (a mean);
  * sparse edge dropout on feat_mat during training (reference model.py:435);
  * an extra learned vector ``w`` scores the auxiliary self-enhanced BPR loss
    on raw template embeddings (reference model.py:370, trainer.py:304-311);
  * save/load persists user_map/item_map/alpha and REBUILDS feat_mat from the
    current dataset on load — new users/items get feature rows over the old
    templates with zero new parameters: the inductive mechanism (reference
    model.py:454-466).

Design: the feat-mat pattern (rows/cols) and per-edge row sums are static
buffers; the annealed weights are an elementwise pow fused into the
aggregation SpMM, with alpha a traced scalar — the per-epoch anneal changes no
shapes and triggers no recompile. The aggregation itself is the same
gather/segment-sum SpMM as propagation (gather of template embeddings +
segment-sum per node — BASELINE.json's "gather+segment-sum kernel").

IMF (reference model.py:536-543) is IGCN with the propagation stage skipped.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from igcn_cf.core.registry import MODELS
from igcn_cf.graph.build import build_feat_mat, select_templates, sym_norm_adjacency
from igcn_cf.core.platform import graph_engine, use_pcache
from igcn_cf.kernels.dense_graph import (
    BipartiteDense,
    feat_aggregate,
    sym_norm_propagate_mean,
)
from igcn_cf.kernels.pcache import attach_pcache, cached_prop, graph_fingerprint
from igcn_cf.kernels.sparse import SparseGraph, propagate_mean, spmm
from igcn_cf.models.base import Model, l2sq, normal_init


@MODELS.register("IGCN")
class IGCN(Model):
    supports_pcache = True  # propagation operator fixed across training
    dot_scored = True  # users_rep @ items_rep^T: one-dispatch fused eval

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.n_layers = config["n_layers"]
        self.dropout = config["dropout"]
        self.feature_ratio = config["feature_ratio"]
        self.delta = config.get("delta", 0.99)
        self.ranking_metric = config.get("ranking_metric", "sort")
        self.alpha = 1.0
        self.engine_ab = None  # measured A/B entry, set by init_buffers
        self.backend = graph_engine(
            self.n_users, self.n_items, config.get("graph_backend", "auto")
        )
        self.pcache = (
            self.supports_pcache
            and use_pcache(
                self.n_users, self.n_items, self.n_layers,
                config.get("prop_cache", "auto"),
            )
        )
        self.user_map, self.item_map = select_templates(
            dataset.train_array,
            self.n_users,
            self.n_items,
            self.feature_ratio,
            self.ranking_metric,
        )

    @property
    def n_templates(self) -> int:
        return len(self.user_map) + len(self.item_map) + 2

    def _identity_templates(self) -> bool:
        """True when every user/item is its own template (feature_ratio=1
        keeps identity maps — and dropui rebuilds may ADD non-template nodes,
        so check the maps against the current counts)."""
        return (
            self.feature_ratio >= 1.0  # identity maps by construction
            and len(self.user_map) == self.n_users
            and len(self.item_map) == self.n_items
        )

    def init_params(self, key):
        ke, _ = jax.random.split(key)
        return {
            "embedding": normal_init(ke, (self.n_templates, self.embedding_size)),
            "w": jnp.ones((self.embedding_size,), jnp.float32),
        }

    def init_buffers(self):
        if self.backend == "dense":
            buffers = self._init_buffers_dense()
        else:
            buffers = self._init_buffers_sparse()
        if self.pcache:
            # measured engine choice (kernels/pcache.py): 'auto' keeps the
            # cache only when the cached step beats recompute on the card
            attach_pcache(self, buffers)
        return buffers

    def _init_buffers_sparse(self):
        adj = sym_norm_adjacency(self.dataset.train_array, self.n_users, self.n_items)
        feat = build_feat_mat(
            self.dataset.train_array,
            self.n_users,
            self.n_items,
            self.user_map,
            self.item_map,
        )
        feat_graph = SparseGraph.from_coo(feat.coo)
        # per-edge row sums; padded tail rows get 1.0 so pow() stays finite
        edge_row_sum = np.ones(feat_graph.vals.shape[0], dtype=np.float32)
        edge_row_sum[: feat.coo.nnz] = feat.row_sum[feat.coo.rows]
        # padding entries must contribute 0 regardless of alpha
        edge_live = np.zeros(feat_graph.vals.shape[0], dtype=np.float32)
        edge_live[: feat.coo.nnz] = 1.0
        return {
            "norm_adj": SparseGraph.from_coo(adj),
            "feat_graph": feat_graph,
            "feat_edge_row_sum": jnp.asarray(edge_row_sum),
            "feat_edge_live": jnp.asarray(edge_live),
            "alpha": jnp.float32(self.alpha),
        }

    def _init_buffers_dense(self):
        """Dense-bipartite buffers: one binary matrix pair serves both the
        adjacency and the feat matrix; template selection becomes zero-padded
        embedding scatter (kernels/dense_graph.py docstring)."""
        arr = self.dataset.train_array
        bip = BipartiteDense.build(arr, self.n_users, self.n_items)
        # template membership + scatter indices, ordered by template index
        core_u = np.array(
            sorted(self.user_map, key=self.user_map.get), dtype=np.int32
        )
        core_i = np.array(
            sorted(self.item_map, key=self.item_map.get), dtype=np.int32
        )
        in_u = np.zeros(self.n_users, dtype=np.float32)
        in_u[core_u] = 1.0
        in_i = np.zeros(self.n_items, dtype=np.float32)
        in_i[core_i] = 1.0
        # feat row sums: core train neighbors + the token edge (reference
        # model.py:417-419 row_sum over the binary feat pattern)
        rs_u = np.ones(self.n_users, dtype=np.float32)
        rs_i = np.ones(self.n_items, dtype=np.float32)
        np.add.at(rs_u, arr[:, 0], in_i[arr[:, 1]])
        np.add.at(rs_i, arr[:, 1], in_u[arr[:, 0]])
        buffers = {
            "bip": bip,
            "core_user_ids": jnp.asarray(core_u),
            "core_item_ids": jnp.asarray(core_i),
            "core_user_mask": jnp.asarray(in_u),
            "core_item_mask": jnp.asarray(in_i),
            "feat_rowsum_u": jnp.asarray(rs_u),
            "feat_rowsum_i": jnp.asarray(rs_i),
            "alpha": jnp.float32(self.alpha),
        }
        return buffers

    # -- representation -----------------------------------------------------

    def _feat_vals(self, buffers):
        """Annealed edge weights rowsum^((alpha-1)/2 - 1/2) (reference
        model.py:374-377), masked on padding."""
        exponent = (buffers["alpha"] - 1.0) / 2.0 - 0.5
        return (
            jnp.power(buffers["feat_edge_row_sum"], exponent)
            * buffers["feat_edge_live"]
        )

    def inductive_rep_layer(self, params, buffers, *, train, key):
        if self.backend == "dense":
            return self._inductive_rep_dense(params, buffers, train=train, key=key)
        g = buffers["feat_graph"].with_vals(self._feat_vals(buffers))
        if train and self.dropout > 0.0:
            keep = jax.random.bernoulli(key, 1.0 - self.dropout, g.vals.shape)
            g = g.with_vals(jnp.where(keep, g.vals / (1.0 - self.dropout), 0.0))
        return spmm(g, params["embedding"])

    def _inductive_rep_dense(self, params, buffers, *, train, key):
        emb = params["embedding"]
        n_cu = len(self.user_map)
        n_ci = len(self.item_map)
        d = self.embedding_size
        # template embeddings expanded into full user/item space (zero rows
        # on non-template nodes) — template selection as embedding padding.
        # feature_ratio=1 with identity maps is a plain slice (backward =
        # pad, free); otherwise a scatter.
        if self._identity_templates():
            e_users_full = emb[:n_cu]
            e_items_full = emb[n_cu : n_cu + n_ci]
        else:
            e_users_full = jnp.zeros((self.n_users, d), emb.dtype).at[
                buffers["core_user_ids"]
            ].set(emb[:n_cu])
            e_items_full = jnp.zeros((self.n_items, d), emb.dtype).at[
                buffers["core_item_ids"]
            ].set(emb[n_cu : n_cu + n_ci])
        exponent = (buffers["alpha"] - 1.0) / 2.0 - 0.5
        w_u = jnp.power(buffers["feat_rowsum_u"], exponent)
        w_i = jnp.power(buffers["feat_rowsum_i"], exponent)
        dropout = self.dropout if train else 0.0
        return feat_aggregate(
            buffers["bip"],
            e_items_full,
            e_users_full,
            emb[n_cu + n_ci],
            emb[n_cu + n_ci + 1],
            w_u,
            w_i,
            dropout=dropout,
            key=key if train else None,
        )

    def rep(self, params, buffers, *, train, key):
        x0 = self.inductive_rep_layer(params, buffers, train=train, key=key)
        if self.backend == "dense":
            return sym_norm_propagate_mean(buffers["bip"], x0, self.n_layers)
        return propagate_mean(buffers["norm_adj"], x0, self.n_layers)

    def bpr_pieces(self, params, buffers, users, pos, neg, *, train, key):
        if train and self.pcache:
            # propagation through the cached operator: the fused kernel
            # streams the 3·batch rows of P; forward and backward ride the
            # same row stream (kernels/pcache.py). X0
            # (the dropped inductive layer) is the only full-graph compute
            # left in the step.
            x0 = self.inductive_rep_layer(params, buffers, train=True, key=key)
            rows = jnp.concatenate(
                [users, self.n_users + pos, self.n_users + neg]
            )
            reps = cached_prop(buffers["pcache"], rows, x0)
            b = users.shape[0]
            u, p, n = reps[:b], reps[b : 2 * b], reps[2 * b :]
        else:
            rep = self.rep(params, buffers, train=train, key=key)
            u = rep[users]
            p = rep[self.n_users + pos]
            n = rep[self.n_users + neg]
        # L2 on propagated reps — IGCN borrows NGCF.bpr_forward (reference
        # model.py:448-449 -> 293-299)
        l2 = l2sq(u, axis=1) + l2sq(p, axis=1) + l2sq(n, axis=1)
        return u, p, n, l2

    def aux_scores(self, params, users, pos, neg):
        """Self-enhanced aux loss pieces on raw template embeddings scored by
        ``w`` (reference trainer.py:304-311). users/pos/neg are template-space
        ids."""
        emb = params["embedding"]
        n_core_users = len(self.user_map)
        u = emb[users]
        p = emb[pos + n_core_users]
        n = emb[neg + n_core_users]
        w = params["w"][None, :]
        return jnp.sum(u * p * w, axis=1), jnp.sum(u * n * w, axis=1)

    def epoch_update(self, buffers):
        """Per-epoch anneal alpha <- alpha * delta (reference
        model.py:379-381); pure buffer update, no recompile."""
        self.alpha *= self.delta
        return dict(buffers, alpha=jnp.float32(self.alpha))

    def make_predict_fn(self, params, buffers):
        return self._dot_predict_fn(params, buffers)

    def make_recommend_fn(self, params, buffers):
        return self._dot_recommend_fn(params, buffers)

    # -- inductive contract -------------------------------------------------

    def rebuild_for(self, new_dataset):
        """dropit/dropui recipe: keep user_map/item_map (and parameters),
        rebuild norm_adj + feat_mat from the new dataset (reference
        run/dropui/igcn_dropui.py:29-35, run/dropit/igcn_dropit.py:33-37).
        New users/items get feat rows over the OLD templates."""
        self.dataset = new_dataset
        self.n_users = new_dataset.n_users
        self.n_items = new_dataset.n_items
        self.backend = graph_engine(
            self.n_users, self.n_items, self.config.get("graph_backend", "auto")
        )
        # the propagation cache is train-only; the inductive flows only
        # evaluate after a rebuild (reference run/drop*/: eval protocols),
        # and rebuilding a multi-GB P while the trainer still references the
        # old one doubles its memory. Re-create the model to train on the
        # rebuilt dataset instead.
        self.pcache = False
        self._jit_cache.clear()
        return self.init_buffers()

    def extra_state(self):
        return {
            "user_map": self.user_map,
            "item_map": self.item_map,
            "alpha": self.alpha,
        }

    def load_extra_state(self, state):
        """Load-then-rebuild-feat semantics (reference model.py:459-466): the
        caller's current ``self.dataset`` provides the interactions; the
        saved template maps define the embedding rows."""
        self.user_map = state["user_map"]
        self.item_map = state["item_map"]
        self.alpha = state["alpha"]

    def refresh_buffers(self, buffers):
        """After load(), feat_mat/norm_adj must reflect the CURRENT dataset
        with the loaded template maps and alpha (reference model.py:465-466).

        The propagation cache is reused when the interaction graph is
        unchanged: P depends only on the edges and K, and rebuilding it would
        allocate a second multi-GB buffer next to the live one (the
        end-of-training best-checkpoint reload). The guard compares a
        fingerprint of the edges the cache was built from with the current
        dataset's; any mismatch falls through to a full rebuild."""
        old_p = buffers.get("pcache") if isinstance(buffers, dict) else None
        if (
            old_p is not None
            and self.pcache
            and getattr(self, "pcache_fingerprint", None)
            == graph_fingerprint(self.dataset.train_array)
        ):
            self.pcache = False  # skip the build inside init_buffers
            try:
                new = self.init_buffers()
            finally:
                self.pcache = True
            new["pcache"] = old_p
            return new
        return self.init_buffers()


@MODELS.register("IMF")
class IMF(IGCN):
    """INMO-MF: representation is the inductive layer only, no propagation
    (reference model.py:536-543) — so there is no operator to cache."""

    supports_pcache = False

    def rep(self, params, buffers, *, train, key):
        return self.inductive_rep_layer(params, buffers, train=train, key=key)
