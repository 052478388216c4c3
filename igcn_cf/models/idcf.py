"""IDCF-LGCN — inductive baseline with relation attention over key users.

Behavior of the reference IDCF_LGCN (reference model.py:126-230):

  * a FROZEN pretrained LightGCN embedding table loaded from ``lgcn_path``
    (reference model.py:152-155) — held in buffers here, not params, so the
    optimizer never touches it;
  * query representation x_q = feat_mat @ emb where feat_mat is the bipartite
    adjacency restricted to old-user/old-item columns (reference
    model.py:168-181);
  * ``n_headers`` RelationGAT heads: each samples ``n_samples`` random old
    users/items as keys and attends x_q over their frozen embeddings
    (reference model.py:126-139,183-191); heads concat through w_out;
  * optional contrastive loss logsumexp(sim to sampled keys) - self-sim,
    using the LAST head's samples (reference model.py:193-202 — the loop
    variable reuse is reference behavior, kept);
  * LightGCN-style propagation with layer mean afterwards (model.py:204-214);
  * BPR L2 adds the wq/wk Frobenius norms of every head (model.py:224-226).

Key sampling uses the jitted step's PRNG key (the reference draws from host
numpy per forward, model.py:184-185 — same distribution); eval uses a fixed
key so evaluation is deterministic."""

from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np

from igcn_cf.core.registry import MODELS
from igcn_cf.graph.build import COO, bipartite_adjacency, sym_norm_adjacency
from igcn_cf.kernels.sparse import SparseGraph, propagate_mean, spmm
from igcn_cf.models.base import Model, l2sq, linear_apply, linear_init


@MODELS.register("IDCF_LGCN")
class IDCF_LGCN(Model):
    dot_scored = True  # users_rep @ items_rep^T: one-dispatch fused eval

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.n_layers = config["n_layers"]
        self.n_headers = config["n_headers"]
        self.n_samples = config.get("n_samples", 50)
        self.lgcn_path = config["lgcn_path"]
        self.n_old_users = self.n_users
        self.n_old_items = self.n_items

    def init_params(self, key):
        keys = jax.random.split(key, 3 * self.n_headers + 1)
        heads = []
        d = self.embedding_size
        for h in range(self.n_headers):
            heads.append(
                {
                    "wq": linear_init(keys[3 * h], d, d),
                    "wk": linear_init(keys[3 * h + 1], d, d),
                    "wv": linear_init(keys[3 * h + 2], d, d),
                }
            )
        return {
            "heads": heads,
            "w_out": linear_init(keys[-1], d * self.n_headers, d),
        }

    def _load_frozen_embedding(self) -> jnp.ndarray:
        if not os.path.exists(self.lgcn_path):
            self._pretrain_lgcn()
        with open(self.lgcn_path, "rb") as f:
            blob = pickle.load(f)
        return jnp.asarray(blob["params"]["embedding"])

    def _pretrain_lgcn(self) -> None:
        """The reference assumes a pretrained LightGCN table exists at
        ``lgcn_path`` (reference config.py:59, model.py:152-155) and crashes
        otherwise. Here a missing checkpoint auto-trains one on the current
        dataset (BPR, early-stopped), so ``run --config 8`` works on a clean
        checkout. Override the budget with ``lgcn_pretrain_epochs`` /
        ``lgcn_pretrain_patience``."""
        import sys

        from igcn_cf.models.base import get_model
        from igcn_cf.train.trainer import get_trainer

        print(
            f"[idcf] no LightGCN checkpoint at {self.lgcn_path!r}; "
            "pretraining one (reference expects run --config 1 output)",
            file=sys.stderr,
            flush=True,
        )
        mc = {
            "name": "LightGCN",
            "embedding_size": self.embedding_size,
            "n_layers": self.n_layers,
        }
        tc = {
            "name": "BPRTrainer",
            "optimizer": "Adam",
            "lr": 1e-3,
            "l2_reg": 1e-4,
            "n_epochs": int(self.config.get("lgcn_pretrain_epochs", 200)),
            "batch_size": int(self.config.get("batch_size", 2048)),
            "test_batch_size": 512,
            "topks": [20],
            "val_interval": int(self.config.get("lgcn_pretrain_val_interval", 10)),
            "max_patience": int(self.config.get("lgcn_pretrain_patience", 5)),
        }
        lgcn = get_model(mc, self.dataset)
        trainer = get_trainer(tc, self.dataset, lgcn)
        trainer.train(verbose=False)
        lgcn.save(self.lgcn_path, trainer.params)

    def init_buffers(self):
        adj = sym_norm_adjacency(self.dataset.train_array, self.n_users, self.n_items)
        feat = self._generate_feat()
        return {
            "norm_adj": SparseGraph.from_coo(adj),
            "feat": SparseGraph.from_coo(feat),
            "embedding": self._load_frozen_embedding(),
        }

    def _generate_feat(self) -> COO:
        """Adjacency columns restricted to old users / old items (reference
        model.py:168-172): column u stays at u for u < n_old_users; column
        n_users + i maps to n_old_users + i for i < n_old_items."""
        adj = bipartite_adjacency(self.dataset.train_array, self.n_users, self.n_items)
        cols = adj.cols
        keep_user = cols < self.n_old_users
        item_col = (cols >= self.n_users) & (cols < self.n_users + self.n_old_items)
        keep = keep_user | item_col
        new_cols = np.where(
            keep_user, cols, self.n_old_users + (cols - self.n_users)
        ).astype(np.int32)
        return COO(
            adj.rows[keep],
            new_cols[keep],
            adj.vals[keep],
            (self.n_users + self.n_items, self.n_old_users + self.n_old_items),
        ).sort_by_row()

    # -- attention ----------------------------------------------------------

    def _gat_head(self, head, x, neighbors):
        """RelationGAT (reference model.py:126-139): softmax over sampled
        keys, value-projected mixture."""
        q = linear_apply(head["wq"], x)  # (N, d)
        k = linear_apply(head["wk"], neighbors)  # (S, d)
        logits = q @ k.T  # (N, S)
        attn = jax.nn.softmax(logits, axis=1)
        return linear_apply(head["wv"], attn @ neighbors)

    def _rep_and_contrastive(self, params, buffers, key, want_contrastive):
        emb = buffers["embedding"]
        x_q = spmm(buffers["feat"], emb)
        outs = []
        sampled_user_embs = sampled_item_embs = None
        for h in range(self.n_headers):
            key, ku, ki = jax.random.split(key, 3)
            su = jax.random.randint(ku, (self.n_samples,), 0, self.n_old_users)
            si = jax.random.randint(ki, (self.n_samples,), 0, self.n_old_items)
            sampled_user_embs = emb[su]
            sampled_item_embs = emb[self.n_old_users + si]
            head = params["heads"][h]
            user_reps = self._gat_head(head, x_q[: self.n_users], sampled_user_embs)
            item_reps = self._gat_head(head, x_q[self.n_users :], sampled_item_embs)
            outs.append(jnp.concatenate([user_reps, item_reps], axis=0))
        representations = linear_apply(params["w_out"], jnp.concatenate(outs, axis=1))

        contrastive = None
        if want_contrastive:
            u_rep = representations[: self.n_users]
            i_rep = representations[self.n_users :]
            u_sim = u_rep @ sampled_user_embs.T
            u_self = jnp.sum(u_rep * emb[: self.n_old_users], axis=1)
            u_loss = jax.nn.logsumexp(u_sim, axis=1) - u_self
            i_sim = i_rep @ sampled_item_embs.T
            i_self = jnp.sum(i_rep * emb[self.n_old_users :], axis=1)
            i_loss = jax.nn.logsumexp(i_sim, axis=1) - i_self
            contrastive = jnp.concatenate([u_loss, i_loss], axis=0)

        final = propagate_mean(buffers["norm_adj"], representations, self.n_layers)
        return final, contrastive

    def rep(self, params, buffers, *, train, key):
        if key is None:
            key = jax.random.PRNGKey(0)  # deterministic eval sampling
        final, _ = self._rep_and_contrastive(params, buffers, key, False)
        return final

    def bpr_pieces_contrastive(self, params, buffers, users, pos, neg, *, train, key):
        rep, contrastive = self._rep_and_contrastive(params, buffers, key, True)
        c = (
            contrastive[users]
            + contrastive[self.n_users + pos]
            + contrastive[self.n_users + neg]
        )
        u = rep[users]
        p = rep[self.n_users + pos]
        n = rep[self.n_users + neg]
        l2 = l2sq(u, axis=1) + l2sq(p, axis=1) + l2sq(n, axis=1)
        for h in range(self.n_headers):
            l2 = l2 + l2sq(params["heads"][h]["wq"]["w"]) + l2sq(
                params["heads"][h]["wk"]["w"]
            )
        return u, p, n, l2, c

    def make_predict_fn(self, params, buffers):
        return self._dot_predict_fn(params, buffers)

    def make_recommend_fn(self, params, buffers):
        return self._dot_recommend_fn(params, buffers)

    def rebuild_for(self, new_dataset):
        """dropit/dropui recipe: rebuild norm_adj + feat over the grown graph
        while n_old_users/items (and the frozen table) stay fixed (reference
        run/dropit/idcf_dropit.py, run/dropui/idcf_dropui.py)."""
        self.dataset = new_dataset
        self.n_users = new_dataset.n_users
        self.n_items = new_dataset.n_items
        self._jit_cache.clear()
        return self.init_buffers()
