"""Matrix Factorization (BPR-MF).

Behavior of the reference MF (reference model.py:52-72): two embedding tables
init normal(std=0.1); BPR pieces are the raw embeddings with per-row squared
L2; predict is the full-catalog matmul U @ Vᵀ."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from igcn_cf.core.registry import MODELS
from igcn_cf.models.base import Model, l2sq, normal_init


@MODELS.register("MF")
class MF(Model):
    dot_scored = True  # users_rep @ items_rep^T: one-dispatch fused eval

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]

    def init_params(self, key):
        ku, ki = jax.random.split(key)
        return {
            "user_embedding": normal_init(ku, (self.n_users, self.embedding_size)),
            "item_embedding": normal_init(ki, (self.n_items, self.embedding_size)),
        }

    def rep(self, params, buffers, *, train, key):
        return jnp.concatenate(
            [params["user_embedding"], params["item_embedding"]], axis=0
        )

    def bpr_pieces(self, params, buffers, users, pos, neg, *, train, key):
        u = params["user_embedding"][users]
        p = params["item_embedding"][pos]
        n = params["item_embedding"][neg]
        l2 = l2sq(u, axis=1) + l2sq(p, axis=1) + l2sq(n, axis=1)
        return u, p, n, l2

    def make_predict_fn(self, params, buffers):
        return self._dot_predict_fn(params, buffers)

    def make_recommend_fn(self, params, buffers):
        return self._dot_recommend_fn(params, buffers)
