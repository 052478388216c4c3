"""NeuMF — GMF + MLP dual-embedding model with staged pretraining.

Behavior of the reference NeuMF (reference model.py:657-713): four embedding
tables (mf_user/mf_item at d, mlp_user/mlp_item at layer_sizes[0]//2), all
kaiming-uniform; MLP tower with leaky ReLU after every layer; the ``arch``
flag ∈ {gmf, mlp, neumf} zeroes the other tower's vector during staged
pretraining (reference model.py:696-701); the output layer is a bias-free
ones-initialized weight vector multiplied elementwise before the sum, and the
BCE L2 term is the per-row squared norm of that weighted vector (reference
model.py:702-706). ``predict`` scores every (user, item) pair through the
tower (reference model.py:708-713) — vectorized here as a (B, n_items, d)
batch, instead of the reference's flattened repeat."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from igcn_cf.core.registry import MODELS
from igcn_cf.models.base import Model, kaiming_uniform, linear_apply


@MODELS.register("NeuMF")
class NeuMF(Model):
    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.layer_sizes = list(config["layer_sizes"])
        self.arch = "gmf"  # staged by BCETrainer (reference trainer.py:334-345)

    def init_params(self, key):
        keys = jax.random.split(key, 4 + len(self.layer_sizes))
        d = self.embedding_size
        half = self.layer_sizes[0] // 2
        params = {
            "mf_user": kaiming_uniform(keys[0], (self.n_users, d)),
            "mf_item": kaiming_uniform(keys[1], (self.n_items, d)),
            "mlp_user": kaiming_uniform(keys[2], (self.n_users, half)),
            "mlp_item": kaiming_uniform(keys[3], (self.n_items, half)),
        }
        params.update(self.init_mlp_layers(keys[4]))
        return params

    def init_mlp_layers(self, key):
        """kaiming weights + zero bias for the tower, ones output weight
        (reference model.py:681-685)."""
        keys = jax.random.split(key, len(self.layer_sizes))
        mlp = []
        for i in range(1, len(self.layer_sizes)):
            w = kaiming_uniform(
                keys[i], (self.layer_sizes[i], self.layer_sizes[i - 1])
            ).T
            mlp.append({"w": w, "b": jnp.zeros((self.layer_sizes[i],), jnp.float32)})
        out_w = jnp.ones(
            (self.layer_sizes[-1] + self.embedding_size,), jnp.float32
        )
        return {"mlp_layers": mlp, "output_w": out_w}

    def bce_forward(self, params, users, items):
        """users, items: (...,) int32 -> (scores (...,), l2_norm_sq (...,))."""
        mf = params["mf_user"][users] * params["mf_item"][items]
        mlp = jnp.concatenate(
            [params["mlp_user"][users], params["mlp_item"][items]], axis=-1
        )
        for layer in params["mlp_layers"]:
            mlp = jax.nn.leaky_relu(linear_apply(layer, mlp), negative_slope=0.01)
        if self.arch == "gmf":
            vec = jnp.concatenate([mf, jnp.zeros_like(mlp)], axis=-1)
        elif self.arch == "mlp":
            vec = jnp.concatenate([jnp.zeros_like(mf), mlp], axis=-1)
        else:
            vec = jnp.concatenate([mf, mlp], axis=-1)
        weighted = vec * params["output_w"]
        l2 = jnp.sum(weighted * weighted, axis=-1)
        scores = jnp.sum(weighted, axis=-1)
        return scores, l2

    def make_predict_fn(self, params, buffers):
        n_items = self.n_items

        def make():
            def predict(params, users):
                items = jnp.arange(n_items, dtype=jnp.int32)[None, :]
                items = jnp.broadcast_to(items, (users.shape[0], n_items))
                u = jnp.broadcast_to(users[:, None], items.shape)
                scores, _ = self.bce_forward(params, u, items)
                return scores

            return predict

        # arch is a trace-time constant — key the cache on it
        fn = self._get_jit(f"predict_{self.arch}", make)
        return lambda users: fn(params, users)

    def make_recommend_fn(self, params, buffers):
        n_items = self.n_items

        def core(params, buffers, users):
            items = jnp.arange(n_items, dtype=jnp.int32)[None, :]
            items = jnp.broadcast_to(items, (users.shape[0], n_items))
            u = jnp.broadcast_to(users[:, None], items.shape)
            scores, _ = self.bce_forward(params, u, items)
            return scores

        # the brute-force pair scorer makes n_users/64 per-batch dispatches
        # especially costly; the scan folds them into one
        return self._traced_scan_recommend_fn(
            params, buffers, core, f"recscan_{self.arch}"
        )
