"""MultiVAE — variational autoencoder over user profiles.

Behavior of the reference MultiVAE (reference model.py:594-654): input is the
L2-normalized binary profile row of each user; sparse-entry dropout on the
profile; encoder MLP (tanh between layers) to (mean, logvar); KL term
``sum(-logvar + exp(logvar) + mean^2)`` (reference keeps this exact form,
model.py:638); reparameterized sample during training; decoder MLP (tanh
between layers) to item logits. The L2 term accumulates squared Frobenius
norms of every layer weight. ``predict`` pads with -inf when the model was
trained on fewer items than the eval catalog (the dropui recipe, reference
model.py:649-654, run/dropui/vae_dropui.py:31-33).

Design: profile rows are materialized per batch by scattering
``1/sqrt(deg)`` into a dense (B, n_items) block from a padded per-user item
buffer — the first encoder matmul then runs dense on the device; no host sparse
slicing per batch (reference model.py:624-629 does scipy slicing + H2D per
batch)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from igcn_cf.core.registry import MODELS
from igcn_cf.models.base import Model, linear_apply, linear_init

# frobenius^2 of a weight matrix
def _fro2(w):
    return jnp.sum(w * w)


@MODELS.register("MultiVAE")
class MultiVAE(Model):
    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.dropout = config["dropout"]
        # reference model.py:600-604: e_sizes = [n_in] + layer_sizes with the
        # last doubled for (mean, logvar); d_sizes is the reverse
        self.n_profile_items = dataset.n_items  # input width at TRAIN time
        sizes = list(config["layer_sizes"])
        self.mid_size = sizes[-1]
        self.e_sizes = [self.n_profile_items] + sizes[:-1] + [2 * self.mid_size]
        self.d_sizes = [self.mid_size] + sizes[:-1][::-1] + [self.n_profile_items]

    def init_params(self, key):
        n_e = len(self.e_sizes) - 1
        n_d = len(self.d_sizes) - 1
        keys = jax.random.split(key, n_e + n_d)
        enc = [
            linear_init(keys[i], self.e_sizes[i], self.e_sizes[i + 1])
            for i in range(n_e)
        ]
        dec = [
            linear_init(keys[n_e + i], self.d_sizes[i], self.d_sizes[i + 1])
            for i in range(n_d)
        ]
        return {"encoder": enc, "decoder": dec}

    def init_buffers(self):
        n_users = self.n_users
        degs = np.array(
            [len(self.dataset.train[u]) for u in range(n_users)], dtype=np.int32
        )
        max_deg = max(1, int(degs.max()) if n_users else 1)
        items = np.full((n_users, max_deg), self.n_profile_items, dtype=np.int32)
        for u in range(n_users):
            row = np.asarray(self.dataset.train[u], dtype=np.int32)
            # dropui eval: catalog may exceed the trained profile width; rows
            # outside the trained width are dropped from the profile
            # (reference run/dropui/vae_dropui.py:31-33 truncates columns)
            row = row[row < self.n_profile_items]
            items[u, : len(row)] = row
        return {
            "profile_items": jnp.asarray(items),
            "profile_deg": jnp.asarray(np.maximum(degs, 1).astype(np.float32)),
        }

    def _profiles(self, buffers, users, *, train, key):
        """Dense L2-normalized profile rows with sparse-entry dropout."""
        rows = buffers["profile_items"][users]  # (B, W)
        vals = jnp.ones(rows.shape, jnp.float32) / jnp.sqrt(
            buffers["profile_deg"][users]
        )[:, None]
        vals = jnp.where(rows < self.n_profile_items, vals, 0.0)
        if train and self.dropout > 0.0:
            keep = jax.random.bernoulli(key, 1.0 - self.dropout, vals.shape)
            vals = jnp.where(keep, vals / (1.0 - self.dropout), 0.0)
        b = rows.shape[0]
        out = jnp.zeros((b, self.n_profile_items + 1), jnp.float32)
        out = out.at[jnp.arange(b)[:, None], rows].add(vals, mode="drop")
        return out[:, : self.n_profile_items]

    def ml_forward(self, params, buffers, users, *, train, key):
        k_drop, k_eps = (
            jax.random.split(key) if key is not None else (None, None)
        )
        x = self._profiles(buffers, users, train=train, key=k_drop)
        l2 = _fro2(params["encoder"][0]["w"])
        h = linear_apply(params["encoder"][0], x)
        for layer in params["encoder"][1:]:
            h = linear_apply(layer, jnp.tanh(h))
            l2 = l2 + _fro2(layer["w"])
        mean, log_var = h[:, : self.mid_size], h[:, -self.mid_size :]
        kl = jnp.sum(-log_var + jnp.exp(log_var) + mean**2, axis=1)
        if train:
            eps = jax.random.normal(k_eps, mean.shape)
            z = mean + eps * jnp.exp(0.5 * log_var)
        else:
            z = mean
        for layer in params["decoder"][:-1]:
            z = jnp.tanh(linear_apply(layer, z))
            l2 = l2 + _fro2(layer["w"])
        scores = linear_apply(params["decoder"][-1], z)
        l2 = l2 + _fro2(params["decoder"][-1]["w"])
        return scores, kl, l2

    def make_predict_fn(self, params, buffers):
        n_items = self.n_items
        n_profile = self.n_profile_items

        def make():
            def predict(params, buffers, users):
                scores, _, _ = self.ml_forward(
                    params, buffers, users, train=False, key=None
                )
                if n_profile < n_items:
                    pad = jnp.full(
                        (scores.shape[0], n_items - n_profile), -jnp.inf, scores.dtype
                    )
                    scores = jnp.concatenate([scores, pad], axis=1)
                return scores

            return predict

        fn = self._get_jit(f"predict_{n_items}", make)
        return lambda users: fn(params, buffers, users)

    def make_recommend_fn(self, params, buffers):
        n_items = self.n_items
        n_profile = self.n_profile_items

        def core(params, buffers, users):
            scores, _, _ = self.ml_forward(
                params, buffers, users, train=False, key=None
            )
            if n_profile < n_items:
                pad = jnp.full(
                    (scores.shape[0], n_items - n_profile), -jnp.inf,
                    scores.dtype,
                )
                scores = jnp.concatenate([scores, pad], axis=1)
            return scores

        return self._traced_scan_recommend_fn(
            params, buffers, core, f"recscan_{n_items}"
        )

    def rebuild_for(self, new_dataset):
        """dropit: re-derive profiles from new interactions (reference
        run/dropit/vae_dropit.py:33-35). dropui: keep the trained profile
        width (n_profile_items) and let predict pad new items with -inf
        (reference run/dropui/vae_dropui.py:31-33)."""
        self.dataset = new_dataset
        self.n_users = new_dataset.n_users
        self.n_items = new_dataset.n_items
        return self.init_buffers()
