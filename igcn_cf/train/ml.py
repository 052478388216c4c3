"""MLTrainer — MultiVAE multinomial-likelihood training.

Behavior of the reference MLTrainer (reference trainer.py:369-401): iterate
shuffled user-id batches (not interaction triples); loss is the multinomial
log-likelihood -sum(profile * log_softmax(scores)) plus KL annealed as
min(kl_reg, epoch / n_epochs) and the weight-matrix L2 term.

Design: the shuffled user stream is a device permutation; the binary
profile targets are scattered per batch from the padded item buffer (the
reference slices scipy rows and densifies on host per batch,
trainer.py:390-392)."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax

from igcn_cf.core.registry import TRAINERS
from igcn_cf.train.trainer import BasicTrainer


@TRAINERS.register("MLTrainer")
class MLTrainer(BasicTrainer):
    def __init__(self, config, dataset, model):
        super().__init__(config, dataset, model)
        self.l2_reg = config["l2_reg"]
        self.kl_reg = config["kl_reg"]

    def steps_per_epoch(self) -> int:
        return max(1, -(-self.dataset.n_users // self.batch_size))

    def _binary_profiles(self, buffers, users):
        """Unnormalized binary target rows (reference trainer.py:375-376)."""
        rows = buffers["profile_items"][users]
        vals = jnp.where(rows < self.model.n_profile_items, 1.0, 0.0)
        b = rows.shape[0]
        out = jnp.zeros((b, self.model.n_profile_items + 1), jnp.float32)
        out = out.at[jnp.arange(b)[:, None], rows].add(vals, mode="drop")
        return out[:, : self.model.n_profile_items]

    def _loss(self, params, buffers, users, key, kl_reg):
        scores, kl, l2 = self.model.ml_forward(
            params, buffers, users, train=True, key=key
        )
        log_probs = jax.nn.log_softmax(scores, axis=1)
        profiles = self._binary_profiles(buffers, users)
        ml_loss = -jnp.sum(profiles * log_probs, axis=1).mean()
        return ml_loss + kl_reg * kl.mean() + self.l2_reg * jnp.mean(l2)

    def _build_epoch_fn(self):
        opt = self.opt
        n_users = self.dataset.n_users
        batch = self.batch_size
        n_steps = self.steps_per_epoch()
        padded = n_steps * batch

        def step(carry, xs):
            params, opt_state, buffers, kl_reg = carry
            users, key = xs
            loss, grads = jax.value_and_grad(self._loss)(
                params, buffers, users, key, kl_reg
            )
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state, buffers, kl_reg), loss

        @partial(jax.jit, donate_argnums=(0, 1))
        def epoch_fn(params, opt_state, buffers, key, kl_reg):
            k_perm, k_steps = jax.random.split(key)
            perm = jax.random.permutation(k_perm, n_users)
            # pad the tail by wrapping — every batch keeps a static shape
            perm = jnp.concatenate([perm, perm[: padded - n_users]])
            users = perm.reshape(n_steps, batch)
            keys = jax.random.split(k_steps, n_steps)
            (params, opt_state, _, _), losses = jax.lax.scan(
                step, (params, opt_state, buffers, kl_reg), (users, keys)
            )
            return params, opt_state, losses.mean()

        return epoch_fn

    def train_one_epoch(self) -> float:
        if self._epoch_fn is None:
            self._epoch_fn = self._build_epoch_fn()
        # KL anneal min(kl_reg, epoch / n_epochs) (reference trainer.py:382)
        kl_reg = min(self.kl_reg, 1.0 * self.epoch / self.n_epochs)
        self.params, self.opt_state, loss = self._epoch_fn(
            self.params, self.opt_state, self.buffers, self.keys.next(),
            jnp.float32(kl_reg),
        )
        return float(loss)
