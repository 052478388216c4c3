"""BPR-family trainers: BPRTrainer, IGCNTrainer, IDCFTrainer.

Loss semantics match the reference exactly:

  * BPR: softplus(neg_score - pos_score).mean() + l2_reg * l2_norm_sq.mean()
    (reference trainer.py:231-248);
  * IGCN adds the auxiliary self-enhanced BPR on raw template embeddings
    scored with w, weighted by aux_reg, and anneals the feat-mat each epoch
    (reference trainer.py:294-320);
  * IDCF adds contrastive_reg * contrastive_loss.mean() (reference
    trainer.py:261-278).

Design: an epoch is one jitted lax.scan over steps; each step samples its
batch on device, runs the model forward (full-graph propagation included),
computes grads and applies the optimizer update. Params/opt state are donated,
so the tables update in place in device memory."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax

from igcn_cf.core.registry import TRAINERS
from igcn_cf.data.sampler import DeviceNegativeSampler
from igcn_cf.data.transforms import auxiliary_interactions
from igcn_cf.train.trainer import BasicTrainer


class _ScanEpochTrainer(BasicTrainer):
    """Shared scan-epoch machinery; subclasses define ``_loss(params,
    buffers, samplers, keys_batch, key_dropout)`` returning a scalar.

    Samplers and buffers travel as explicit jit arguments — closure-capturing
    them would embed multi-GB device arrays as constants in the compiled
    program."""

    def _samplers(self):
        return {"main": self.sampler}

    def _loss(self, params, buffers, samplers, k_batch, k_drop):
        raise NotImplementedError

    def _build_epoch_fn(self):
        opt = self.opt
        n_steps = self.steps_per_epoch()

        def step(carry, key):
            params, opt_state, buffers, samplers = carry
            k_batch, k_drop = jax.random.split(key)
            loss, grads = jax.value_and_grad(self._loss)(
                params, buffers, samplers, k_batch, k_drop
            )
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state, buffers, samplers), loss

        @partial(jax.jit, donate_argnums=(0, 1))
        def epoch_fn(params, opt_state, buffers, samplers, key):
            keys = jax.random.split(key, n_steps)
            (params, opt_state, _, _), losses = jax.lax.scan(
                step, (params, opt_state, buffers, samplers), keys
            )
            return params, opt_state, losses

        return epoch_fn

    def train_one_epoch(self) -> float:
        if self._epoch_fn is None:
            self._epoch_fn = self._build_epoch_fn()
        self.params, self.opt_state, losses = self._epoch_fn(
            self.params, self.opt_state, self.buffers, self._samplers(),
            self.keys.next(),
        )
        self.buffers = self.model.epoch_update(self.buffers)
        # per-step losses of the last epoch, kept on the device
        self.last_step_losses = losses
        return float(losses.mean())


def bpr_loss_terms(model, params, buffers, users, pos, neg, k_drop):
    u_r, p_r, n_r, l2 = model.bpr_pieces(
        params, buffers, users, pos, neg, train=True, key=k_drop
    )
    pos_scores = jnp.sum(u_r * p_r, axis=1)
    neg_scores = jnp.sum(u_r * n_r, axis=1)
    bpr = jnp.mean(jax.nn.softplus(neg_scores - pos_scores))
    return bpr, l2


@TRAINERS.register("BPRTrainer")
class BPRTrainer(_ScanEpochTrainer):
    def __init__(self, config, dataset, model):
        super().__init__(config, dataset, model)
        self.l2_reg = config["l2_reg"]

    def _loss(self, params, buffers, samplers, k_batch, k_drop):
        users, pos, negs = samplers["main"].sample(k_batch, self.batch_size)
        bpr, l2 = bpr_loss_terms(
            self.model, params, buffers, users, pos, negs[:, 0], k_drop
        )
        return bpr + self.l2_reg * jnp.mean(l2)


@TRAINERS.register("IGCNTrainer")
class IGCNTrainer(_ScanEpochTrainer):
    def __init__(self, config, dataset, model):
        super().__init__(config, dataset, model)
        self.l2_reg = config["l2_reg"]
        self.aux_reg = config["aux_reg"]
        aux_ds = auxiliary_interactions(dataset, model.user_map, model.item_map)
        self.aux_sampler = DeviceNegativeSampler.build(aux_ds)
        bip = self.buffers.get("bip")
        if bip is not None and model._identity_templates():
            # template space == full id space: the dense matrix answers aux
            # membership too
            self.aux_sampler = self.aux_sampler.with_dense_b(bip.B)

    def _samplers(self):
        return {"main": self.sampler, "aux": self.aux_sampler}

    def _loss(self, params, buffers, samplers, k_batch, k_drop):
        k_main, k_aux = jax.random.split(k_batch)
        users, pos, negs = samplers["main"].sample(k_main, self.batch_size)
        bpr, l2 = bpr_loss_terms(
            self.model, params, buffers, users, pos, negs[:, 0], k_drop
        )
        a_users, a_pos, a_negs = samplers["aux"].sample(k_aux, self.batch_size)
        aux_pos, aux_neg = self.model.aux_scores(params, a_users, a_pos, a_negs[:, 0])
        aux_loss = jnp.mean(jax.nn.softplus(aux_neg - aux_pos))
        # reference folds aux into the "reg" term (trainer.py:313)
        return bpr + self.l2_reg * jnp.mean(l2) + self.aux_reg * aux_loss


@TRAINERS.register("IDCFTrainer")
class IDCFTrainer(_ScanEpochTrainer):
    def __init__(self, config, dataset, model):
        super().__init__(config, dataset, model)
        self.l2_reg = config["l2_reg"]
        self.contrastive_reg = config["contrastive_reg"]

    def _loss(self, params, buffers, samplers, k_batch, k_drop):
        users, pos, negs = samplers["main"].sample(k_batch, self.batch_size)
        neg = negs[:, 0]
        u_r, p_r, n_r, l2, contrastive = self.model.bpr_pieces_contrastive(
            params, buffers, users, pos, neg, train=True, key=k_drop
        )
        pos_scores = jnp.sum(u_r * p_r, axis=1)
        neg_scores = jnp.sum(u_r * n_r, axis=1)
        bpr = jnp.mean(jax.nn.softplus(neg_scores - pos_scores))
        return (
            bpr
            + self.l2_reg * jnp.mean(l2)
            + self.contrastive_reg * jnp.mean(contrastive)
        )
