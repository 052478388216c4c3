"""BCETrainer — NeuMF staged training.

Behavior of the reference BCETrainer (reference trainer.py:323-366): epoch
thresholds switch arch gmf -> mlp -> neumf; each switch re-initializes the
optimizer, resets best NDCG, reloads the stage's best checkpoint (and at the
neumf switch re-initializes the MLP tower + output weight — reference
trainer.py:340-345). Loss is BCE via softplus: softplus(-logit) on the
positive and softplus(logit) on each of the ``neg_ratio`` negatives, averaged
over the concatenation (reference trainer.py:346-366)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from igcn_cf.core.registry import TRAINERS
from igcn_cf.train.bpr import _ScanEpochTrainer


@TRAINERS.register("BCETrainer")
class BCETrainer(_ScanEpochTrainer):
    def __init__(self, config, dataset, model):
        super().__init__(config, dataset, model)
        self.l2_reg = config["l2_reg"]
        self.mf_pretrain_epochs = config["mf_pretrain_epochs"]
        self.mlp_pretrain_epochs = config["mlp_pretrain_epochs"]
        self.neg_ratio = dataset.neg_ratio

    def _loss(self, params, buffers, samplers, k_batch, k_drop):
        users, pos, negs = samplers["main"].sample(
            k_batch, self.batch_size, neg_ratio=self.neg_ratio
        )
        pos_logits, l2_p = self.model.bce_forward(params, users, pos)
        bce_p = jax.nn.softplus(-pos_logits)
        users_rep = jnp.repeat(users, self.neg_ratio)
        neg_logits, l2_n = self.model.bce_forward(params, users_rep, negs.reshape(-1))
        bce_n = jax.nn.softplus(neg_logits)
        bce = jnp.mean(jnp.concatenate([bce_p, bce_n]))
        l2 = jnp.mean(jnp.concatenate([l2_p, l2_n]))
        return bce + self.l2_reg * l2

    def train_one_epoch(self) -> float:
        """Stage switching (reference trainer.py:334-345). arch is a
        trace-time constant, so each switch invalidates the epoch fn (two
        recompiles per run)."""
        if self.epoch == self.mf_pretrain_epochs:
            self.model.arch = "mlp"
            self.initialize_optimizer()
            self.best_ndcg = -np.inf
            self.params = self.model.load(self.save_path)
            self.opt_state = self.opt.init(self.params)
            self._epoch_fn = None
        if self.epoch == self.mf_pretrain_epochs + self.mlp_pretrain_epochs:
            self.model.arch = "neumf"
            self.initialize_optimizer()
            self.best_ndcg = -np.inf
            self.params = self.model.load(self.save_path)
            self.params.update(self.model.init_mlp_layers(self.keys.next()))
            self.opt_state = self.opt.init(self.params)
            self._epoch_fn = None
        return super().train_one_epoch()
