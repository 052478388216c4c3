"""Training loop core.

``BasicTrainer`` reproduces the reference control flow exactly (reference
trainer.py:57-107): per-epoch train + train-split metric eval, validation
every ``val_interval`` epochs, best-NDCG@topks[0] checkpointing to
``checkpoints/{model}_{trainer}_{dataset}_{ndcg}.pkl`` with old-best deletion,
early stop after ``max_patience`` non-improving epochs, reload best at the
end. Non-trainable models short-circuit to a single validation eval
(reference trainer.py:58-63).

Design: an epoch is one jitted ``lax.scan`` over train steps — sampling,
forward (full-graph propagation), loss, backward and optimizer update all
fused on device with donated params/opt state. No per-batch host round-trips
(the reference pays a process boundary + H2D per 2048-pair batch, SURVEY.md
§3.5)."""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from igcn_cf.core.prng import KeySeq
from igcn_cf.core.registry import TRAINERS
from igcn_cf.data.sampler import DeviceNegativeSampler
from igcn_cf.evaluation.evaluate import evaluate

OPTIMIZERS = {
    "Adam": optax.adam,
    "SGD": optax.sgd,
}


def get_trainer(config: dict, dataset, model):
    """Factory matching the reference API (reference trainer.py:14-20)."""
    cls = TRAINERS.get(config["name"])
    return cls(config, dataset, model)


@TRAINERS.register("BasicTrainer")
class BasicTrainer:
    def __init__(self, trainer_config: dict, dataset, model):
        self.config = dict(trainer_config)
        self.name = trainer_config["name"]
        self.dataset = dataset
        self.model = model
        self.topks = trainer_config["topks"]
        self.n_epochs = trainer_config["n_epochs"]
        self.max_patience = trainer_config.get("max_patience", 50)
        self.val_interval = trainer_config.get("val_interval", 1)
        self.test_batch_size = trainer_config.get("test_batch_size", 512)
        self.epoch = 0
        self.start_epoch = 0
        self.best_ndcg = -np.inf
        self.save_path: Optional[str] = None
        # full-state checkpointing every N epochs (0 = off). The reference
        # only checkpoints best model weights with no optimizer state or
        # resume (reference trainer.py:92-100, SURVEY.md §5); here the whole
        # training state (params, opt state, epoch, RNG, best metric) is
        # periodically persisted and train() resumes from it.
        self.state_interval = trainer_config.get("state_interval", 0)
        self.state_path = trainer_config.get(
            "state_path", os.path.join("checkpoints", "train_state.pkl")
        )
        self.keys = KeySeq(trainer_config.get("seed", 2021))

        # device state
        self.batch_size = trainer_config.get("batch_size", 2048)
        # the engine A/B must measure at the batch size the trainer will
        # actually run; an explicit
        # prop_cache_ab_batch in the MODEL config still wins
        model.ab_batch = self.batch_size
        self.params = model.init_params(self.keys.next()) if model.trainable else {}
        self.buffers = model.init_buffers()
        self.opt = None
        self.opt_state = None
        if model.trainable and "optimizer" in trainer_config:
            self.initialize_optimizer()
        if model.trainable:
            self.sampler = DeviceNegativeSampler.build(dataset)
            bip = self.buffers.get("bip")
            if bip is not None:
                # dense graph engine active: share its interaction matrix for
                # O(1) negative-membership lookups
                self.sampler = self.sampler.with_dense_b(bip.B)
        self._epoch_fn = None

    # -- optimizer ----------------------------------------------------------

    def initialize_optimizer(self):
        """Resolve optimizer by name (reference trainer.py:43-45) and reset
        its state."""
        self.opt = OPTIMIZERS[self.config["optimizer"]](self.config["lr"])
        self.opt_state = self.opt.init(self.params)
        self._epoch_fn = None  # step closure captures self.opt

    # -- subclass API -------------------------------------------------------

    def steps_per_epoch(self) -> int:
        """ceil(|train_array| / batch_size) batches per epoch, matching the
        reference DataLoader's length over the train-array-sized index space
        (reference dataset.py:116-117, trainer.py:226). All batches are full
        size (sampling is i.i.d.), a documented deviation from the
        reference's smaller final partial batch."""
        return max(1, -(-len(self.dataset) // self.batch_size))

    def train_one_epoch(self) -> float:
        raise NotImplementedError

    # -- evaluation ---------------------------------------------------------

    def eval(self, val_or_test: str, banned_items=None):
        # dot-scored models: the one-dispatch eval (rep + scan of
        # score/mask/top-k + device metrics in one jit)
        eval_fn = self.model.make_eval_fn(self.params, self.buffers)
        if eval_fn is not None:
            from igcn_cf.evaluation.evaluate import evaluate_one_dispatch

            return evaluate_one_dispatch(
                eval_fn, self.dataset, val_or_test, self.topks,
                banned_items=banned_items,
                test_batch_size=self.test_batch_size,
            )
        # then the single-dispatch scan recommender; models without one
        # fall back to the per-batch predict loop
        recommend_fn = self.model.make_recommend_fn(self.params, self.buffers)
        predict_fn = (
            None
            if recommend_fn is not None
            else self.model.make_predict_fn(self.params, self.buffers)
        )
        return evaluate(
            predict_fn,
            self.dataset,
            val_or_test,
            self.topks,
            banned_items=banned_items,
            test_batch_size=self.test_batch_size,
            recommend_fn=recommend_fn,
        )

    def inductive_eval(self, n_old_users: int, n_old_items: int):
        from igcn_cf.evaluation.inductive import inductive_eval

        return inductive_eval(self, n_old_users, n_old_items)

    # -- full-state checkpoint / resume -------------------------------------

    def save_state(self, path: Optional[str] = None) -> str:
        import pickle

        path = path or self.state_path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        state = {
            "params": jax.tree_util.tree_map(np.asarray, self.params),
            "opt_state": jax.tree_util.tree_map(np.asarray, self.opt_state),
            "epoch": self.epoch,
            "best_ndcg": self.best_ndcg,
            "save_path": self.save_path,
            "rng_key": np.asarray(self.keys._key),
            "model_extra": self.model.extra_state(),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)  # atomic: a crash never corrupts the state
        return path

    def load_state(self, path: Optional[str] = None) -> None:
        import pickle

        path = path or self.state_path
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.model.load_extra_state(state["model_extra"])
        self.buffers = self.model.refresh_buffers(self.buffers)
        self.params = jax.tree_util.tree_map(jnp.asarray, state["params"])
        self.opt_state = jax.tree_util.tree_map(
            jnp.asarray, state["opt_state"]
        )
        self.start_epoch = state["epoch"] + 1
        self.best_ndcg = state["best_ndcg"]
        self.save_path = state["save_path"]
        self.keys = KeySeq(jnp.asarray(state["rng_key"]))

    # -- main loop (reference trainer.py:57-107) ----------------------------

    def train(self, verbose: bool = True, writer=None) -> float:
        if not self.model.trainable:
            results, metrics = self.eval("val")
            if verbose:
                print("Validation result. {:s}".format(results))
            return metrics["NDCG"][self.topks[0]]

        os.makedirs("checkpoints", exist_ok=True)
        patience = self.max_patience
        examples_per_epoch = self.steps_per_epoch() * self.batch_size
        for self.epoch in range(self.start_epoch, self.n_epochs):
            start_time = time.time()
            loss = self.train_one_epoch()
            train_time = time.time() - start_time
            # The reference evaluates the train split every epoch
            # (reference trainer.py:71) but only CONSUMES the result through
            # its tensorboard writer (trainer.py:76-78) — the per-epoch print
            # shows loss/time only. Gate the full-catalog eval on having a
            # writer (matching parallel/trainer.py): headless runs skip a
            # per-epoch eval whose result would be discarded.
            metrics = self.eval("train")[1] if writer else None
            consumed = time.time() - start_time
            if verbose:
                print(
                    "Epoch {:d}/{:d}, Loss: {:.6f}, Time: {:.3f}s".format(
                        self.epoch, self.n_epochs, loss, consumed
                    )
                )
            if writer:
                writer.add_scalar(
                    f"{self.model.name}_{self.name}/train_loss", loss, self.epoch
                )
                writer.add_scalar(
                    f"{self.model.name}_{self.name}/examples_per_s",
                    examples_per_epoch / max(train_time, 1e-9),
                    self.epoch,
                )
                writer.record(self.model.name, self.name, "train", metrics, self.epoch)

            if (self.epoch + 1) % self.val_interval != 0:
                if self.state_interval and (self.epoch + 1) % self.state_interval == 0:
                    self.save_state()
                continue

            start_time = time.time()
            results, metrics = self.eval("val")
            consumed = time.time() - start_time
            if verbose:
                print("Validation result. {:s}Time: {:.3f}s".format(results, consumed))
            if writer:
                writer.record(
                    self.model.name, self.name, "validation", metrics, self.epoch
                )

            ndcg = metrics["NDCG"][self.topks[0]]
            early_stop = False
            if ndcg > self.best_ndcg:
                if self.save_path and os.path.exists(self.save_path):
                    os.remove(self.save_path)
                self.save_path = os.path.join(
                    "checkpoints",
                    "{:s}_{:s}_{:s}_{:.3f}.pkl".format(
                        self.model.name, self.name, self.dataset.name, ndcg * 100
                    ),
                )
                self.best_ndcg = ndcg
                self.model.save(self.save_path, self.params)
                patience = self.max_patience
                print("Best NDCG, save model to {:s}".format(self.save_path))
            else:
                patience -= self.val_interval
                early_stop = patience <= 0
            # full training state AFTER the validation/best-ckpt block, so a
            # resumed run never references a deleted best-model path
            if self.state_interval and (self.epoch + 1) % self.state_interval == 0:
                self.save_state()
            if early_stop:
                print("Early stopping!")
                break
        # a resumed run whose best checkpoint was deleted after
        # the restored state snapshot must not crash on the final reload
        if self.save_path and os.path.exists(self.save_path):
            self.params = self.model.load(self.save_path)
            self.buffers = self.model.refresh_buffers(self.buffers)
        elif self.save_path:
            print(
                "Best checkpoint {:s} missing (deleted after the resumed "
                "state snapshot); keeping in-memory params".format(self.save_path)
            )
        return self.best_ndcg
