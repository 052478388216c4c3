"""Sharded INMO trainer — the reference epoch loop over a multi-chip mesh.

Reproduces ``BasicTrainer``'s control flow (reference trainer.py:57-107):
per-epoch training, validation every ``val_interval`` epochs, best-NDCG
checkpointing with old-best deletion, patience early stop, reload best at the
end — but every train step runs the sharded INMO path (parallel/steps.py):
row-sharded template table, edge-partitioned SpMM with table-axis
collectives, data-parallel BPR+aux batch, device-side positive-excluding
negative sampling with a distinct auxiliary stream, and per-epoch feat-mat
alpha annealing (reference model.py:374-381 via ShardedINMOTrain.anneal).

Validation/test run through the distributed evaluator (parallel/eval.py):
item representations stay row-sharded, per-shard masked top-k, cross-shard
merge.

Checkpoints hold host numpy copies of the (gathered) parameters plus the
template maps and alpha — the same inductive contract as the single-chip
model save (reference model.py:454-466).

Multi-host-safe (round 3): eval keeps the node representations ON DEVICE —
``rep_fn``'s row-sharded output is sliced globally and fed straight to
``sharded_evaluate`` (users replicated by a compiled all-gather, items
staying row-sharded); checkpointing gathers params through
``core/mesh.to_host_replicated`` (collective reshard, then a local
``np.asarray``). Nothing in eval/save requires all shards to be
process-addressable, so the loop runs unchanged when
``jax.process_count() > 1`` (core/mesh.initialize_distributed).

Beyond the reference loop, ``save_state``/``load_state`` persist the FULL
training state (params, Adam state, epoch, best metric, patience, PRNG key,
alpha) for crash resume — same contract as the single-chip
``BasicTrainer.save_state`` (train/trainer.py).
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from igcn_cf.core.mesh import to_host_replicated
from igcn_cf.parallel.eval import sharded_evaluate
from igcn_cf.parallel.steps import ShardedINMOTrain, build_inmo_sharded_train


class ShardedIGCNTrainer:
    def __init__(self, trainer_config: dict, dataset, mesh, model_config: dict):
        self.config = dict(trainer_config)
        self.dataset = dataset
        self.mesh = mesh
        self.topks = trainer_config["topks"]
        self.n_epochs = trainer_config["n_epochs"]
        self.max_patience = trainer_config.get("max_patience", 50)
        self.val_interval = trainer_config.get("val_interval", 1)
        self.test_batch_size = trainer_config.get("test_batch_size", 512)
        self.batch_size = trainer_config.get("batch_size", 2048)
        self.seed = trainer_config.get("seed", 2021)
        self.epoch = 0
        self.start_epoch = 0
        self.best_ndcg = -np.inf
        self.patience = self.max_patience
        self.save_path: Optional[str] = None
        # full-state checkpointing every N epochs (0 = off), for crash resume
        self.state_interval = trainer_config.get("state_interval", 0)
        self.state_path = trainer_config.get(
            "state_path", os.path.join("checkpoints", "sharded_train_state.pkl")
        )
        self.name = "ShardedIGCNTrainer"
        self.model_name = model_config.get("name", "IGCN")
        self.model_config = dict(model_config)

        self.train_state: ShardedINMOTrain = build_inmo_sharded_train(
            dataset,
            mesh,
            embedding_size=model_config["embedding_size"],
            n_layers=model_config["n_layers"],
            dropout=model_config["dropout"],
            lr=trainer_config["lr"],
            l2_reg=trainer_config.get("l2_reg", 0.0),
            aux_reg=trainer_config.get("aux_reg", 0.0),
            batch_size=self.batch_size,
            seed=self.seed,
            feature_ratio=model_config.get("feature_ratio", 1.0),
            ranking_metric=model_config.get("ranking_metric", "sort"),
            delta=model_config.get("delta", 0.99),
            prop_cache=model_config.get("prop_cache", "auto"),
        )
        self._key = jax.random.PRNGKey(self.seed + 1)

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    # -- training -------------------------------------------------------------

    def train_one_epoch(self) -> float:
        ts = self.train_state
        params, opt_state, loss = ts.epoch_fn(
            ts.params, ts.opt_state, ts.buffers, ts.samplers, self._next_key()
        )
        ts.params, ts.opt_state = params, opt_state
        loss = float(loss)
        ts.anneal()  # reference trainer.py:319 -> model.py:379
        return loss

    # -- evaluation -----------------------------------------------------------

    def _reps(self):
        """User/item representation slices as GLOBAL device arrays (no host
        pull — multi-host-safe; sharded_evaluate reshards them with compiled
        collectives)."""
        ts = self.train_state
        rep = ts.rep_fn(ts.params, ts.buffers)
        users_rep = rep[: ts.n_users]
        items_rep = rep[ts.n_users : ts.n_users + ts.n_items]
        return users_rep, items_rep

    def eval(self, val_or_test: str, banned_items=None):
        users_rep, items_rep = self._reps()
        return sharded_evaluate(
            self.mesh,
            users_rep,
            items_rep,
            self.dataset,
            val_or_test,
            self.topks,
            banned_items=banned_items,
            test_batch_size=self.test_batch_size,
        )

    def inductive_eval(self, n_old_users: int, n_old_items: int):
        """6-slice inductive protocol (reference trainer.py:179-219) through
        the sharded evaluator — the generic slicer only needs
        ``eval(split, banned_items)`` and a swappable ``dataset``."""
        from igcn_cf.evaluation.inductive import inductive_eval

        return inductive_eval(self, n_old_users, n_old_items)

    # -- inductive rebuild (dropit/dropui on the mesh) ------------------------

    def rebuild_for(self, new_dataset) -> None:
        """Rebuild the sharded train state over a new (possibly grown)
        dataset while KEEPING the template maps and parameters — the
        inductive contract (reference model.py:454-466 via
        run/dropui/igcn_dropui.py:29-35): new users/items get feat rows over
        the OLD templates, zero new parameters. Optimizer state is reset
        (the flows only evaluate after a rebuild, matching the reference)."""
        ts = self.train_state
        old_params = ts.params
        alpha = float(np.asarray(ts.buffers["alpha"]))
        mc, tc = self.model_config, self.config
        self.train_state = build_inmo_sharded_train(
            new_dataset,
            self.mesh,
            embedding_size=mc["embedding_size"],
            n_layers=mc["n_layers"],
            dropout=mc.get("dropout", 0.0),
            lr=tc["lr"],
            l2_reg=tc.get("l2_reg", 0.0),
            aux_reg=tc.get("aux_reg", 0.0),
            batch_size=self.batch_size,
            seed=self.seed,
            feature_ratio=mc.get("feature_ratio", 1.0),
            ranking_metric=mc.get("ranking_metric", "sort"),
            delta=mc.get("delta", 0.99),
            # train-only structure; rebuilt flows evaluate, and rebuilding a
            # sharded P while the old train_state still holds one would OOM
            # near the per-chip budget (see IGCN.rebuild_for)
            prop_cache=False,
            template_maps=(ts.user_map, ts.item_map),
        )
        # same template space -> same table shape: carry the params over
        # (re-put against the fresh shardings) and the annealed alpha
        nts = self.train_state
        nts.params = jax.tree_util.tree_map(
            lambda new, old: jax.device_put(old, new.sharding),
            nts.params,
            old_params,
        )
        # opt_state stays the freshly-initialized zeros: rebuilt flows
        # evaluate (reference protocol); continued training restarts Adam
        nts.buffers = dict(nts.buffers, alpha=jnp.float32(alpha))
        self.dataset = new_dataset

    # -- checkpointing --------------------------------------------------------

    def _host_params(self):
        return jax.tree_util.tree_map(
            lambda x: to_host_replicated(x, self.mesh), self.train_state.params
        )

    @staticmethod
    def _write_pickle(state: dict, path: str) -> None:
        """Atomic single-writer checkpoint install: only process 0 writes
        (every process still participates in the gather collectives BEFORE
        this), and the tmp name is per-process so a misconfigured launch on a
        shared filesystem can never interleave two writers into one tmp file."""
        if jax.process_index() != 0:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)  # atomic: a crash never corrupts the state

    def save(self, path: str):
        ts = self.train_state
        state = {
            "params": self._host_params(),
            "user_map": ts.user_map,
            "item_map": ts.item_map,
            "alpha": float(np.asarray(ts.buffers["alpha"])),
        }
        self._write_pickle(state, path)

    def load(self, path: str):
        ts = self.train_state
        with open(path, "rb") as f:
            state = pickle.load(f)
        emb_sharding = ts.params["embedding"].sharding
        w_sharding = ts.params["w"].sharding
        ts.params = {
            "embedding": jax.device_put(
                jnp.asarray(state["params"]["embedding"]), emb_sharding
            ),
            "w": jax.device_put(jnp.asarray(state["params"]["w"]), w_sharding),
        }
        ts.buffers = dict(ts.buffers, alpha=jnp.float32(state["alpha"]))

    # -- full-state checkpoint / resume (beyond the reference; matches
    # train/trainer.py::BasicTrainer.save_state contract) -----------------------

    def save_state(self, path: Optional[str] = None) -> str:
        ts = self.train_state
        path = path or self.state_path
        state = {
            "params": self._host_params(),
            "opt_state": jax.tree_util.tree_map(
                lambda x: to_host_replicated(x, self.mesh), ts.opt_state
            ),
            "alpha": float(np.asarray(ts.buffers["alpha"])),
            "epoch": self.epoch,
            "best_ndcg": self.best_ndcg,
            "patience": self.patience,
            "save_path": self.save_path,
            "rng_key": np.asarray(self._key),
            "user_map": ts.user_map,
            "item_map": ts.item_map,
        }
        self._write_pickle(state, path)
        return path

    def load_state(self, path: Optional[str] = None) -> None:
        ts = self.train_state
        path = path or self.state_path
        with open(path, "rb") as f:
            state = pickle.load(f)
        emb_sh = ts.params["embedding"].sharding
        w_sh = ts.params["w"].sharding
        ts.params = {
            "embedding": jax.device_put(
                jnp.asarray(state["params"]["embedding"]), emb_sh
            ),
            "w": jax.device_put(jnp.asarray(state["params"]["w"]), w_sh),
        }
        from jax.sharding import NamedSharding

        def _put(ref, x):
            # re-apply mesh shardings; leave scalars/uncommitted leaves free
            # (committing them to one device would conflict with the mesh)
            if isinstance(getattr(ref, "sharding", None), NamedSharding):
                return jax.device_put(jnp.asarray(x), ref.sharding)
            return jnp.asarray(x)

        ts.opt_state = jax.tree_util.tree_map(_put, ts.opt_state, state["opt_state"])
        ts.buffers = dict(ts.buffers, alpha=jnp.float32(state["alpha"]))
        self.start_epoch = state["epoch"] + 1
        self.best_ndcg = state["best_ndcg"]
        self.patience = state["patience"]
        self.save_path = state["save_path"]
        self._key = jnp.asarray(state["rng_key"])

    # -- main loop (reference trainer.py:57-107) --------------------------------

    def train(self, verbose: bool = True, writer=None) -> float:
        os.makedirs("checkpoints", exist_ok=True)
        steps = self.train_state.steps_per_epoch
        for self.epoch in range(self.start_epoch, self.n_epochs):
            start = time.time()
            loss = self.train_one_epoch()
            train_time = time.time() - start
            # per-epoch train-split metric eval (reference trainer.py:71) —
            # only when someone will see it
            if writer is not None:
                _, train_metrics = self.eval("train")
            if verbose:
                print(
                    "Epoch {:d}/{:d}, Loss: {:.6f}, Time: {:.3f}s".format(
                        self.epoch, self.n_epochs, loss, time.time() - start
                    )
                )
            if writer:
                writer.add_scalar(
                    f"{self.model_name}_{self.name}/train_loss", loss, self.epoch
                )
                writer.add_scalar(
                    f"{self.model_name}_{self.name}/examples_per_s",
                    steps * self.batch_size / max(train_time, 1e-9),
                    self.epoch,
                )
                writer.record(
                    self.model_name, self.name, "train", train_metrics, self.epoch
                )

            if (self.epoch + 1) % self.val_interval != 0:
                if self.state_interval and (self.epoch + 1) % self.state_interval == 0:
                    self.save_state()
                continue
            results, metrics = self.eval("val")
            if verbose:
                print("Validation result. {:s}".format(results))
            if writer:
                writer.record(
                    self.model_name, self.name, "validation", metrics, self.epoch
                )
            ndcg = metrics["NDCG"][self.topks[0]]
            early_stop = False
            if ndcg > self.best_ndcg:
                if (
                    jax.process_index() == 0
                    and self.save_path
                    and os.path.exists(self.save_path)
                ):
                    os.remove(self.save_path)
                self.save_path = os.path.join(
                    "checkpoints",
                    "{:s}_{:s}_{:s}_{:.3f}.pkl".format(
                        self.model_name, self.name, self.dataset.name, ndcg * 100
                    ),
                )
                self.best_ndcg = ndcg
                self.save(self.save_path)
                self.patience = self.max_patience
                if verbose:
                    print("Best NDCG, save model to {:s}".format(self.save_path))
            else:
                self.patience -= self.val_interval
                early_stop = self.patience <= 0
            # full training state AFTER the best-ckpt block, so a resumed run
            # never references a deleted best-model path
            if self.state_interval and (self.epoch + 1) % self.state_interval == 0:
                self.save_state()
            if early_stop:
                if verbose:
                    print("Early stopping!")
                break
        # after a resume, save_path can point at a best file
        # deleted AFTER the restored state snapshot — skip the final reload
        # instead of crashing (the in-memory params are the latest anyway)
        if self.save_path and os.path.exists(self.save_path):
            self.load(self.save_path)
        elif self.save_path and verbose:
            print(
                "Best checkpoint {:s} missing (deleted after the resumed "
                "state snapshot); keeping in-memory params".format(self.save_path)
            )
        return self.best_ndcg
