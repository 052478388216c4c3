"""Population (batched) hyperparameter search.

The reference runs its grid sequentially, one full training per grid point
(reference hyperparameter/mf_tuning.py:25-39); SURVEY.md §3.4 calls out the
natural accelerator upgrade: a *population* of trials trained together. Here the
trial axis is a vmapped leading axis over the training step and evaluator —
one compiled program trains every grid point whose hyperparameters are plain
scalars in the loss/optimizer (``lr``, ``l2_reg``, ``aux_reg``,
``contrastive_reg``). Grid keys that change the traced program (``dropout``
is a mask threshold baked at trace time, ``k``/``feature_ratio``
change shapes) partition the grid into groups, one compiled program each.

Semantics match the sequential ``grid_search`` exactly:

  * every trial reseeds the same seed (like the reference's per-trial
    ``set_seed``), so init and the sampling stream are shared — the trial
    axis only varies the scalar hyperparameters;
  * Adam is ``optax.scale_by_adam`` with the per-trial learning rate applied
    as ``params - lr * direction`` — numerically identical to
    ``optax.adam(lr)`` (= ``chain(scale_by_adam, scale(-lr))``);
  * per-trial best-val-NDCG tracking with the reference's patience early
    stop (a trial whose patience runs out stops updating its best; the
    group keeps stepping until every trial is done or ``n_epochs``).

Deviations (documented): no per-trial checkpoint files are written (the
fitness value is the best validation NDCG, reference
hyperparameter/mf_tuning.py:23), and the per-epoch train-split metric eval
is skipped (it never feeds the fitness).

Pod parallelism: pass ``mesh`` to shard the trial axis across devices —
trials are embarrassingly parallel, so XLA partitions the whole program
with zero collectives on the training path. Validated on the virtual
8-device CPU mesh in tests.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from igcn_cf.core.prng import KeySeq, set_seed
from igcn_cf.data.dataset import get_dataset
from igcn_cf.data.sampler import DeviceNegativeSampler
from igcn_cf.data.transforms import auxiliary_interactions
from igcn_cf.evaluation.evaluate import _mask_and_topk, build_exclusion
from igcn_cf.evaluation.metrics import calculate_metrics
from igcn_cf.models.base import get_model
from igcn_cf.train.bpr import bpr_loss_terms
from igcn_cf.tuning.grid import _MODEL_KEYS, parameter_grid

# hyperparameters that are scalar inputs to the loss/optimizer: traced, so
# one compiled program covers every combination
TRACED_KEYS = ("lr", "l2_reg", "aux_reg", "contrastive_reg")


def _make_population_loss(trainer_name: str, model, samplers, batch_size: int):
    """Per-trial loss with traced hyperparameters; mirrors the corresponding
    trainer's ``_loss`` (train/bpr.py)."""

    if trainer_name == "BPRTrainer":

        def loss(params, buffers, hyper, k_batch, k_drop):
            users, pos, negs = samplers["main"].sample(k_batch, batch_size)
            bpr, l2 = bpr_loss_terms(
                model, params, buffers, users, pos, negs[:, 0], k_drop
            )
            return bpr + hyper["l2_reg"] * jnp.mean(l2)

    elif trainer_name == "IGCNTrainer":

        def loss(params, buffers, hyper, k_batch, k_drop):
            k_main, k_aux = jax.random.split(k_batch)
            users, pos, negs = samplers["main"].sample(k_main, batch_size)
            bpr, l2 = bpr_loss_terms(
                model, params, buffers, users, pos, negs[:, 0], k_drop
            )
            a_users, a_pos, a_negs = samplers["aux"].sample(k_aux, batch_size)
            aux_pos, aux_neg = model.aux_scores(params, a_users, a_pos, a_negs[:, 0])
            aux_loss = jnp.mean(jax.nn.softplus(aux_neg - aux_pos))
            return bpr + hyper["l2_reg"] * jnp.mean(l2) + hyper["aux_reg"] * aux_loss

    elif trainer_name == "IDCFTrainer":

        def loss(params, buffers, hyper, k_batch, k_drop):
            users, pos, negs = samplers["main"].sample(k_batch, batch_size)
            u_r, p_r, n_r, l2, contrastive = model.bpr_pieces_contrastive(
                params, buffers, users, pos, negs[:, 0], train=True, key=k_drop
            )
            bpr = jnp.mean(
                jax.nn.softplus(jnp.sum(u_r * n_r, 1) - jnp.sum(u_r * p_r, 1))
            )
            return (
                bpr
                + hyper["l2_reg"] * jnp.mean(l2)
                + hyper["contrastive_reg"] * jnp.mean(contrastive)
            )

    else:
        raise ValueError(
            f"population tuning supports the BPR-family trainers, not {trainer_name}"
        )
    return loss


class PopulationTrainer:
    """Trains T trials of one model in a single compiled program."""

    def __init__(self, trainer_config, dataset, model, hyper_grid: List[dict],
                 mesh=None):
        self.config = dict(trainer_config)
        self.dataset = dataset
        self.model = model
        self.trials = list(hyper_grid)
        self.topks = trainer_config["topks"]
        self.n_epochs = trainer_config["n_epochs"]
        self.max_patience = trainer_config.get("max_patience", 50)
        self.val_interval = trainer_config.get("val_interval", 1)
        self.test_batch_size = trainer_config.get("test_batch_size", 512)
        self.batch_size = trainer_config.get("batch_size", 2048)
        self.mesh = mesh
        self.keys = KeySeq(trainer_config.get("seed", 2021))

        self.samplers = {"main": DeviceNegativeSampler.build(dataset)}
        self.buffers = model.init_buffers()
        bip = self.buffers.get("bip")
        if bip is not None:
            self.samplers["main"] = self.samplers["main"].with_dense_b(bip.B)
        if trainer_config["name"] == "IGCNTrainer":
            aux_ds = auxiliary_interactions(dataset, model.user_map, model.item_map)
            aux = DeviceNegativeSampler.build(aux_ds)
            if bip is not None and model._identity_templates():
                aux = aux.with_dense_b(bip.B)
            self.samplers["aux"] = aux

        # one init shared by every trial (the reference reseeds the same seed
        # per trial, so sequential trials start identical too)
        base_params = model.init_params(self.keys.next())

        self.n_trials = len(self.trials)
        self.n_pad = 0
        if mesh is not None:
            n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
            self.n_pad = (-self.n_trials) % n_dev
        t = self.n_trials + self.n_pad
        padded = self.trials + [self.trials[0]] * self.n_pad

        def stack_hyper(key, default):
            return jnp.asarray(
                [p.get(key, trainer_config.get(key, default)) for p in padded],
                jnp.float32,
            )

        self.hyper = {"lr": stack_hyper("lr", 1e-3)}
        for k in ("l2_reg", "aux_reg", "contrastive_reg"):
            if any(k in p for p in padded) or k in trainer_config:
                self.hyper[k] = stack_hyper(k, 0.0)

        self.params = jax.tree_util.tree_map(
            lambda x: jnp.repeat(x[None], t, axis=0), base_params
        )
        self.opt = optax.scale_by_adam()
        self.opt_state = jax.vmap(self.opt.init)(self.params)

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            spec = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
            put = lambda x: jax.device_put(x, spec)
            self.params = jax.tree_util.tree_map(put, self.params)
            self.opt_state = jax.tree_util.tree_map(put, self.opt_state)
            self.hyper = jax.tree_util.tree_map(put, self.hyper)

        self._loss = _make_population_loss(
            trainer_config["name"], model, self.samplers, self.batch_size
        )
        self._epoch_fn = None
        self._rep_fn = None
        self._score_fn = None

    # -- training ------------------------------------------------------------

    def _build_epoch_fn(self):
        opt = self.opt
        n_steps = max(1, -(-len(self.dataset) // self.batch_size))

        def step(carry, key, buffers):
            params, opt_state, hyper = carry
            k_batch, k_drop = jax.random.split(key)
            loss, grads = jax.value_and_grad(self._loss)(
                params, buffers, hyper, k_batch, k_drop
            )
            direction, opt_state = opt.update(grads, opt_state, params)
            params = jax.tree_util.tree_map(
                lambda p, d: p - hyper["lr"] * d, params, direction
            )
            return (params, opt_state, hyper), loss

        def one_trial(params, opt_state, hyper, buffers, keys):
            (params, opt_state, _), losses = jax.lax.scan(
                partial(step, buffers=buffers), (params, opt_state, hyper), keys
            )
            return params, opt_state, losses.mean()

        @partial(jax.jit, donate_argnums=(0, 1))
        def epoch_fn(params, opt_state, hyper, buffers, key):
            keys = jax.random.split(key, n_steps)
            return jax.vmap(one_trial, in_axes=(0, 0, 0, None, None))(
                params, opt_state, hyper, buffers, keys
            )

        return epoch_fn

    def train_one_epoch(self) -> np.ndarray:
        if self._epoch_fn is None:
            self._epoch_fn = self._build_epoch_fn()
        self.params, self.opt_state, losses = self._epoch_fn(
            self.params, self.opt_state, self.hyper, self.buffers,
            self.keys.next(),
        )
        self.buffers = self.model.epoch_update(self.buffers)
        return np.asarray(losses)

    # -- evaluation ------------------------------------------------------------

    def eval_val_ndcg(self) -> np.ndarray:
        """Best-k val NDCG per trial: vmapped rep + scoring + masked top-k,
        then the shared metric math per trial on host."""
        ds = self.dataset
        model = self.model
        max_k = max(self.topks)
        k0 = self.topks[0]

        if self._rep_fn is None:
            self._rep_fn = jax.jit(
                jax.vmap(
                    lambda p, b: model.rep(p, b, train=False, key=None),
                    in_axes=(0, None),
                )
            )
            exclude_np, _ = build_exclusion(ds, include_val=False)
            self._exclude = jnp.asarray(exclude_np)
            self._banned = jnp.zeros(ds.n_items, dtype=bool)

            def score_topk(reps, users, exclude):
                # reps (T, n_users+n_items, d)
                scores = jnp.einsum(
                    "tbd,tnd->tbn", reps[:, users], reps[:, ds.n_users :]
                )
                return jax.vmap(
                    lambda s: _mask_and_topk(
                        s, exclude, self._banned, max_k, ds.n_items
                    )
                )(scores)

            self._score_fn = jax.jit(score_topk)

        reps = self._rep_fn(self.params, self.buffers)
        t = self.n_trials + self.n_pad
        rec = np.empty((t, ds.n_users, max_k), dtype=np.int64)
        bs = self.test_batch_size
        for start in range(0, ds.n_users, bs):
            stop = min(start + bs, ds.n_users)
            users_np = np.arange(start, stop, dtype=np.int32)
            if stop - start < bs:
                users_np = np.concatenate(
                    [users_np, np.full(bs - (stop - start), stop - 1, np.int32)]
                )
            users = jnp.asarray(users_np)
            items = self._score_fn(reps, users, self._exclude[users])
            rec[:, start:stop] = np.asarray(items)[:, : stop - start]

        ndcgs = np.empty(self.n_trials, dtype=np.float64)
        for i in range(self.n_trials):
            m = calculate_metrics(ds.val, rec[i], self.topks)
            ndcgs[i] = m["NDCG"][k0]
        return ndcgs

    # -- main loop (reference trainer.py:57-107, per-trial) -------------------

    def train(self, verbose: bool = True) -> np.ndarray:
        best = np.full(self.n_trials, -np.inf)
        patience = np.full(self.n_trials, self.max_patience, dtype=np.int64)
        alive = np.ones(self.n_trials, dtype=bool)
        for epoch in range(self.n_epochs):
            losses = self.train_one_epoch()
            if verbose:
                print(
                    "Epoch {:d}/{:d}, losses: {:s}, {:d}/{:d} trials alive".format(
                        epoch, self.n_epochs,
                        np.array2string(losses[: self.n_trials], precision=4),
                        int(alive.sum()), self.n_trials,
                    )
                )
            if (epoch + 1) % self.val_interval != 0:
                continue
            ndcgs = self.eval_val_ndcg()
            improved = alive & (ndcgs > best)
            best = np.where(improved, ndcgs, best)
            patience = np.where(
                improved, self.max_patience, patience - self.val_interval
            )
            alive &= patience > 0
            if not alive.any():
                if verbose:
                    print("Early stopping (all trials)!")
                break
        return best


def population_grid_search(
    dataset_config, model_config, trainer_config, grid: Dict[str, list],
    seed: int = 2021, verbose: bool = True, mesh=None,
):
    """Drop-in replacement for ``grid_search`` that trains all trials with
    scalar hyperparameters together; grid keys that change the compiled
    program (everything not in ``TRACED_KEYS``) split the grid into groups,
    one program each. Returns the same result dict as ``grid_search``."""
    all_combos = list(parameter_grid(grid))
    groups: Dict[tuple, List[dict]] = {}
    for combo in all_combos:
        struct = tuple(
            sorted((k, v) for k, v in combo.items() if k not in TRACED_KEYS)
        )
        groups.setdefault(struct, []).append(combo)

    ndcg_by_combo: Dict[tuple, float] = {}
    for struct, combos in groups.items():
        set_seed(seed)
        mc = dict(model_config)
        tc = dict(trainer_config)
        for k, v in struct:
            (mc if k in _MODEL_KEYS else tc)[k] = v
        dataset = get_dataset(dataset_config)
        model = get_model(mc, dataset)
        trials = [
            {k: v for k, v in c.items() if k in TRACED_KEYS} for c in combos
        ]
        if verbose and struct:
            print(f"Group {dict(struct)}: {len(trials)} trials in one program")
        pop = PopulationTrainer(tc, dataset, model, trials, mesh=mesh)
        best = pop.train(verbose=verbose)
        for combo, ndcg in zip(combos, best):
            ndcg_by_combo[tuple(sorted(combo.items()))] = float(ndcg)

    # report in the reference's sequential grid order
    max_ndcg = -np.inf
    best_params = None
    trial_records = []
    for combo in all_combos:
        ndcg = ndcg_by_combo[tuple(sorted(combo.items()))]
        trial_records.append({"params": combo, "ndcg": ndcg})
        print("NDCG: {:.3f}, Parameters: {:s}".format(ndcg, str(combo)))
        if ndcg > max_ndcg:
            max_ndcg = ndcg
            best_params = combo
            print("Maximum NDCG!")
    print(
        "Maximum NDCG: {:.3f}, Best Parameters: {:s}".format(max_ndcg, str(best_params))
    )
    return {
        "best_ndcg": float(max_ndcg),
        "best_params": best_params,
        "trials": trial_records,
    }
