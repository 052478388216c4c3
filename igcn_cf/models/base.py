"""Model base contract and parameter initializers.

Design: a ``Model`` is a host object holding only static config and
host-side (numpy) graph structures. All device state is split into two
explicit pytrees:

  * ``params``  — trainable parameters, created by ``init_params(key)``;
  * ``buffers`` — non-trainable device arrays (normalized adjacency, feature
    matrices, profile matrices, annealed edge values), created by
    ``init_buffers()``.

Trainer steps are jitted pure functions ``(params, opt_state, buffers, batch,
key) -> ...`` with the model captured statically — so a buffer update (e.g.
INMO's per-epoch feat-mat anneal, reference model.py:374-381) is a new pytree
passed in, not a recompile.

The reference's class surface (``bpr_forward`` / ``predict`` / ``save`` /
``load``, reference model.py:31-49) maps to:

  * ``rep(params, buffers, train, key)`` — full node representations
  * ``bpr_pieces(...)`` — (user_rep, pos_rep, neg_rep, l2_norm_sq) quadruple,
    preserving each model's l2 choice (ego embeddings for MF/LightGCN at
    reference model.py:62-67,108-116; propagated reps for NGCF/IGCN at
    reference model.py:293-299)
  * ``make_predict_fn(params, buffers)`` — batched full-catalog scorer for
    the evaluator, with representations cached once per eval (exact at eval:
    no dropout — SURVEY.md §7 hard part 1)
  * ``save/load`` — parameter checkpointing plus each model's extra state
    (INMO persists template maps + alpha and rebuilds feat_mat from the
    *current* dataset on load — the inductive contract, reference
    model.py:454-466)
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Params = Dict[str, Any]
Buffers = Dict[str, Any]


# -- initializers (match the reference's torch inits) ------------------------


def normal_init(key, shape, std=0.1, dtype=jnp.float32):
    """normal_(std=0.1) — the embedding-table init used by MF/LightGCN/IGCN
    (reference model.py:58-59,82,371)."""
    return std * jax.random.normal(key, shape, dtype)


def kaiming_uniform(key, shape, dtype=jnp.float32):
    """torch.nn.init.kaiming_uniform_ default (a=0, fan_in, leaky_relu gain
    sqrt(2)): bound = sqrt(6 / fan_in); fan_in is shape[-1] for (out, in)
    weight layout (used at reference model.py:24-28,240,673-676)."""
    fan_in = shape[-1]
    bound = float(np.sqrt(6.0 / fan_in))
    return jax.random.uniform(key, shape, dtype, minval=-bound, maxval=bound)


def linear_init(key, in_features: int, out_features: int) -> Params:
    """Linear layer with kaiming-uniform weight, zero bias (reference
    model.py:24-28). Weight stored (in, out) so application is x @ w + b."""
    w = kaiming_uniform(key, (out_features, in_features)).T
    return {"w": w, "b": jnp.zeros((out_features,), jnp.float32)}


def linear_apply(layer: Params, x: jnp.ndarray) -> jnp.ndarray:
    return x @ layer["w"] + layer["b"]


def l2sq(x: jnp.ndarray, axis=None) -> jnp.ndarray:
    return jnp.sum(x * x, axis=axis)


class Model:
    """Base model; subclasses set ``trainable`` and implement the contract."""

    trainable: bool = True

    def __init__(self, config: dict, dataset):
        self.config = dict(config)
        self.name = config["name"]
        self.dataset = dataset
        self.n_users = dataset.n_users
        self.n_items = dataset.n_items
        self._jit_cache: Dict[str, Any] = {}

    def _get_jit(self, key: str, make_fn: Callable[[], Callable],
                 static_argnames=()):
        """Per-instance jit cache: evaluation helpers are traced once per
        model (per static key), not once per eval call — a fresh closure per
        epoch would retrace and recompile every time."""
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(
                make_fn(), static_argnames=static_argnames
            )
        return self._jit_cache[key]

    def _rep_eval(self, params: Params, buffers: Buffers):
        rep_fn = self._get_jit(
            "rep_eval", lambda: (lambda p, b: self.rep(p, b, train=False, key=None))
        )
        return rep_fn(params, buffers)

    def _dot_predict_fn(self, params: Params, buffers: Buffers):
        """Shared predict for rep-based models: cache eval representations
        once, then score user batches with a catalog matmul (reference
        model.py:118-123 without the per-batch get_rep recompute)."""
        from igcn_cf.evaluation.evaluate import score

        rep = self._rep_eval(params, buffers)
        users_rep = rep[: self.n_users]
        items_t = rep[self.n_users :].T
        score_fn = self._get_jit(
            "dot_score", lambda: (lambda ur, it, users: score(ur[users], it))
        )
        return lambda users: score_fn(users_rep, items_t, users)

    def _dot_recommend_fn(self, params: Params, buffers: Buffers):
        """Single-dispatch full-eval recommender for rep-based models: the
        whole masked top-k retrieval runs as one jitted ``lax.scan`` over
        user blocks — one dispatch, one copy of the (n_users, max_k) ids to
        the host."""
        from igcn_cf.evaluation.evaluate import scan_topk

        rep = self._rep_eval(params, buffers)
        users_rep = rep[: self.n_users]
        items_t = rep[self.n_users :].T
        n_items = self.n_items

        def make():
            def scan_rec(ur, it, users_pad, exclude, banned_mask, *, max_k):
                return scan_topk(ur, it, users_pad, exclude, banned_mask,
                                 max_k, n_items)

            return scan_rec

        fn = self._get_jit("recommend_scan", make, static_argnames=("max_k",))
        return lambda users_pad, exclude, banned_mask, max_k: fn(
            users_rep, items_t, users_pad, exclude, banned_mask, max_k=max_k
        )

    def make_recommend_fn(self, params: Params, buffers: Buffers):
        """Optional single-dispatch full-eval recommender
        ``fn(users_pad (nb,B), exclude (n_users,W) device-resident,
        banned_mask (n_items,), max_k) -> (nb*B, max_k)``. None means the
        evaluator falls back to the per-batch ``make_predict_fn`` loop
        (models whose scoring is not device-traceable, e.g. host-scipy
        ItemKNN)."""
        return None

    # class attr: scoring is users_rep @ items_rep^T over self.rep — the
    # models eligible for the one-dispatch eval below
    dot_scored: bool = False

    def make_eval_fn(self, params: Params, buffers: Buffers):
        """One-dispatch metric eval, or None. The trainer's ``eval`` then
        runs rep -> scan of score/mask/top-k over user blocks -> device
        metric reductions inside a single jitted call: one dispatch, one
        copy of 3*len(topks) scalars to the host
        (evaluation/evaluate.py::evaluate_one_dispatch)."""
        if not self.dot_scored:
            return None
        from igcn_cf.evaluation.evaluate import scan_topk
        from igcn_cf.evaluation.metrics import device_metrics_core

        n_users, n_items = self.n_users, self.n_items

        def make():
            def eval_all(params, buffers, users_pad, exclude, banned_mask,
                         padded, lens, *, topks, max_k):
                rep = self.rep(params, buffers, train=False, key=None)
                rec = scan_topk(rep[:n_users], rep[n_users:].T, users_pad,
                                exclude, banned_mask, max_k, n_items)
                return device_metrics_core(rec[:n_users], padded, lens, topks)

            return eval_all

        fn = self._get_jit(
            "eval_one_dispatch", make, static_argnames=("topks", "max_k")
        )

        def call(users_pad, exclude, banned_mask, padded, lens, topks, max_k):
            return fn(params, buffers, users_pad, exclude, banned_mask,
                      padded, lens, topks=tuple(topks), max_k=max_k)

        return call

    def _traced_scan_recommend_fn(self, params: Params, buffers: Buffers,
                                  predict_core, cache_key: str):
        """Generic single-dispatch recommender for any traceable scorer
        ``predict_core(params, buffers, users (B,)) -> (B, n_items)``: the
        whole eval is one jitted ``lax.scan`` over user blocks (one
        dispatch, one copy to the host) — the non-dot models' analog of
        ``_dot_recommend_fn``."""
        from igcn_cf.evaluation.evaluate import mask_topk_core

        n_items = self.n_items

        def make():
            def scan_rec(params, buffers, users_pad, exclude, banned_mask,
                         *, max_k):
                def body(c, users):
                    scores = predict_core(params, buffers, users)
                    return c, mask_topk_core(
                        scores, exclude[users], banned_mask, max_k, n_items
                    )

                _, recs = jax.lax.scan(body, jnp.int32(0), users_pad)
                return recs.reshape(-1, max_k)

            return scan_rec

        fn = self._get_jit(cache_key, make, static_argnames=("max_k",))
        return lambda users_pad, exclude, banned_mask, max_k: fn(
            params, buffers, users_pad, exclude, banned_mask, max_k=max_k
        )

    # -- device state -------------------------------------------------------

    def init_params(self, key: jax.Array) -> Params:
        return {}

    def init_buffers(self) -> Buffers:
        return {}

    # -- representations & scoring -----------------------------------------

    def rep(
        self, params: Params, buffers: Buffers, *, train: bool, key: Optional[jax.Array]
    ) -> jnp.ndarray:
        raise NotImplementedError

    def bpr_pieces(
        self,
        params: Params,
        buffers: Buffers,
        users: jnp.ndarray,
        pos: jnp.ndarray,
        neg: jnp.ndarray,
        *,
        train: bool,
        key: Optional[jax.Array],
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        raise NotImplementedError

    def make_predict_fn(
        self, params: Params, buffers: Buffers
    ) -> Callable[[jnp.ndarray], jnp.ndarray]:
        raise NotImplementedError

    # -- epoch hook (INMO anneal); default no-op ----------------------------

    def epoch_update(self, buffers: Buffers) -> Buffers:
        return buffers

    def refresh_buffers(self, buffers: Buffers) -> Buffers:
        """Re-derive buffers after a checkpoint load (models whose buffers
        depend on loaded extra state override this)."""
        return buffers

    # -- inductive rebuild: re-derive buffers for a (possibly grown) dataset

    def rebuild_for(self, new_dataset) -> Buffers:
        """Default: models with no graph structure just re-init buffers after
        swapping the dataset."""
        self.dataset = new_dataset
        self.n_users = new_dataset.n_users
        self.n_items = new_dataset.n_items
        self._jit_cache.clear()  # shapes/statics may have changed
        return self.init_buffers()

    # -- checkpointing ------------------------------------------------------

    def extra_state(self) -> dict:
        return {}

    def load_extra_state(self, state: dict) -> None:
        pass

    def save(self, path: str, params: Params) -> None:
        blob = {
            "params": jax.tree_util.tree_map(np.asarray, params),
            "extra": self.extra_state(),
        }
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    def load(self, path: str) -> Params:
        """Restore params; subclasses may rebuild dataset-derived structures
        from the current dataset (the inductive contract)."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        self.load_extra_state(blob.get("extra", {}))
        return jax.tree_util.tree_map(jnp.asarray, blob["params"])


def get_model(config: dict, dataset) -> Model:
    """Factory matching the reference API (reference model.py:16-21)."""
    from igcn_cf.core.registry import MODELS

    cls = MODELS.get(config["name"])
    return cls(config, dataset)
