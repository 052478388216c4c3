"""Production retrieval service around a trained checkpoint.

The INMO use-case this framework exists for (reference paper §1; dropui flow
run/dropui/igcn_dropui.py:26-48) is SERVING with a moving catalog: new
users/items keep arriving, and the inductive template aggregation gives them
representations with ZERO gradient steps — the reference benchmarks this as
"inductive update inference time" (3.4 s INMO-LGCN / 1.8 s INMO-MF on its
GPU, run/plot.py:200-201; BASELINE.md). ``Recommender`` packages that
life-cycle as a service object:

    rec = Recommender.from_checkpoint(path, model_config, dataset)
    ids = rec.recommend(user_ids, k=20)     # masked top-k per request
    rec.refresh(new_dataset)                # inductive update: rebuild
                                            # feat/graph over the new data,
                                            # recompute representations —
                                            # no training

Serving path: representations are computed once per refresh and held on
device; requests gather their user rows, score them against the catalog in
float32 at full precision, mask each user's excluded interactions (an
exclusion-id matrix built once per refresh) and take the exact two-stage
top-k (evaluation/evaluate.py). Request shapes bucket to a multiple of
``REQ_BLOCK``, so distinct request sizes cost at most a handful of
compiles.

chip_smoke.py checks serving against a host reference on the card;
tools/bench_serve.py measures refresh latency and request throughput.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from igcn_cf.models.base import get_model


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


# Model jit-cache entries that are pure functions of their ARGUMENTS (no
# buffer values captured as trace constants) — the only ones safe to carry
# across a same-shape rebuild (see Recommender.refresh). Keys from
# models/base.py: rep_eval / recommend_scan / dot_score.
_ARG_PURE_JIT_KEYS = frozenset({"rep_eval", "recommend_scan", "dot_score"})

# request sizes bucket to a multiple of this (compile reuse)
REQ_BLOCK = 512


class Recommender:
    def __init__(self, model, params, buffers, *, exclude: str = "train",
                 bucket: bool = False, mesh=None):
        """``exclude``: which known interactions never get re-recommended —
        'train' (the eval protocol's masking) or 'all' (train+val+test, the
        usual serving stance). ``bucket``: catalog shapes were/will be padded
        to geometric buckets (data/padded.py) so refreshes at grown catalogs
        reuse compiled executables — set by ``from_checkpoint``; a directly
        constructed Recommender inherits whatever shapes the model has.
        ``mesh``: serve over a device mesh — item representations row-shard
        along the 'table' axis and requests run score -> mask -> local
        top-k -> all-gather merge per shard (the deployment whose tables
        exceed one card, BASELINE.json configs[4]). Same results as a
        single device (tests/test_serve.py)."""
        if exclude not in ("train", "all"):
            raise ValueError(f"exclude must be 'train' or 'all', got {exclude!r}")
        self.model = model
        self.params = params
        self.buffers = buffers
        self.exclude = exclude
        self.bucket = bucket
        self.mesh = mesh
        self._prepare()

    # -- construction --------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, model_config: dict, dataset, *,
                        exclude: str = "train", bucket: bool = True,
                        mesh=None):
        """Load a trained checkpoint over the CURRENT dataset — the
        inductive contract (reference model.py:454-466): template maps come
        from the checkpoint, feat/graph structures from the dataset, so
        users/items unseen at training time are served immediately.

        ``bucket=True`` (default) pads the catalog to geometric shape
        buckets and enables the persistent compilation cache: a later
        ``refresh`` onto a grown catalog either keeps the same shapes
        (within-bucket growth: zero recompiles) or compiles once per
        machine (new bucket, served from the disk cache afterwards)."""
        if bucket:
            from igcn_cf.core.compile_cache import enable_persistent_cache
            from igcn_cf.data.padded import pad_catalog

            enable_persistent_cache()
            dataset = pad_catalog(dataset)
        # serving never trains: the propagation cache is a training-only
        # structure, so don't spend the multi-GB build on it
        model = get_model(dict(model_config, prop_cache=False), dataset)
        params = model.load(path)
        buffers = model.refresh_buffers(model.init_buffers())
        return cls(model, params, buffers, exclude=exclude, bucket=bucket,
                   mesh=mesh)

    @classmethod
    def from_trainer(cls, trainer, *, exclude: str = "train"):
        return cls(trainer.model, trainer.params, trainer.buffers,
                   exclude=exclude)

    # -- life-cycle ----------------------------------------------------------

    def refresh(self, new_dataset=None) -> float:
        """Inductive update: rebuild graph/feat structures over
        ``new_dataset`` (or the current one) and recompute representations +
        masks. Returns the wall seconds — the number the reference calls
        'inductive update inference time' (run/plot.py:200-201). No
        training happens."""
        t0 = time.time()
        if new_dataset is not None:
            if self.bucket:
                from igcn_cf.data.padded import pad_catalog

                new_dataset = pad_catalog(new_dataset)
            model = self.model
            same_shape = (
                new_dataset.n_users == model.n_users
                and new_dataset.n_items == model.n_items
            )
            saved = dict(model._jit_cache) if same_shape else None
            self.buffers = model.rebuild_for(new_dataset)
            if saved is not None:
                # steady-state refresh (new interactions, same catalog
                # shape): restore ONLY the known ARG-PURE entries — jitted
                # evaluators that take every buffer they read as an argument,
                # so the rebuilt buffers flow through them. A blanket restore
                # would resurrect closures that baked buffer VALUES in as
                # trace constants (e.g. Popularity's recscan captures
                # item_degree), exactly the staleness rebuild_for's cache
                # clear exists to prevent. This avoids a re-jit per refresh
                # on the serving hot path (tools/bench_serve.py).
                model._jit_cache.update(
                    {k: v for k, v in saved.items() if k in _ARG_PURE_JIT_KEYS}
                )
        self._prepare()
        return time.time() - t0

    def _exclude_lists(self):
        ds = self.model.dataset
        lists = [list(ds.train[u]) for u in range(ds.n_users)]
        if self.exclude == "all":
            for u in range(ds.n_users):
                lists[u] += list(ds.val[u]) + list(ds.test[u])
        return lists

    @staticmethod
    def _lists_to_coo(lists):
        rows = np.concatenate(
            [np.full(len(x), u, np.int32) for u, x in enumerate(lists) if len(x)]
            or [np.zeros(0, np.int32)]
        )
        cols = np.concatenate(
            [np.asarray(x, np.int32) for x in lists if len(x)]
            or [np.zeros(0, np.int32)]
        )
        return rows, cols

    def _exclusion_ids(self, n_users: int, n_items: int) -> np.ndarray:
        """(n_users, W) excluded item ids, padded with the sentinel
        ``n_items``."""
        lists = self._exclude_lists()
        width = max(1, max((len(x) for x in lists), default=1))
        excl = np.full((n_users, width), n_items, dtype=np.int32)
        for u, items in enumerate(lists):
            if items:
                excl[u, : len(items)] = items
        return excl

    def _prepare(self):
        from igcn_cf.data.padded import real_counts

        if self.mesh is not None:
            self._prepare_sharded()
            return
        model = self.model
        n_users, n_items = model.n_users, model.n_items
        # bucketed catalogs: ghost items (>= the real count) would score 0 on
        # the raw dot — above true negatives — so they are banned; ghost
        # users are simply never requested
        _, self._n_real_items = real_counts(model.dataset)
        rep = model._rep_eval(self.params, self.buffers)
        self._users_rep = rep[:n_users]
        self._items_t = rep[n_users:].T
        self._excl_ids = jnp.asarray(self._exclusion_ids(n_users, n_items))
        banned_mask = np.zeros((n_items,), bool)
        banned_mask[self._n_real_items:] = True
        self._banned_mask = jnp.asarray(banned_mask)
        self._request_fns = {}
        # serving readiness means reps and masks are resident
        jax.block_until_ready((self._users_rep, self._items_t, self._excl_ids))

    # -- sharded (mesh) serving ---------------------------------------------

    def _prepare_sharded(self):
        """Mesh mode: users_rep + masks replicated, items_rep row-sharded
        over 'table'; requests reuse parallel/eval.py's score -> mask ->
        shard-local exact top-k -> all-gather merge shape, as ONE jitted
        shard_map per (block, k)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from igcn_cf.core.mesh import TABLE_AXIS
        from igcn_cf.data.padded import real_counts

        model = self.model
        mesh = self.mesh
        n_users, n_items = model.n_users, model.n_items
        _, self._n_real_items = real_counts(model.dataset)
        n_shards = mesh.shape[TABLE_AXIS]
        rep = model._rep_eval(self.params, self.buffers)
        repl = NamedSharding(mesh, P())
        tbl = NamedSharding(mesh, P(TABLE_AXIS, None))
        items_pad = -(-n_items // n_shards) * n_shards
        self._i_shard = items_pad // n_shards
        self._users_rep = jax.device_put(rep[:n_users], repl)
        self._items_sh = jax.jit(
            lambda x: jnp.pad(x, ((0, items_pad - n_items), (0, 0))),
            out_shardings=tbl,
        )(rep[n_users:])
        self._excl_ids = jax.device_put(
            jnp.asarray(self._exclusion_ids(n_users, n_items)), repl
        )
        banned = np.zeros(items_pad, dtype=bool)
        banned[self._n_real_items:] = True  # ghosts + shard padding
        self._banned_mask = jax.device_put(jnp.asarray(banned), repl)
        self._request_fns = {}
        jax.block_until_ready((self._users_rep, self._items_sh))

    def _mesh_request_fn(self, k: int):
        from jax.sharding import PartitionSpec as P

        from igcn_cf.core.mesh import TABLE_AXIS
        from igcn_cf.evaluation.evaluate import exact_topk, score

        i_shard = self._i_shard
        kk = min(k, i_shard)

        def shard_fn(users, users_rep, items_shard, excl, banned):
            items_t = items_shard.reshape(i_shard, -1).T  # (d, I_shard)
            t = jax.lax.axis_index(TABLE_AXIS)
            offset = t * i_shard
            local_banned = jax.lax.dynamic_slice(
                banned, (offset,), (i_shard,)
            )
            scores = score(users_rep[users], items_t)
            scores = jnp.where(local_banned[None, :], -jnp.inf, scores)
            local = excl[users] - offset
            in_range = (local >= 0) & (local < i_shard)
            b = scores.shape[0]
            ext = jnp.concatenate(
                [scores, jnp.zeros((b, 1), scores.dtype)], axis=1
            )
            rows = jnp.broadcast_to(jnp.arange(b)[:, None], local.shape)
            ext = ext.at[
                rows, jnp.where(in_range, local, i_shard)
            ].set(-jnp.inf)
            vals, idx = exact_topk(ext[:, :i_shard], kk)
            idx = idx + offset
            vals_all = jax.lax.all_gather(vals, TABLE_AXIS, axis=1, tiled=True)
            idx_all = jax.lax.all_gather(idx, TABLE_AXIS, axis=1, tiled=True)
            _, midx = jax.lax.top_k(vals_all, k)
            return jnp.take_along_axis(idx_all, midx, axis=1)

        return jax.jit(
            jax.shard_map(
                shard_fn,
                mesh=self.mesh,
                in_specs=(P(), P(), P(TABLE_AXIS, None), P(), P()),
                out_specs=P(),
                check_vma=False,
            )
        )

    def _recommend_sharded(self, users: np.ndarray, k: int,
                           banned_items) -> np.ndarray:
        n = users.shape[0]
        npad = _pad_to(n, REQ_BLOCK)
        users_p = np.concatenate(
            [users, np.full(npad - n, users[-1], np.int32)]
        )
        banned = self._banned_mask
        if banned_items is not None:
            b = np.array(banned)  # writable copy (np.asarray views read-only)
            b[np.asarray(banned_items, np.int64)] = True
            banned = jnp.asarray(b)
        key_ = ("mesh", npad, k)
        fn = self._request_fns.get(key_)
        if fn is None:
            fn = self._request_fns[key_] = self._mesh_request_fn(k)
        rec = fn(jnp.asarray(users_p), self._users_rep, self._items_sh,
                 self._excl_ids, banned)
        return np.asarray(rec[:n]).astype(np.int64)

    # -- serving -------------------------------------------------------------

    def recommend(self, user_ids: Sequence[int], k: int = 20,
                  banned_items: Optional[np.ndarray] = None) -> np.ndarray:
        """Top-k item ids for a batch of users, never recommending their
        excluded interactions (reference masking semantics,
        trainer.py:149-163). Request size buckets to ``REQ_BLOCK``."""
        from igcn_cf.evaluation.evaluate import mask_topk_core, score

        users = np.asarray(user_ids, dtype=np.int32)
        n = users.shape[0]
        if n == 0:
            return np.zeros((0, k), dtype=np.int64)
        if self.mesh is not None:
            return self._recommend_sharded(users, k, banned_items)
        npad = _pad_to(n, REQ_BLOCK)
        users_p = np.concatenate([users, np.full(npad - n, users[-1], np.int32)])
        n_items = self.model.n_items
        banned_mask = self._banned_mask
        if banned_items is not None:
            banned_mask = banned_mask.at[
                jnp.asarray(np.asarray(banned_items, np.int64))
            ].set(True)
        fn = self._request_fns.get(k)
        if fn is None:
            @jax.jit
            def fn(ur_all, it, excl_all, banned_mask, users):
                return mask_topk_core(
                    score(ur_all[users], it), excl_all[users], banned_mask,
                    k, n_items,
                )

            self._request_fns[k] = fn
        rec = fn(self._users_rep, self._items_t, self._excl_ids, banned_mask,
                 jnp.asarray(users_p))
        return np.asarray(rec[:n]).astype(np.int64)
