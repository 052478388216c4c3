"""Negative sampling for BPR/BCE training.

The reference samples on the host inside 6 DataLoader worker processes: each
example draws a random user with >=1 train item, a uniform positive from that
user's train items, and ``neg_ratio`` uniform negatives rejection-sampled
against the user's train set (reference dataset.py:119-131,
trainer.py:226-227).

Here sampling is a device-side jitted function over a padded-CSR view of the
train lists — no host processes, no H2D copies per batch:

  * users: uniform over users with >=1 train item (categorical over a static
    id list);
  * positives: uniform index into the user's CSR row (modulo its degree);
  * negatives: uniform item draws with a fixed-budget retry loop; membership
    is tested by binary search over the user's sorted item row. With
    ``MAX_RETRIES=16`` the probability a true positive survives for a user
    with density p is p^16 — below 1e-8 even at p=0.3 — a documented,
    quantified deviation from the reference's unbounded rejection loop
    (SURVEY.md §7 hard part 3).

A numpy host implementation with identical semantics is kept for oracle tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

MAX_RETRIES = 16


def _row_contains(sorted_row: jnp.ndarray, queries: jnp.ndarray) -> jnp.ndarray:
    """Membership of each query in one sorted row (padded with a sentinel
    larger than any item id, so padding never matches)."""
    idx = jnp.searchsorted(sorted_row, queries)
    idx = jnp.minimum(idx, sorted_row.shape[0] - 1)
    return sorted_row[idx] == queries


def _searchsorted_rows(sorted_rows: jnp.ndarray, queries: jnp.ndarray) -> jnp.ndarray:
    """Membership of queries[b] in sorted_rows[b, :] for each row b."""
    return jax.vmap(_row_contains)(sorted_rows, queries[:, None])[:, 0]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["active_users", "user_items", "user_degree", "dense_b"],
    meta_fields=["n_items"],
)
@dataclass(frozen=True)
class DeviceNegativeSampler:
    """Device-resident padded view of the train lists for sampling.

    Attributes
    ----------
    active_users : (A,) ids of users with >=1 train item
    user_items   : (n_users, max_deg) per-user sorted train items, padded with
                   ``n_items`` (an id one past the catalog, compares greater
                   than every valid item)
    user_degree  : (n_users,) train degrees
    dense_b      : optional interaction matrix shared with the dense graph
                   engine for O(1) membership lookups instead of
                   per-candidate binary search: either the bit-packed uint32
                   layout (kernels/bitpack.py; the round-2 engine) or a dense
                   int8 0/1 matrix
    n_items      : catalog size (static)
    """

    active_users: jnp.ndarray
    user_items: jnp.ndarray
    user_degree: jnp.ndarray
    dense_b: jnp.ndarray | None
    n_items: int

    def with_dense_b(self, dense_b: jnp.ndarray) -> "DeviceNegativeSampler":
        return DeviceNegativeSampler(
            self.active_users, self.user_items, self.user_degree, dense_b,
            self.n_items,
        )

    @staticmethod
    def build(ds) -> "DeviceNegativeSampler":
        n_users, n_items = ds.n_users, ds.n_items
        degs = np.array([len(ds.train[u]) for u in range(n_users)], dtype=np.int32)
        max_deg = max(1, int(degs.max()) if n_users else 1)
        padded = np.full((n_users, max_deg), n_items, dtype=np.int32)
        for u in range(n_users):
            row = np.sort(np.asarray(ds.train[u], dtype=np.int32))
            padded[u, : len(row)] = row
        active = np.nonzero(degs > 0)[0].astype(np.int32)
        return DeviceNegativeSampler(
            active_users=jnp.asarray(active),
            user_items=jnp.asarray(padded),
            user_degree=jnp.asarray(degs),
            dense_b=None,
            n_items=int(n_items),
        )

    @partial(jax.jit, static_argnames=("batch_size", "neg_ratio"))
    def sample(self, key: jax.Array, batch_size: int, neg_ratio: int = 1):
        """Sample a batch of (user, pos, neg) int32 triples.

        Returns (users, pos, negs) with users/pos of shape (B,) and negs of
        shape (B, neg_ratio) — the reference emits [neg_ratio, 3] rows but its
        BPR trainers consume only row 0 (trainer.py:234) while the BCE trainer
        consumes all rows (trainer.py:348-355); exposing negs as (B, R) covers
        both.
        """
        ku, kp, kn = jax.random.split(key, 3)
        uidx = jax.random.randint(ku, (batch_size,), 0, self.active_users.shape[0])
        users = self.active_users[uidx]
        deg = self.user_degree[users]
        pos_idx = jax.random.randint(kp, (batch_size,), 0, jnp.iinfo(jnp.int32).max) % deg
        rows = self.user_items[users]
        pos = jnp.take_along_axis(rows, pos_idx[:, None], axis=1)[:, 0]

        # all retry candidates drawn at once; membership tested in ONE pass,
        # then the first non-positive per slot wins — no sequential retry
        # scan. With a dense interaction matrix attached, membership is a
        # single elementwise lookup B[user, cand] instead of binary search.
        cand = jax.random.randint(
            kn, (batch_size, neg_ratio, MAX_RETRIES), 0, self.n_items
        )
        if self.dense_b is not None:
            users_b = jnp.broadcast_to(users[:, None], (batch_size, neg_ratio * MAX_RETRIES))
            if self.dense_b.dtype == jnp.uint32:  # bit-packed layout
                from igcn_cf.kernels.bitpack import packed_lookup

                is_pos = packed_lookup(
                    self.dense_b, users_b.reshape(-1), cand.reshape(-1)
                ).reshape(cand.shape)
            else:
                is_pos = (
                    self.dense_b[users_b.reshape(-1), cand.reshape(-1)] > 0
                ).reshape(cand.shape)
        else:
            is_pos = jax.vmap(
                lambda row, q: _row_contains(row, q)
            )(rows, cand.reshape(batch_size, -1)).reshape(cand.shape)
        ok = ~is_pos
        # argmax of bool finds the first acceptable candidate; if all
        # MAX_RETRIES collide (prob p^MAX_RETRIES), slot 0 is used — a
        # quantified deviation from the reference's unbounded loop
        first = jnp.argmax(ok, axis=-1)
        negs = jnp.take_along_axis(cand, first[..., None], axis=-1)[..., 0]
        return users, pos, negs


def sample_bpr_epoch(ds, rng: np.random.Generator, n_samples: int, neg_ratio: int = 1):
    """Host (numpy) sampler with the reference's exact semantics; used as the
    test oracle and for tiny CPU runs (reference dataset.py:119-131)."""
    degs = np.array([len(ds.train[u]) for u in range(ds.n_users)], dtype=np.int64)
    active = np.nonzero(degs > 0)[0]
    sorted_rows = [np.sort(np.asarray(ds.train[u], dtype=np.int64)) for u in range(ds.n_users)]

    users = rng.choice(active, size=n_samples)
    pos = np.array([sorted_rows[u][rng.integers(0, degs[u])] for u in users])
    negs = np.empty((n_samples, neg_ratio), dtype=np.int64)
    for r in range(neg_ratio):
        cand = rng.integers(0, ds.n_items, size=n_samples)
        for b in range(n_samples):
            while np.searchsorted(sorted_rows[users[b]], cand[b]) < degs[users[b]] and \
                    sorted_rows[users[b]][np.searchsorted(sorted_rows[users[b]], cand[b])] == cand[b]:
                cand[b] = rng.integers(0, ds.n_items)
        negs[:, r] = cand
    return users.astype(np.int64), pos, negs
