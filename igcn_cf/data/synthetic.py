"""Synthetic interaction datasets for tests and benchmarks.

The reference ships no data (datasets are downloaded separately, reference
README.md). Tests and the bench need deterministic data with the right
statistical shape, so we synthesize power-law bipartite interaction graphs:
item popularity ~ Zipf, per-user degree ~ clipped lognormal — matching the
salient properties (power-law degrees, ~25 avg interactions/user) of
Gowalla/Yelp/Amazon-book.

Community structure: users and items belong to latent clusters and most of a
user's interactions land inside their cluster. This is what gives graph
propagation (LightGCN/IGCN) measurable lift over pure MF on these datasets —
a user's 2-hop neighborhood (co-users of their items) identifies their
cluster far more reliably than their own sparse history, exactly the effect
propagation exploits on the real Gowalla/Yelp/Amazon graphs (reference
ordering: MF 11.9 < IMF 14.1 ≈ LightGCN 14.0 < IGCN 15.3 NDCG@20 on Gowalla,
reference run/plot.py:101-108). A pure low-rank generator (the round-1
version) made propagation useless by construction: with i.i.d. Gaussian
user/item factors of rank << embedding size, MF is already the Bayes-optimal
scorer, and the parity proxy could not detect propagation regressions.
"""

from __future__ import annotations

import numpy as np

from igcn_cf.data.dataset import Interactions


def synthetic_interactions(
    n_users: int = 500,
    n_items: int = 600,
    avg_degree: float = 20.0,
    seed: int = 0,
    zipf_a: float = 1.1,
    name: str = "synthetic",
    split_ratio=(0.7, 0.1, 0.2),
    n_clusters: int | None = None,
    cluster_strength: float = 3.0,
) -> Interactions:
    """Clustered power-law bipartite graph.

    ``n_clusters`` defaults to ~1 cluster per 750 users (min 4); set
    ``cluster_strength=0`` to recover a pure low-rank generator.
    """
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(4, n_users // 750)

    # latent communities: every user/item gets a primary cluster; items are
    # Zipf-popular within and across clusters
    user_cluster = rng.integers(0, n_clusters, size=n_users)
    item_cluster = rng.integers(0, n_clusters, size=n_items)

    # low-rank taste term (weak — real data's signal is mostly neighborhood
    # co-occurrence, which is the cluster term here)
    dim = 8
    u_fac = rng.normal(size=(n_users, dim)) / np.sqrt(dim)
    i_fac = rng.normal(size=(n_items, dim))
    pop = 1.0 / np.power(np.arange(1, n_items + 1), zipf_a)
    rng.shuffle(pop)
    pop_bias = np.log(pop / pop.sum())

    degrees = np.clip(
        rng.lognormal(mean=np.log(avg_degree), sigma=0.6, size=n_users),
        3,
        n_items // 2,
    ).astype(np.int64)

    train, val, test = [], [], []
    # Gumbel noise for a block of users at a time, as numpy's own
    # ``Generator.gumbel`` computes it (-log(-log(1 - U)), one double per
    # sample) but from one ``random`` call per block: the same stream in the
    # same order as one ``gumbel(size=n_items)`` call per user, several
    # times faster. Top-k by argpartition + a sort of the k winners
    # (distinct continuous keys: the same order as a full argsort).
    block = max(1, (1 << 22) // max(n_items, 1))
    for lo in range(0, n_users, block):
        hi = min(lo + block, n_users)
        same_cluster = user_cluster[lo:hi, None] == item_cluster[None, :]
        # Gumbel top-k == sampling without replacement from the softmax of
        # (cluster affinity + taste + popularity)
        keys = (
            cluster_strength * same_cluster.astype(np.float64)
            + 1.0 * (u_fac[lo:hi] @ i_fac.T)
            + 0.5 * pop_bias
        ) - np.log(-np.log(1.0 - rng.random(size=(hi - lo, n_items))))
        for u in range(lo, hi):
            k = int(min(degrees[u], n_items))
            key = keys[u - lo]
            top = np.argpartition(key, n_items - k)[n_items - k:]
            items = top[np.argsort(key[top])][::-1].tolist()
            n = len(items)
            n_train = max(1, int(n * split_ratio[0]))
            n_test = int(n * split_ratio[2])
            train.append(items[:n_train])
            val.append(items[n_train : n - n_test] if n_test else [])
            test.append(items[n - n_test :] if n_test else [])
    ds = Interactions(name, n_users, n_items, train, val, test)
    return ds


# The Gowalla split's shape (the INMO paper's Gowalla: 29,858 users x
# 40,981 items; ~1.03M events -> ~833k train rows after the 70/10/20 split)
GOWALLA_SHAPE = dict(n_users=29858, n_items=40981, avg_degree=34.4,
                     seed=2021, name="gowalla_scale_synth")


def gowalla_shaped() -> Interactions:
    """The Gowalla-shaped synthetic dataset, cached as a pickle in the
    checkout's ``.cache/`` after the first generation (~40 s on one host
    core)."""
    import os
    import pickle

    from igcn_cf.core.compile_cache import state_dir

    path = os.path.join(state_dir(), "gowalla_synth.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    ds = synthetic_interactions(**GOWALLA_SHAPE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(ds, f)
    os.replace(tmp, path)
    return ds
