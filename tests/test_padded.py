"""Catalog-shape bucketing (data/padded.py) and its serving integration:
bucket stability, idempotence, and masking correctness at padded shapes —
ghost items never recommended, real-user results identical to the unpadded
catalog."""

import jax
import numpy as np
import pytest

from igcn_cf.data.padded import (
    ALIGN,
    bucket_size,
    pad_catalog,
    real_counts,
)


def test_bucket_series_properties():
    # monotone, aligned, and covering: bucket(n) >= n, stable for all n in
    # (prev_bucket, bucket]
    prev = 0
    for n in range(1, 200000, 997):
        b = bucket_size(n)
        assert b >= n and b % ALIGN == 0
        assert b >= prev
        prev = b
        assert bucket_size(b) == b  # fixed point
    # within ~growth of each other -> same bucket (the serving story)
    b1 = bucket_size(24000)
    assert bucket_size(int(24000 * 1.02)) == b1 or b1 >= int(24000 * 1.02)
    assert bucket_size(0) == ALIGN


def test_pad_catalog_idempotent_and_ghosts_empty(tiny_ds):
    p1 = pad_catalog(tiny_ds)
    assert p1.n_users % ALIGN == 0 and p1.n_users >= tiny_ds.n_users
    assert real_counts(p1) == (tiny_ds.n_users, tiny_ds.n_items)
    for u in range(tiny_ds.n_users, p1.n_users):
        assert p1.train[u] == [] and p1.val[u] == [] and p1.test[u] == []
    # real rows unchanged, train_array identical
    assert p1.train[: tiny_ds.n_users] == list(tiny_ds.train)
    np.testing.assert_array_equal(p1.train_array, tiny_ds.train_array)
    # re-wrapping never compounds: buckets derive from REAL counts
    p2 = pad_catalog(p1)
    assert (p2.n_users, p2.n_items) == (p1.n_users, p1.n_items)
    assert real_counts(p2) == real_counts(p1)


def test_serve_bucketed_matches_unpadded(tiny_ds, tmp_path):
    """Recommender over the bucketed catalog returns the same top-k for real
    users as over the raw catalog, and never recommends a ghost item."""
    from igcn_cf.models.base import get_model
    from igcn_cf.serve import Recommender

    cfg = {"name": "IGCN", "embedding_size": 16, "n_layers": 2,
           "dropout": 0.0, "feature_ratio": 1.0, "graph_backend": "sparse",
           "prop_cache": False}
    model = get_model(dict(cfg), tiny_ds)
    params = model.init_params(jax.random.PRNGKey(0))
    path = str(tmp_path / "m.pkl")
    model.save(path, params)

    raw = Recommender.from_checkpoint(path, cfg, tiny_ds, bucket=False)
    bkt = Recommender.from_checkpoint(path, cfg, tiny_ds, bucket=True)
    assert bkt.model.n_users % ALIGN == 0
    users = np.arange(tiny_ds.n_users)
    k = 10
    got_raw = raw.recommend(users, k=k)
    got_bkt = bkt.recommend(users, k=k)
    assert (got_bkt < tiny_ds.n_items).all()  # no ghost items
    np.testing.assert_array_equal(got_bkt, got_raw)

    # refresh with a GROWN catalog (same bucket on this tiny shape): shapes
    # unchanged, results still ghost-free and sized to the new real catalog
    from igcn_cf.data.synthetic import synthetic_interactions

    grown = synthetic_interactions(
        n_users=tiny_ds.n_users + 7, n_items=tiny_ds.n_items + 9,
        avg_degree=6, seed=3,
    )
    shapes_before = (bkt.model.n_users, bkt.model.n_items)
    bkt.refresh(grown)
    assert (bkt.model.n_users, bkt.model.n_items) == shapes_before
    out = bkt.recommend(np.arange(grown.n_users), k=k)
    assert (out < grown.n_items).all()
    # parity with an unbucketed recommender over the same grown catalog
    raw2 = Recommender.from_checkpoint(path, cfg, grown, bucket=False)
    np.testing.assert_array_equal(out, raw2.recommend(np.arange(grown.n_users), k=k))


def test_serve_bucketed_bans_ghost_items(tiny_ds, tmp_path, monkeypatch):
    """Force a degenerate rep where ghost items would win the top-k (all
    real scores negative): the ghost ban must keep them out."""
    from igcn_cf.models.base import get_model
    from igcn_cf.serve import Recommender

    cfg = {"name": "MF", "embedding_size": 8}
    model = get_model(dict(cfg), tiny_ds)
    params = model.init_params(jax.random.PRNGKey(0))
    # rig: every real item's embedding = -user embedding direction -> all
    # real scores negative; ghost items score exactly 0
    params = dict(params)
    params["user_embedding"] = jax.numpy.ones_like(params["user_embedding"])
    params["item_embedding"] = -jax.numpy.ones_like(params["item_embedding"])
    path = str(tmp_path / "mf.pkl")
    model.save(path, params)
    bkt = Recommender.from_checkpoint(path, cfg, tiny_ds, bucket=True)
    assert bkt.model.n_items > tiny_ds.n_items  # ghosts exist
    out = bkt.recommend(np.arange(4), k=5)
    assert (out < tiny_ds.n_items).all()
