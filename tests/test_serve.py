"""Serving API (igcn_cf/serve.py): masked recommendations match the
eval protocol's semantics, the inductive refresh serves users/items unseen
at training time, and checkpoint round-trips work."""

import os

import jax
import numpy as np
import pytest

from igcn_cf.models.base import get_model
from igcn_cf.serve import Recommender
from igcn_cf.train.trainer import get_trainer

MODEL_CFG = {
    "name": "IGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.0,
    "feature_ratio": 1.0, "graph_backend": "dense", "prop_cache": False,
}


def _trained(ds, n_epochs=2):
    model = get_model(dict(MODEL_CFG), ds)
    trainer = get_trainer(
        {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-2,
         "l2_reg": 0.0, "aux_reg": 0.01, "n_epochs": n_epochs,
         "batch_size": 64, "test_batch_size": 64, "topks": [10]},
        ds, model,
    )
    for _ in range(n_epochs):
        trainer.train_one_epoch()
    return trainer


def test_recommend_masks_and_matches_eval(tiny_ds):
    trainer = _trained(tiny_ds)
    rec = Recommender.from_trainer(trainer, exclude="train")
    users = np.array([0, 3, 7, 11, 30], dtype=np.int64)
    out = rec.recommend(users, k=10)
    assert out.shape == (5, 10)
    for row, u in zip(out, users):
        assert len(set(row.tolist())) == 10
        assert not set(row.tolist()) & set(tiny_ds.train[u])

    # matches the evaluator's recommendations (same masking, same scores)
    from igcn_cf.evaluation.evaluate import recommend as eval_recommend

    rfn = trainer.model.make_recommend_fn(trainer.params, trainer.buffers)
    want = eval_recommend(None, tiny_ds, "val", [10], test_batch_size=16,
                          recommend_fn=rfn)
    np.testing.assert_array_equal(out, want[users])


def test_banned_items_respected(tiny_ds):
    trainer = _trained(tiny_ds)
    rec = Recommender.from_trainer(trainer)
    banned = np.arange(0, 40)
    out = rec.recommend(np.arange(10), k=5, banned_items=banned)
    assert not set(out.ravel().tolist()) & set(banned.tolist())


def test_exclude_all_blocks_test_items(tiny_ds):
    trainer = _trained(tiny_ds)
    rec = Recommender.from_trainer(trainer, exclude="all")
    out = rec.recommend(np.arange(tiny_ds.n_users), k=10)
    for u in range(tiny_ds.n_users):
        known = (
            set(tiny_ds.train[u]) | set(tiny_ds.val[u]) | set(tiny_ds.test[u])
        )
        assert not set(out[u].tolist()) & known


def test_inductive_refresh_serves_new_users(tiny_ds, tmp_path):
    """The INMO serving story: train on the dropui (80%) split, refresh over
    the full catalog, and serve users/items that never saw training —
    zero-shot representations, no gradient steps."""
    from igcn_cf.data.transforms import dropui

    reduced = dropui(tiny_ds, 0.8)
    trainer = _trained(reduced)
    path = os.path.join(tmp_path, "ckpt.pkl")
    trainer.model.save(path, trainer.params)

    rec = Recommender.from_checkpoint(path, MODEL_CFG, reduced)
    dt = rec.refresh(tiny_ds)
    assert dt >= 0.0
    new_users = np.arange(reduced.n_users, tiny_ds.n_users)
    assert len(new_users) > 0
    out = rec.recommend(new_users, k=10)
    assert out.shape == (len(new_users), 10)
    # new ITEMS (ids >= reduced.n_items) are servable targets too
    assert (out < tiny_ds.n_items).all() and (out >= 0).all()
    for row, u in zip(out, new_users):
        assert not set(row.tolist()) & set(tiny_ds.train[u])


def test_from_checkpoint_matches_from_trainer(tiny_ds, tmp_path):
    trainer = _trained(tiny_ds)
    path = os.path.join(tmp_path, "ckpt.pkl")
    trainer.model.save(path, trainer.params)
    a = Recommender.from_trainer(trainer)
    b = Recommender.from_checkpoint(path, MODEL_CFG, tiny_ds)
    users = np.arange(0, 20)
    np.testing.assert_array_equal(
        a.recommend(users, k=8), b.recommend(users, k=8)
    )


def test_bad_exclude_raises(tiny_ds):
    trainer = _trained(tiny_ds, n_epochs=1)
    with pytest.raises(ValueError, match="exclude"):
        Recommender.from_trainer(trainer, exclude="none")


def test_sharded_serving_matches_single_chip(tiny_ds):
    """Mesh mode: table-sharded request path returns
    exactly the single-chip recommendations, with and without banned items,
    and still after an inductive refresh."""
    from igcn_cf.core.mesh import make_mesh

    trainer = _trained(tiny_ds)
    mesh = make_mesh(jax.devices()[:8], data=2, table=4)
    single = Recommender.from_trainer(trainer, exclude="train")
    sharded = Recommender(trainer.model, trainer.params, trainer.buffers,
                          exclude="train", mesh=mesh)
    users = np.arange(tiny_ds.n_users, dtype=np.int64)
    for k in (5, 10):
        np.testing.assert_array_equal(
            sharded.recommend(users, k=k), single.recommend(users, k=k)
        )
    banned = np.arange(0, 25)
    np.testing.assert_array_equal(
        sharded.recommend(users[:7], k=5, banned_items=banned),
        single.recommend(users[:7], k=5, banned_items=banned),
    )
    # ghost/padding items can never be recommended
    assert (sharded.recommend(users, k=10) < tiny_ds.n_items).all()

    # inductive refresh flows through the sharded prepare too
    from igcn_cf.data.synthetic import synthetic_interactions

    grown = synthetic_interactions(
        n_users=tiny_ds.n_users + 5, n_items=tiny_ds.n_items + 6,
        avg_degree=6, seed=4,
    )
    sharded.refresh(grown)
    single.refresh(grown)
    gu = np.arange(grown.n_users, dtype=np.int64)
    np.testing.assert_array_equal(
        sharded.recommend(gu, k=8), single.recommend(gu, k=8)
    )
