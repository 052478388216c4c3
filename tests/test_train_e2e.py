"""End-to-end training smoke tests: each trainer learns on a tiny synthetic
dataset and beats the popularity floor where it should."""

import os

import numpy as np
import pytest

from igcn_cf.data.synthetic import synthetic_interactions
from igcn_cf.models.base import get_model
from igcn_cf.train.trainer import get_trainer


@pytest.fixture(autouse=True)
def _chdir_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # trainer writes ./checkpoints


def _train(ds, model_cfg, trainer_cfg, n_epochs=8):
    trainer_cfg = dict(trainer_cfg, n_epochs=n_epochs)
    model = get_model(model_cfg, ds)
    trainer = get_trainer(trainer_cfg, ds, model)
    best = trainer.train(verbose=False)
    return trainer, best


BPR_CFG = {
    "name": "BPRTrainer",
    "optimizer": "Adam",
    "lr": 1e-2,
    "l2_reg": 1e-5,
    "batch_size": 256,
    "test_batch_size": 64,
    "topks": [10, 20],
}


def _ds():
    return synthetic_interactions(n_users=80, n_items=100, avg_degree=15, seed=11)


def test_mf_bpr_end_to_end():
    ds = _ds()
    trainer, best = _train(ds, {"name": "MF", "embedding_size": 16}, BPR_CFG)
    assert np.isfinite(best) and 0.0 < best <= 1.0
    results, metrics = trainer.eval("test")
    assert "NDCG" in results and np.isfinite(metrics["NDCG"][10])
    # checkpoint file exists and reload round-trips
    assert trainer.save_path is not None


def test_mf_learns_better_than_popularity():
    ds = _ds()
    _, best_mf = _train(
        ds, {"name": "MF", "embedding_size": 32}, dict(BPR_CFG, lr=5e-2), n_epochs=30
    )
    pop = get_model({"name": "Popularity"}, ds)
    pop_trainer = get_trainer(
        {"name": "BasicTrainer", "n_epochs": 0, "test_batch_size": 64, "topks": [10, 20]},
        ds,
        pop,
    )
    best_pop = pop_trainer.train(verbose=False)
    assert best_mf > best_pop


def test_lightgcn_end_to_end():
    ds = _ds()
    trainer, best = _train(
        ds, {"name": "LightGCN", "embedding_size": 16, "n_layers": 2}, BPR_CFG
    )
    assert np.isfinite(best) and best > 0.0


def test_igcn_end_to_end():
    ds = _ds()
    cfg = dict(BPR_CFG, name="IGCNTrainer", aux_reg=0.01, l2_reg=0.0)
    model_cfg = {
        "name": "IGCN",
        "embedding_size": 16,
        "n_layers": 2,
        "dropout": 0.3,
        "feature_ratio": 1.0,
    }
    trainer, best = _train(ds, model_cfg, cfg)
    assert np.isfinite(best) and best > 0.0
    # anneal advanced alpha
    assert trainer.model.alpha < 1.0


def test_imf_template_ratio():
    ds = _ds()
    cfg = dict(BPR_CFG, name="IGCNTrainer", aux_reg=0.1, l2_reg=1e-5)
    model_cfg = {
        "name": "IMF",
        "embedding_size": 16,
        "n_layers": 0,
        "dropout": 0.1,
        "feature_ratio": 0.8,
        "ranking_metric": "sort",
    }
    trainer, best = _train(ds, model_cfg, cfg)
    assert np.isfinite(best) and best > 0.0
    assert trainer.model.n_templates == int(80 * 0.8) + int(100 * 0.8) + 2


def test_ngcf_end_to_end():
    ds = _ds()
    model_cfg = {
        "name": "NGCF",
        "embedding_size": 16,
        "layer_sizes": [16, 16],
        "dropout": 0.1,
    }
    trainer, best = _train(ds, model_cfg, dict(BPR_CFG, l2_reg=1e-4), n_epochs=5)
    assert np.isfinite(best) and best > 0.0


def test_imcgae_end_to_end():
    ds = _ds()
    model_cfg = {
        "name": "IMCGAE",
        "embedding_size": 16,
        "n_layers": 2,
        "dropout": 0.3,
    }
    trainer, best = _train(ds, model_cfg, dict(BPR_CFG, l2_reg=0.0), n_epochs=5)
    assert np.isfinite(best) and best > 0.0


def test_multivae_end_to_end():
    ds = _ds()
    model_cfg = {"name": "MultiVAE", "layer_sizes": [32, 16], "dropout": 0.5}
    cfg = {
        "name": "MLTrainer",
        "optimizer": "Adam",
        "lr": 1e-3,
        "l2_reg": 1e-4,
        "kl_reg": 0.2,
        "batch_size": 64,
        "test_batch_size": 64,
        "topks": [10, 20],
    }
    trainer, best = _train(ds, model_cfg, cfg, n_epochs=5)
    assert np.isfinite(best) and best > 0.0


def test_neumf_staged_end_to_end():
    ds = _ds()
    ds.neg_ratio = 2
    model_cfg = {"name": "NeuMF", "embedding_size": 8, "layer_sizes": [16, 16]}
    cfg = {
        "name": "BCETrainer",
        "optimizer": "Adam",
        "lr": 1e-3,
        "l2_reg": 1e-4,
        "batch_size": 128,
        "test_batch_size": 32,
        "topks": [10],
        "mf_pretrain_epochs": 2,
        "mlp_pretrain_epochs": 2,
        "max_patience": 100,
    }
    trainer, best = _train(ds, model_cfg, cfg, n_epochs=6)
    assert trainer.model.arch == "neumf"
    assert np.isfinite(best) and best > 0.0


def test_idcf_end_to_end(tmp_path):
    ds = _ds()
    # pretrain a LightGCN and freeze its table for IDCF
    lgcn_trainer, _ = _train(
        ds, {"name": "LightGCN", "embedding_size": 16, "n_layers": 2}, BPR_CFG,
        n_epochs=2,
    )
    lgcn_path = str(tmp_path / "lgcn.pkl")
    lgcn_trainer.model.save(lgcn_path, lgcn_trainer.params)

    model_cfg = {
        "name": "IDCF_LGCN",
        "embedding_size": 16,
        "n_layers": 2,
        "n_headers": 2,
        "n_samples": 10,
        "lgcn_path": lgcn_path,
    }
    cfg = dict(BPR_CFG, name="IDCFTrainer", contrastive_reg=1e-3, l2_reg=1e-4)
    trainer, best = _train(ds, model_cfg, cfg, n_epochs=3)
    assert np.isfinite(best) and best > 0.0


def test_idcf_from_scratch_autopretrains(tmp_path):
    """A missing lgcn_path must auto-train the frozen table instead of
    crashing (the reference requires a manual pretraining run first,
    reference config.py:59)."""
    ds = _ds()
    lgcn_path = str(tmp_path / "auto_lgcn.pkl")
    model_cfg = {
        "name": "IDCF_LGCN",
        "embedding_size": 16,
        "n_layers": 2,
        "n_headers": 2,
        "n_samples": 10,
        "lgcn_path": lgcn_path,
        "lgcn_pretrain_epochs": 2,
        "lgcn_pretrain_val_interval": 1,
        "batch_size": 128,
    }
    cfg = dict(BPR_CFG, name="IDCFTrainer", contrastive_reg=1e-3, l2_reg=1e-4)
    trainer, best = _train(ds, model_cfg, cfg, n_epochs=2)
    assert os.path.exists(lgcn_path)
    assert np.isfinite(best) and best > 0.0
    # the frozen table matches the auto-pretrained checkpoint
    import pickle

    with open(lgcn_path, "rb") as f:
        blob = pickle.load(f)
    assert blob["params"]["embedding"].shape == (ds.n_users + ds.n_items, 16)


def test_itemknn_eval():
    ds = _ds()
    model = get_model({"name": "ItemKNN", "k": 20}, ds)
    trainer = get_trainer(
        {"name": "BasicTrainer", "n_epochs": 0, "test_batch_size": 64, "topks": [10]},
        ds,
        model,
    )
    best = trainer.train(verbose=False)
    assert np.isfinite(best) and best > 0.0


def test_early_stopping():
    ds = _ds()
    cfg = dict(BPR_CFG, max_patience=2, val_interval=1, lr=0.0)  # never improves
    trainer, _ = _train(ds, {"name": "MF", "embedding_size": 8}, cfg, n_epochs=50)
    assert trainer.epoch < 49  # stopped early
