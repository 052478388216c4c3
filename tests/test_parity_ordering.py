"""Micro-scale model-ordering regression: on a
clustered synthetic dataset, graph propagation must give LightGCN a visible
lift over MF — the reference's headline ordering (MF 11.9 < LightGCN 14.0
NDCG@20 on Gowalla, reference run/plot.py:101-108). The full-scale proxy run
is tools/parity_run.py (artifact PARITY_RESULTS.json); this test pins the
ordering at pytest scale so the generator or the propagation path can't
silently rot."""

import numpy as np
import pytest

from igcn_cf.core.prng import set_seed
from igcn_cf.data.synthetic import synthetic_interactions
from igcn_cf.models.base import get_model
from igcn_cf.train.trainer import get_trainer


@pytest.fixture(scope="module")
def clustered_ds():
    # strong communities + sparse per-user history: a user's own interactions
    # underdetermine their cluster, the 2-hop neighborhood pins it — the
    # regime where propagation beats pure MF (data/synthetic.py docstring)
    return synthetic_interactions(
        n_users=400,
        n_items=500,
        avg_degree=8,
        seed=11,
        name="ordering_micro",
        n_clusters=8,
        cluster_strength=4.0,
    )


def _best_val_ndcg(name, ds, model_extra, n_epochs=40):
    set_seed(2021)
    model = get_model(
        {"name": name, "embedding_size": 32, **model_extra}, ds
    )
    trainer = get_trainer(
        {
            "name": "BPRTrainer",
            "optimizer": "Adam",
            "lr": 5e-3,
            "l2_reg": 1e-4,
            "n_epochs": n_epochs,
            "batch_size": 512,
            "test_batch_size": 256,
            "topks": [20],
            "val_interval": 5,
            "max_patience": 1000,
            "seed": 2021,
        },
        ds,
        model,
    )
    best = trainer.train(verbose=False)
    return float(best)


def test_propagation_lift_lightgcn_over_mf(clustered_ds):
    mf = _best_val_ndcg("MF", clustered_ds, {})
    lgcn = _best_val_ndcg("LightGCN", clustered_ds, {"n_layers": 3})
    assert mf > 0.0
    # the lift must be a real margin, not a coin flip
    assert lgcn > 1.1 * mf, (mf, lgcn)
