"""Population tuning vs the reference-style sequential grid search.

The population trainer batches trials whose hyperparameters are traced
scalars into one compiled program (tuning/population.py); the sequential
loop is the reference's semantics (reference hyperparameter/mf_tuning.py:
25-39). Both reseed the same seed per trial and consume the identical key
stream, so their per-trial best val NDCGs must agree.
"""

import numpy as np
import pytest

from igcn_cf.data.synthetic import synthetic_interactions


@pytest.fixture(scope="module")
def grid_ds(tmp_path_factory):
    ds = synthetic_interactions(n_users=40, n_items=50, avg_degree=8, seed=11)
    path = tmp_path_factory.mktemp("grid_ds") / "ds"
    ds.output(str(path))
    return str(path)


MODEL_CONFIG = {"name": "MF", "embedding_size": 8}
TRAINER_CONFIG = {
    "name": "BPRTrainer", "optimizer": "Adam", "batch_size": 64,
    "test_batch_size": 32, "topks": [5], "n_epochs": 3, "val_interval": 1,
}
GRID = {"lr": [1e-2, 1e-3], "l2_reg": [0.0, 1e-3]}


def test_population_matches_sequential(grid_ds, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from igcn_cf.tuning.grid import grid_search
    from igcn_cf.tuning.population import population_grid_search

    dc = {"name": "ProcessedDataset", "path": grid_ds}
    seq = grid_search(dc, MODEL_CONFIG, dict(TRAINER_CONFIG), GRID, verbose=False)
    pop = population_grid_search(
        dc, MODEL_CONFIG, dict(TRAINER_CONFIG), GRID, verbose=False
    )
    assert [t["params"] for t in seq["trials"]] == [
        t["params"] for t in pop["trials"]
    ]
    seq_ndcg = np.array([t["ndcg"] for t in seq["trials"]])
    pop_ndcg = np.array([t["ndcg"] for t in pop["trials"]])
    np.testing.assert_allclose(pop_ndcg, seq_ndcg, atol=2e-3)
    assert pop["best_params"] == seq["best_params"]


def test_population_sharded_over_mesh(grid_ds, tmp_path, monkeypatch):
    """Trials shard over the device mesh (embarrassingly parallel axis)."""
    monkeypatch.chdir(tmp_path)
    import jax

    from igcn_cf.core.mesh import make_mesh
    from igcn_cf.tuning.population import population_grid_search

    mesh = make_mesh(jax.devices()[:4], data=4, table=1)
    dc = {"name": "ProcessedDataset", "path": grid_ds}
    out = population_grid_search(
        dc, MODEL_CONFIG, dict(TRAINER_CONFIG), GRID, verbose=False, mesh=mesh
    )
    assert len(out["trials"]) == 4
    assert np.isfinite([t["ndcg"] for t in out["trials"]]).all()


def test_tune_preset_auto_routing():
    """'auto' picks population only for BPR-family grids with >1 traced
    combos."""
    from igcn_cf.tuning.grid import GRIDS, _population_profitable

    assert _population_profitable("BPRTrainer", GRIDS["MF"])
    assert _population_profitable("IGCNTrainer", GRIDS["IGCN"])
    assert not _population_profitable("MLTrainer", GRIDS["MultiVAE"])
    assert not _population_profitable("BCETrainer", GRIDS["NeuMF"])
    assert not _population_profitable("BPRTrainer", {"lr": [1e-3]})
