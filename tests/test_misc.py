"""Smaller-surface tests: tuning grid, metric writer, CLI parsing, trainer
val_interval, config presets."""

import json
import os

import numpy as np
import pytest

from igcn_cf.configs import get_config, get_gowalla_config, get_yelp_config, get_amazon_config
from igcn_cf.tuning.grid import GRIDS, parameter_grid
from igcn_cf.utils.logging import MetricsWriter
from igcn_cf.utils.meters import AverageMeter


def test_parameter_grid_order():
    """sklearn.ParameterGrid order: sorted keys, last varying fastest
    (reference hyperparameter/mf_tuning.py:27-33 iterates this way)."""
    grid = {"lr": [1, 2], "b": [10, 20]}
    combos = list(parameter_grid(grid))
    assert combos == [
        {"b": 10, "lr": 1},
        {"b": 10, "lr": 2},
        {"b": 20, "lr": 1},
        {"b": 20, "lr": 2},
    ]


def test_grids_cover_reference_models():
    assert set(GRIDS) == {
        "MF", "LightGCN", "IGCN", "IMF", "NGCF", "IMCGAE", "IDCF_LGCN",
        "MultiVAE", "NeuMF", "ItemKNN",
    }
    # reference IGCN grid (hyperparameter/igcn_tuning.py:29-30)
    assert GRIDS["IGCN"]["aux_reg"] == [1e-3, 1e-2, 1e-1]
    assert GRIDS["IGCN"]["dropout"] == [0.0, 0.1, 0.3]


def test_config_presets_match_reference_counts():
    """10 Gowalla, 10 Yelp, 8 Amazon triples (reference config.py);
    index 2 is IGCN everywhere (reference run/run.py:16)."""
    g, y, a = get_gowalla_config(), get_yelp_config(), get_amazon_config()
    assert len(g) == 10 and len(y) == 10 and len(a) == 8
    for cfgs in (g, y, a):
        assert cfgs[2][1]["name"] == "IGCN"
        assert cfgs[2][2]["name"] == "IGCNTrainer"
    # per-dataset tuned values spot checks (reference config.py:7,82,163)
    assert g[0][2]["lr"] == 1e-4 and y[0][2]["lr"] == 1e-3
    assert a[1][2]["l2_reg"] == 1e-5
    # NeuMF neg_ratio=4 datasets (reference config.py:66,141)
    assert g[9][0]["neg_ratio"] == 4 and y[9][0]["neg_ratio"] == 4


def test_get_config_index():
    dc, mc, tc = get_config("gowalla", 0)
    assert mc["name"] == "MF"
    with pytest.raises(IndexError):
        get_config("amazon", 9)


def test_metrics_writer_jsonl(tmp_path):
    w = MetricsWriter(str(tmp_path))
    w.add_scalar("a/b", 0.5, 3)
    w.record("IGCN", "IGCNTrainer", "validation",
             {"NDCG": {20: 0.15}, "Recall": {20: 0.2}}, 7)
    w.close()
    lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    tags = {l["tag"] for l in lines}
    # the reference's scalar naming scheme (reference trainer.py:50-55)
    assert "IGCN_IGCNTrainer/validation_NDCG@20" in tags
    assert "IGCN_IGCNTrainer/validation_Recall@20" in tags
    assert lines[0] == {**lines[0], "tag": "a/b", "value": 0.5, "step": 3}


def test_average_meter():
    m = AverageMeter()
    m.update(2.0, 2)
    m.update(5.0, 1)
    assert m.avg == pytest.approx(3.0)


def test_cli_parser():
    from igcn_cf.cli.main import build_parser

    p = build_parser()
    args = p.parse_args(["run", "--dataset", "yelp", "--config", "5",
                         "--n-epochs", "3", "--resume"])
    assert args.dataset == "yelp" and args.config == 5
    assert args.n_epochs == 3 and args.resume
    args = p.parse_args(["derive", "--kind", "dropui", "--path", "x"])
    assert args.kind == "dropui" and args.ratio == 0.8
    with pytest.raises(SystemExit):
        p.parse_args(["derive", "--kind", "bogus", "--path", "x"])


def test_val_interval_skips_validation(tmp_path, monkeypatch):
    """val_interval=2: validation (and checkpointing) every 2nd epoch only
    (reference trainer.py:80-81)."""
    monkeypatch.chdir(tmp_path)
    from igcn_cf.data.synthetic import synthetic_interactions
    from igcn_cf.models.base import get_model
    from igcn_cf.train.trainer import get_trainer

    ds = synthetic_interactions(n_users=40, n_items=50, avg_degree=8, seed=1)
    model = get_model({"name": "MF", "embedding_size": 8}, ds)
    evals = []
    trainer = get_trainer(
        {"name": "BPRTrainer", "optimizer": "Adam", "lr": 1e-2, "l2_reg": 0.0,
         "batch_size": 64, "test_batch_size": 32, "topks": [5],
         "n_epochs": 4, "val_interval": 2},
        ds, model,
    )
    orig_eval = trainer.eval

    def spy(split, banned_items=None):
        evals.append(split)
        return orig_eval(split, banned_items)

    trainer.eval = spy
    trainer.train(verbose=False)
    assert evals.count("val") == 2  # epochs 1 and 3 only
    # headless (writer=None): the per-epoch train-split eval is skipped —
    # the reference only consumes it through its tensorboard writer
    # (reference trainer.py:76-78)
    assert evals.count("train") == 0

    class _Writer:
        def add_scalar(self, *a, **k):
            pass

        def record(self, *a, **k):
            pass

    evals.clear()
    trainer.start_epoch = 0
    trainer.train(verbose=False, writer=_Writer())
    assert evals.count("train") == 4  # with a writer: every epoch, as ref


def test_choose_backend_budgets(monkeypatch):
    import igcn_cf.core.platform as plat

    # explicit requests pass through
    assert plat.graph_engine(10, 10, "sparse") == "sparse"
    assert plat.graph_engine(10, 10, "dense") == "dense"
    assert plat.graph_engine(10, 10, "dense_lean") == "dense"
    with pytest.raises(ValueError):
        plat.graph_engine(10, 10, "bogus")
    # auto on the CPU is the sparse engine
    assert plat.graph_engine(100, 100, "auto") == "sparse"
    # on the GPU too; an explicit 'dense' must fit the memory budget (its
    # XLA products unpack the interaction matrix to float32)
    monkeypatch.setattr(plat.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(plat, "device_memory_bytes", lambda: 60 * 2**30)
    assert plat.graph_engine(29858, 40981, "auto") == "sparse"
    assert plat.graph_engine(29858, 40981, "dense") == "dense"  # ~15 GiB
    with pytest.raises(ValueError, match="unpacked"):
        plat.graph_engine(1000000, 300000, "dense")


def test_grid_search_end_to_end(tmp_path, monkeypatch):
    """Two-point grid over tiny MF: the tune harness trains per combo,
    reseeds, and returns the argmax (reference hyperparameter flow)."""
    monkeypatch.chdir(tmp_path)
    from igcn_cf.data.synthetic import synthetic_interactions
    from igcn_cf.tuning.grid import grid_search

    ds = synthetic_interactions(n_users=40, n_items=50, avg_degree=8, seed=2)
    ds.output(str(tmp_path / "ds"))
    out = grid_search(
        {"name": "ProcessedDataset", "path": str(tmp_path / "ds")},
        {"name": "MF", "embedding_size": 8},
        {"name": "BPRTrainer", "optimizer": "Adam", "l2_reg": 0.0,
         "batch_size": 64, "test_batch_size": 32, "topks": [5], "n_epochs": 2},
        {"lr": [1e-2, 1e-3]},
        verbose=False,
    )
    assert len(out["trials"]) == 2
    assert out["best_params"] in ({"lr": 1e-2}, {"lr": 1e-3})
    assert out["best_ndcg"] == max(t["ndcg"] for t in out["trials"])


def test_template_ratio_sweep_micro(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from igcn_cf.analysis.plots import template_ratio_sweep
    from igcn_cf.data.synthetic import synthetic_interactions

    ds = synthetic_interactions(n_users=40, n_items=50, avg_degree=8, seed=3)
    ds.output(str(tmp_path / "ds"))
    sweep = template_ratio_sweep(
        {"name": "ProcessedDataset", "path": str(tmp_path / "ds")},
        {"name": "IMF", "embedding_size": 8, "n_layers": 0, "dropout": 0.1,
         "feature_ratio": 1.0},
        {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-2, "l2_reg": 0.0,
         "aux_reg": 0.01, "batch_size": 64, "test_batch_size": 32,
         "topks": [5], "n_epochs": 2},
        ratios=(0.5, 1.0),
        ranking_metrics=("degree",),
    )
    assert sweep["ratio"] == [0.5, 1.0]
    assert len(sweep["degree"]) == 2
    assert all(np.isfinite(v) for v in sweep["degree"])
