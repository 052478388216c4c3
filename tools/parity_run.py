"""Behavioral parity run: train MF / LightGCN / IGCN / IMF to convergence on
a quarter-Gowalla-scale synthetic dataset and check the reference's model
ordering (MF < LightGCN < IGCN; IMF between MF and IGCN — reference
run/plot.py:101-108, BASELINE.md).

The real Gowalla/Yelp/Amazon dumps cannot be downloaded in this environment
(zero egress), so exact NDCG parity against the published numbers is not
measurable here; the reproducible proxy is the relative ordering and
convergence behavior of the model zoo under the reference's tuned
hyperparameters. Writes results to PARITY_RESULTS.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from igcn_cf.core.prng import set_seed
from igcn_cf.data.synthetic import synthetic_interactions
from igcn_cf.models.base import get_model
from igcn_cf.train.trainer import get_trainer

N_EPOCHS = 300  # MF converges slowest at lr 1e-3 (reference trains 1000)
VAL_INTERVAL = 5
PATIENCE = 30

CONFIGS = [
    ("MF", {"name": "MF", "embedding_size": 64},
     {"name": "BPRTrainer", "lr": 1e-3, "l2_reg": 1e-4}),
    ("LightGCN", {"name": "LightGCN", "embedding_size": 64, "n_layers": 3},
     {"name": "BPRTrainer", "lr": 1e-3, "l2_reg": 1e-4}),
    ("IMF", {"name": "IMF", "embedding_size": 64, "n_layers": 0,
             "dropout": 0.1, "feature_ratio": 1.0},
     {"name": "IGCNTrainer", "lr": 1e-3, "l2_reg": 1e-5, "aux_reg": 0.01}),
    ("IGCN", {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
              "dropout": 0.3, "feature_ratio": 1.0},
     {"name": "IGCNTrainer", "lr": 1e-3, "l2_reg": 0.0, "aux_reg": 0.01}),
]


def main():
    # Gowalla-like DENSITY, not degree: at quarter catalog the reference's
    # ~0.08% density means avg_degree ~9. Density is what decides whether
    # 1-hop aggregation saturates the cluster signal (round-2 synthetic
    # experiments: at 0.8% density IGCN==IMF, at ~0.1-0.3% IGCN>IMF and
    # MF << LightGCN, matching the reference ordering).
    ds = synthetic_interactions(
        n_users=29858 // 4, n_items=40981 // 4, avg_degree=9, seed=77,
        name="parity_q",
    )
    print(f"dataset: {ds.n_users} users {ds.n_items} items {len(ds)} interactions")
    results = {}
    for name, mc, tc in CONFIGS:
        set_seed(2021)
        tc = dict(tc, optimizer="Adam", n_epochs=N_EPOCHS, batch_size=2048,
                  test_batch_size=512, topks=[20], val_interval=VAL_INTERVAL,
                  max_patience=PATIENCE)
        t0 = time.time()
        model = get_model(mc, ds)
        trainer = get_trainer(tc, ds, model)
        best = trainer.train(verbose=False)
        res_str, metrics = trainer.eval("test")
        dt = time.time() - t0
        results[name] = {
            "val_ndcg20": float(best),
            "test": {m: {str(k): v for k, v in d.items()} for m, d in metrics.items()},
            "epochs": trainer.epoch + 1,
            "train_seconds": dt,
            "backend": getattr(model, "backend", "n/a"),
        }
        print(f"{name}: best val NDCG@20 {best:.4f} | test {res_str} | "
              f"{trainer.epoch + 1} epochs in {dt:.0f}s")
        with open("PARITY_RESULTS.json", "w") as f:
            json.dump(results, f, indent=2)

    order = ["MF", "LightGCN", "IGCN"]
    ndcgs = [results[m]["test"]["NDCG"]["20"] for m in order]
    print("ordering MF <= LightGCN <= IGCN:", ndcgs,
          "OK" if ndcgs[0] <= ndcgs[1] <= ndcgs[2] else "VIOLATED")


if __name__ == "__main__":
    main()
