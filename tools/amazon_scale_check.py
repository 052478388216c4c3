"""Amazon-book-shaped engine check on one GPU: build the 52,643 x 91,599
catalog (the INMO paper's Amazon-book split shape; reference
dataset.py:228-255), let core/platform.py choose the engine (P is ~42 GB
bf16: inside the memory budget of an 80 GB card, over that of a smaller
one), run a 30-step train scan and print the result as one JSON line.

Run: python tools/amazon_scale_check.py
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from igcn_cf.models.base import get_model
from igcn_cf.train.trainer import get_trainer
from igcn_cf.utils.device import card_line, device_record

N_USERS, N_ITEMS, AVG_DEG = 52643, 91599, 40
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".cache", "amazon_synth.pkl")
N_STEPS = 30
BATCH = 2048


def main():
    if os.path.exists(CACHE):
        with open(CACHE, "rb") as f:
            ds = pickle.load(f)
    else:
        from igcn_cf.data.synthetic import synthetic_interactions

        t0 = time.time()
        ds = synthetic_interactions(
            n_users=N_USERS, n_items=N_ITEMS, avg_degree=AVG_DEG, seed=11,
            name="amazon_scale_synth",
        )
        print(f"generated in {time.time()-t0:.0f}s", flush=True)
        os.makedirs(os.path.dirname(CACHE), exist_ok=True)
        with open(CACHE, "wb") as f:
            pickle.dump(ds, f)
    print(f"{ds.n_users} users {ds.n_items} items {len(ds)} interactions", flush=True)

    model = get_model(
        {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
         "dropout": 0.0, "feature_ratio": 1.0},
        ds,
    )
    print(f"backend: {model.backend}, pcache: {model.pcache}", flush=True)
    trainer = get_trainer(
        {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 0.0,
         "aux_reg": 0.01, "n_epochs": 1, "batch_size": BATCH,
         "test_batch_size": 512, "topks": [20]},
        ds, model,
    )
    trainer.steps_per_epoch = lambda: N_STEPS
    t0 = time.time()
    loss = trainer.train_one_epoch()
    print(f"warmup {N_STEPS} steps (compile) {time.time()-t0:.0f}s "
          f"loss {loss:.4f}", flush=True)
    t0 = time.time()
    loss = trainer.train_one_epoch()  # ends in a device-to-host read
    dt = time.time() - t0
    ex_s = N_STEPS * BATCH / dt
    result = {
        "catalog": [ds.n_users, ds.n_items],
        "interactions": len(ds),
        "backend": model.backend,
        "pcache": bool(model.pcache),
        "steps": N_STEPS,
        "batch_size": BATCH,
        "step_ms": round(1000.0 * dt / N_STEPS, 2),
        "examples_per_s": round(ex_s, 1),
        "loss": round(float(loss), 4),
        "device": device_record(),
        "card": card_line(),
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
