"""Focused eval-throughput harness: builds IGCN on the recompute engine (no
P build — eval never uses the cache) on the Gowalla-shaped dataset and times
trainer.eval('val') repeatedly, printing per-rep wall and the
rep/scan/metrics breakdown. Usage: python tools/bench_eval.py [reps]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    import jax

    from igcn_cf.data.synthetic import gowalla_shaped
    from igcn_cf.models.base import get_model
    from igcn_cf.train.trainer import get_trainer

    ds = gowalla_shaped()
    print(f"# {ds.n_users} users x {ds.n_items} items", flush=True)
    model = get_model(
        {"name": "IGCN", "embedding_size": 64, "n_layers": 3, "dropout": 0.3,
         "feature_ratio": 1.0, "prop_cache": False},
        ds,
    )
    trainer = get_trainer(
        {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3,
         "l2_reg": 0.0, "aux_reg": 0.01, "n_epochs": 1, "batch_size": 2048,
         "test_batch_size": 512, "topks": [20]},
        ds,
        model,
    )

    t0 = time.time()
    trainer.eval("val")
    print(f"# first eval (compile+exclusion build): {time.time()-t0:.2f}s",
          flush=True)
    for i in range(reps):
        t0 = time.time()
        trainer.eval("val")
        dt = time.time() - t0
        print(f"eval[{i}]: {dt*1e3:7.1f} ms  ({ds.n_users/dt:,.0f} users/s)",
              flush=True)

    # breakdown
    rep_fn = model._get_jit(
        "rep_eval", lambda: (lambda p, b: model.rep(p, b, train=False, key=None))
    )

    def timed(f, warm=1, n=3):
        for _ in range(warm):
            f()
        t0 = time.time()
        for _ in range(n):
            f()
        return (time.time() - t0) / n * 1e3

    from igcn_cf.evaluation.evaluate import recommend
    from igcn_cf.evaluation.metrics import calculate_metrics

    t_rep = timed(lambda: jax.block_until_ready(
        rep_fn(trainer.params, trainer.buffers)))
    rec_fn = model.make_recommend_fn(trainer.params, trainer.buffers)
    t_rec = timed(lambda: recommend(None, ds, "val", [20],
                                    test_batch_size=512, recommend_fn=rec_fn))
    rec = recommend(None, ds, "val", [20], test_batch_size=512,
                    recommend_fn=rec_fn)
    t_met = timed(lambda: calculate_metrics(ds.val, rec, [20]))
    print(f"rep {t_rep:.1f} ms | rec_total {t_rec:.1f} ms "
          f"(scan+topk+copy ~{t_rec - t_rep:.1f}) | metrics {t_met:.1f} ms",
          flush=True)


if __name__ == "__main__":
    main()
