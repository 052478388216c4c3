"""One phase of the grown-catalog serving probe (driven by
tools/bench_serve_grown.py; one process per card: do not run two phases at
once).

Scenario (the INMO headline): a model trained on the
dropui-reduced catalog serves; the catalog GROWS to the full Gowalla shape
(new users + items); the service refreshes inductively — zero gradient
steps. The reference does this in 3.4 s (reference run/plot.py:200-201).

  phase=warm     populate the persistent compilation cache: construct the
                 bucketed Recommender on the reduced catalog, refresh onto
                 the grown one (compiles every executable at both buckets).
  phase=measure  FRESH process (cold in-process jit caches, warm disk
                 cache): same construction, then time refresh(grown) — the
                 number .cache/serve.json reports as refresh_grown_first_s.

Prints one JSON line."""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, ".cache", "serve_grown_ckpt.pkl")

CFG = {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
       "dropout": 0.3, "feature_ratio": 1.0, "prop_cache": False,
       "graph_backend": "sparse"}


def main():
    phase = sys.argv[1]
    if len(sys.argv) > 2:
        CFG["graph_backend"] = sys.argv[2]
    from igcn_cf.data.synthetic import gowalla_shaped
    from igcn_cf.data.padded import bucket_size
    from igcn_cf.data.transforms import dropui
    from igcn_cf.models.base import get_model
    from igcn_cf.serve import Recommender

    import jax

    full = gowalla_shaped()
    reduced = dropui(full, 0.8)

    if not os.path.exists(CKPT):
        model = get_model(dict(CFG), reduced)
        params = model.init_params(jax.random.PRNGKey(0))
        os.makedirs(os.path.dirname(CKPT), exist_ok=True)
        model.save(CKPT, params)
        del model

    t0 = time.time()
    rec = Recommender.from_checkpoint(CKPT, CFG, reduced, bucket=True)
    prepare_s = time.time() - t0

    t0 = time.time()
    rec.refresh(full)
    refresh_grown_s = time.time() - t0

    # servable proof: a real request through the refreshed structures
    out = rec.recommend(np.arange(512, dtype=np.int64), k=20)
    assert out.shape == (512, 20) and (out < full.n_items).all()

    print(json.dumps({
        "phase": phase,
        "backend": CFG["graph_backend"],
        "prepare_s": round(prepare_s, 2),
        "refresh_grown_s": round(refresh_grown_s, 2),
        "reduced_bucket": [bucket_size(reduced.n_users),
                           bucket_size(reduced.n_items)],
        "grown_bucket": [bucket_size(full.n_users),
                         bucket_size(full.n_items)],
    }), flush=True)


if __name__ == "__main__":
    main()
