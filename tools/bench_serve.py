"""Serving benchmark at the Gowalla shape on one GPU -> .cache/serve.json.

Measures the two numbers that define the INMO serving story:

  * ``refresh_s`` — the inductive update: rebuild feat/graph structures over
    a grown dataset and recompute representations + masks, NO training. The
    reference benchmarks this as 3.4 s (INMO-LGCN) / 1.8 s (INMO-MF) on its
    GPU (reference run/plot.py:200-201; BASELINE.md "Inductive-update
    inference time").
  * request latency/throughput — masked top-20 recommendations (float32
    scores, exact two-stage top-k) for request sizes 512 and 4096.

Run: python tools/bench_serve.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, ".cache", "serve.json")


def main():
    from igcn_cf.data.synthetic import gowalla_shaped
    from igcn_cf.data.transforms import dropui
    from igcn_cf.models.base import get_model
    from igcn_cf.serve import Recommender
    from igcn_cf.utils.device import card_line, device_record

    full = gowalla_shaped()
    reduced = dropui(full, 0.8)
    print(f"# train catalog {reduced.n_users}x{reduced.n_items}, serving "
          f"catalog {full.n_users}x{full.n_items}", flush=True)

    # sparse graph backend: serving computes reps ONCE per refresh, so the
    # cheap COO rebuild beats the dense engine's bit-matrix packing cost
    # (the dense engine's advantage is per-step training throughput)
    backend = sys.argv[1] if len(sys.argv) > 1 else "sparse"
    cfg = {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
           "dropout": 0.3, "feature_ratio": 1.0, "prop_cache": False,
           "graph_backend": backend}
    import jax

    model = get_model(dict(cfg), reduced)
    params = model.init_params(jax.random.PRNGKey(0))  # weights don't affect cost
    buffers = model.init_buffers()

    t0 = time.time()
    rec = Recommender(model, params, buffers, exclude="train")
    build_s = time.time() - t0
    print(f"# initial prepare: {build_s:.2f}s", flush=True)

    # inductive update onto the grown catalog (the reference's 3.4 s number)
    refresh_s = rec.refresh(full)
    print(f"# inductive refresh (grown catalog): {refresh_s:.2f}s "
          f"(reference INMO-LGCN: 3.4s)", flush=True)
    # steady-state refresh (same catalog: new interactions arrived)
    refresh2_s = rec.refresh(full)
    print(f"# steady-state refresh: {refresh2_s:.2f}s", flush=True)

    rng = np.random.default_rng(0)
    lat = {}
    for req in (512, 4096):
        users = rng.integers(0, full.n_users, req)
        rec.recommend(users, k=20)  # compile
        t0 = time.time()
        n_reps = 10
        for _ in range(n_reps):
            out = rec.recommend(users, k=20)
        dt = (time.time() - t0) / n_reps
        lat[str(req)] = {
            "latency_ms": round(dt * 1e3, 1),
            "users_per_s": round(req / dt, 1),
        }
        print(f"# request {req}: {dt*1e3:.1f} ms ({req/dt:,.0f} users/s)",
              flush=True)
        assert out.shape == (req, 20)

    # IMF (INMO-MF, no propagation): the reference's other inductive-update
    # number (1.8 s)
    imf = get_model(dict(cfg, name="IMF", n_layers=0), full)
    imf_params = imf.init_params(jax.random.PRNGKey(0))
    rec_imf = Recommender(imf, imf_params, imf.init_buffers(),
                          exclude="train")
    rec_imf.refresh(full)  # warm compiles at this shape
    imf_refresh_s = rec_imf.refresh(full)
    print(f"# IMF steady-state refresh: {imf_refresh_s:.2f}s "
          f"(reference INMO-MF: 1.8s)", flush=True)

    result = {
        "graph_backend": backend,
        "catalog": [full.n_users, full.n_items],
        "train_catalog": [reduced.n_users, reduced.n_items],
        "model": "IGCN",
        "refresh_inductive_s": round(refresh_s, 2),
        "refresh_steady_s": round(refresh2_s, 2),
        "reference_inductive_update_s": 3.4,
        "imf_refresh_steady_s": round(imf_refresh_s, 2),
        "imf_reference_inductive_update_s": 1.8,
        "requests": lat,
        "device": device_record(),
        "card": card_line(),
        "note": (
            "refresh = rebuild graph/feat + recompute reps + rebuild the "
            "exclusion ids, zero gradient steps. refresh_steady_s is the "
            "apples-to-apples number vs the reference's 3.4 s inductive "
            "update (new interactions, fixed catalog shape); "
            "refresh_inductive_s grows the catalog shape and includes "
            "one-time XLA compiles at the new shapes"
        ),
    }
    print(json.dumps(result), flush=True)
    # merge: the grown-catalog probe (tools/bench_serve_grown.py) owns
    # refresh_grown_* and must survive re-runs
    merged = {}
    if os.path.exists(OUT):
        try:
            with open(OUT) as f:
                merged = json.load(f)
        except ValueError:
            merged = {}
    merged.update(result)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(merged, f, indent=1)
    print(f"wrote {OUT}", flush=True)


if __name__ == "__main__":
    main()
