"""Benchmark: INMO (IGCN) training and retrieval-eval throughput on one GPU.

Train metric (the headline): per train step — on-device negative sampling,
INMO feature aggregation with edge dropout, 3-layer propagation (through the
propagation cache P = mean_k A^k and its Triton gather+matmul,
kernels/pcache.py, when the measured A/B keeps it; the sparse recompute
otherwise), BPR + auxiliary loss, backward, Adam — all in one jitted
lax.scan, on the Gowalla-shaped synthetic dataset (29,858 users x 40,981
items, ~833k train interactions; data/synthetic.py). Both engines run; the
faster is the headline. Also reported: full-catalog eval users/s with its
scoring + top-k floor, and LightGCN training throughput (the model the 128k
baseline is derived from: the reference's 8007.1 s full LightGCN retrain,
reference run/plot.py:200-201, x1000 epochs over 1,027,464 interactions).

Timing is the host clock around work that ends in a device-to-host read
(``train_one_epoch`` returns the mean loss as a float). Every result names
the device: platform, kind, count and the card's power limit; anything but
a GPU is refused. Roofline figures divide by the peaks of the device's own
kind (``PEAKS``); an unknown kind is an error.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...}.
"""

from __future__ import annotations

import gc
import json
import sys
import time

BATCH_SIZE = 2048
N_STEPS = 200
BASELINE_EXAMPLES_PER_S = 128_000.0

# Dense peaks per device kind, at the full power limit (NVIDIA H100 SXM data
# sheet: 989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores,
# 3.35 TB/s HBM3).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no peak table for device kind {kind!r}")
    return PEAKS[kind]


def _step_model(model, buffers, ds, d, n_layers):
    """Modeled per-step FLOPs and device bytes of the dominant ops.

    Sparse engine: feature aggregation forward + backward over the feat
    edges (train edges both ways + one token edge per node); recompute =
    K SpMMs forward + K backward over the adjacency edges. Cache: the
    gather+matmul over R=3*batch rows of P, forward + backward.
    Loss/Adam/sampling are excluded (so the rates are underestimates)."""
    n = ds.n_users + ds.n_items
    e = 2 * len(ds)  # directed adjacency edges
    r = 3 * BATCH_SIZE
    feat_e = e + n
    feat_flops = 2 * 2 * feat_e * d
    feat_bytes = 2 * (feat_e * (d * 4 * 2 + 8))
    if getattr(model, "pcache", False):
        npad = buffers["pcache"].shape[1]
        prop_flops = 2 * 2 * r * npad * d
        prop_bytes = 2 * (r * npad * 2) + npad * d * 2 + r * d * 4
    else:
        prop_flops = 2 * 2 * n_layers * e * d
        prop_bytes = 2 * n_layers * e * (d * 4 * 2 + 8)
    return feat_flops + prop_flops, feat_bytes + prop_bytes


def _measure_train(trainer, n_steps):
    trainer.steps_per_epoch = lambda: n_steps
    t0 = time.time()
    trainer.train_one_epoch()  # compile + warmup
    compile_s = time.time() - t0
    t0 = time.time()
    loss = trainer.train_one_epoch()  # ends in a device-to-host read
    dt = time.time() - t0
    return dt, float(loss), compile_s


def _run_igcn(ds, prop_cache, peaks):
    from igcn_cf.models.base import get_model
    from igcn_cf.train.trainer import get_trainer

    t0 = time.time()
    model = get_model(
        {
            "name": "IGCN",
            "embedding_size": 64,
            "n_layers": 3,
            "dropout": 0.3,
            "feature_ratio": 1.0,
            "prop_cache": prop_cache,
        },
        ds,
    )
    trainer = get_trainer(
        {
            "name": "IGCNTrainer",
            "optimizer": "Adam",
            "lr": 1e-3,
            "l2_reg": 0.0,
            "aux_reg": 0.01,
            "n_epochs": 1,
            "batch_size": BATCH_SIZE,
            "test_batch_size": 512,
            "topks": [20],
        },
        ds,
        model,
    )
    build_s = time.time() - t0
    engine = "pcache" if getattr(model, "pcache", False) else model.backend
    dt, loss, compile_s = _measure_train(trainer, N_STEPS)
    step_ms = 1000.0 * dt / N_STEPS
    flops, bytes_ = _step_model(model, trainer.buffers, ds, 64, 3)
    # *_modeled: analytic FLOP/byte model of the dominant ops over the
    # measured step time — a roofline aid, not a profiler measurement
    return model, trainer, {
        "engine": engine,
        "step_ms": step_ms,
        "examples_per_s": N_STEPS * BATCH_SIZE / dt,
        "bf16_share_modeled": flops / (step_ms / 1e3) / peaks["bf16_flops"],
        "hbm_gbps_modeled": bytes_ / 1e9 / (step_ms / 1e3),
        "build_s": build_s,
        "compile_s": compile_s,
        "loss": loss,
    }


def main():
    import jax

    from igcn_cf.core.compile_cache import enable_persistent_cache
    from igcn_cf.core.platform import platform
    from igcn_cf.data.synthetic import gowalla_shaped
    from igcn_cf.utils.device import card_line, device_record

    device = device_record()
    if platform() != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {device}")
    peaks = peaks_for(device["kind"])
    device["card"] = card_line()
    print(f"# device {device}", file=sys.stderr)
    print(f"# persistent compile cache: {enable_persistent_cache()}",
          file=sys.stderr)

    t0 = time.time()
    ds = gowalla_shaped()
    print(
        f"# dataset ready in {time.time()-t0:.1f}s: {ds.n_users} users, "
        f"{ds.n_items} items, {len(ds)} interactions",
        file=sys.stderr,
    )

    # -- engine A (auto: the measured A/B keeps the propagation cache when
    # it wins) ----------------------------------------------------------------
    model, trainer, auto_res = _run_igcn(ds, "auto", peaks)
    ab = dict(getattr(model, "engine_ab", None) or {})
    print(f"# auto engine: {auto_res}", file=sys.stderr)

    # retrieval eval: full-catalog masked top-k + metrics over all users,
    # one dispatch (models/base.py::make_eval_fn)
    trainer.eval("val")  # compile
    t0 = time.time()
    trainer.eval("val")
    eval_dt = time.time() - t0
    eval_users_per_s = ds.n_users / eval_dt
    # floor: float32 scoring product (outside the tensor cores at HIGHEST
    # precision) + the score matrix written once and read once by top-k
    score_flops = 2 * ds.n_users * ds.n_items * 64
    score_bytes = 2 * ds.n_users * ds.n_items * 4
    eval_floor_s = max(score_flops / peaks["f32_flops"],
                       score_bytes / peaks["hbm_bytes_per_s"])
    print(f"# eval {ds.n_users} users in {eval_dt:.4f}s", file=sys.stderr)

    # -- engine B (forced recompute) ---------------------------------------
    del model, trainer
    gc.collect()
    _, _, rc_res = _run_igcn(ds, False, peaks)
    print(f"# recompute engine: {rc_res}", file=sys.stderr)
    gc.collect()
    best = max((auto_res, rc_res), key=lambda r: r["examples_per_s"])

    # -- LightGCN: the model the 128k baseline is derived from ---------------
    from igcn_cf.models.base import get_model
    from igcn_cf.train.trainer import get_trainer

    lg_model = get_model(
        {"name": "LightGCN", "embedding_size": 64, "n_layers": 3,
         "prop_cache": "auto"},
        ds,
    )
    lg_trainer = get_trainer(
        {"name": "BPRTrainer", "optimizer": "Adam", "lr": 1e-3,
         "l2_reg": 1e-4, "n_epochs": 1, "batch_size": BATCH_SIZE,
         "test_batch_size": 512, "topks": [20]},
        ds,
        lg_model,
    )
    lg_dt, _, _ = _measure_train(lg_trainer, N_STEPS)
    lgcn_examples_per_s = N_STEPS * BATCH_SIZE / lg_dt

    print(
        json.dumps(
            {
                "metric": "igcn_train_examples_per_s_per_chip",
                "value": best["examples_per_s"],
                "unit": "interactions/s",
                "vs_baseline": best["examples_per_s"] / BASELINE_EXAMPLES_PER_S,
                "device": device,
                "jax": jax.__version__,
                "step_ms": best["step_ms"],
                "engine": best["engine"],
                "engine_ab": {"auto": auto_res, "recompute": rc_res,
                              "init_ab_ms": ab or None},
                "eval_users_per_s": eval_users_per_s,
                "eval_floor_users_per_s": ds.n_users / eval_floor_s,
                "lgcn_engine": "pcache" if lg_model.pcache else lg_model.backend,
                "lgcn_examples_per_s": lgcn_examples_per_s,
                "lgcn_vs_baseline": lgcn_examples_per_s / BASELINE_EXAMPLES_PER_S,
            }
        )
    )


if __name__ == "__main__":
    main()
