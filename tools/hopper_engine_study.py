"""Engine and kernel study at the Gowalla shape on one GPU: the numbers
behind core/platform.py's rules (KERNEL_FINDINGS.md).

Times, on the card, inside the full IGCN config-2 training step (dropout
0.3, batch 2048) and inside the full-catalog evaluation:

  * the graph engines: sparse segment-sum, bit-packed dense (plain XLA),
    and the propagation cache on the sparse engine with its gather+matmul
    either as the Triton kernel or as XLA's gather-then-dot;
  * the same pieces alone: INMO feature aggregation with dropout, and the
    3-layer propagation, forward + backward;
  * the P build through the sparse engine;
  * the Triton kernel against gather-then-dot at real widths (error and
    time), over a few tile geometries;
  * evaluation with the chunked exact top-k against flat ``lax.top_k``, and
    exclusion by id lists against packed exclusion bits;
  * a profiler trace of one cached train epoch and one eval, reduced to the
    device time per op name.

    python tools/hopper_engine_study.py --out .cache/study/study.json

Needs a GPU; prints one JSON object at the end and writes it to --out, with
the two profiler traces beside it.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

OUT: dict = {}


def log(*a):
    print(*a, flush=True)


def _trainer(ds, **model_over):
    from igcn_cf.models.base import get_model
    from igcn_cf.train.trainer import get_trainer

    mc = {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
          "dropout": 0.3, "feature_ratio": 1.0, **model_over}
    tc = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3,
          "l2_reg": 0.0, "aux_reg": 0.01, "n_epochs": 1, "batch_size": 2048,
          "test_batch_size": 512, "topks": [20]}
    t0 = time.time()
    model = get_model(mc, ds)
    tr = get_trainer(tc, ds, model)
    return model, tr, time.time() - t0


def time_steps(tr, n_steps):
    tr.steps_per_epoch = lambda: n_steps
    tr._epoch_fn = None
    t0 = time.time()
    tr.train_one_epoch()
    compile_s = time.time() - t0
    t0 = time.time()
    loss = tr.train_one_epoch()
    dt = time.time() - t0
    return {"step_ms": dt / n_steps * 1e3, "compile_s": compile_s,
            "loss": loss}


def device_op_times(trace_dir: str, top: int = 12) -> dict:
    """Sum of device event durations per op name in the newest trace."""
    import glob

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    pd = jax.profiler.ProfileData.from_file(files[-1])
    per, busy, seen = {}, 0.0, []
    for plane in pd.planes:
        seen.append([plane.name, [line.name for line in plane.lines][:8]])
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                per[ev.name] = per.get(ev.name, 0.0) + ev.duration_ns / 1e6
                busy += ev.duration_ns / 1e6
    items = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ms_total": busy, "top_ops_ms": items, "planes": seen}


def kernel_study(p, n):
    from igcn_cf.kernels import pcache as pc
    from igcn_cf.utils.timing import device_ms

    r, d = 3 * 2048, 64
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(5), 3)
    rows = jax.random.randint(k1, (r,), 0, n, dtype=jnp.int32)
    x0b = jax.random.normal(k2, (p.shape[1], d), jnp.float32).astype(
        jnp.bfloat16)
    ctb = jax.random.normal(k3, (r, d), jnp.float32).astype(jnp.bfloat16)
    hi = jax.lax.Precision.HIGHEST
    ref_f = jax.jit(lambda p, rows, x: jnp.dot(
        p[rows].astype(jnp.float32), x.astype(jnp.float32), precision=hi))
    ref_b = jax.jit(lambda p, rows, c: jnp.dot(
        p[rows].astype(jnp.float32).T, c.astype(jnp.float32), precision=hi))
    want_f, want_b = ref_f(p, rows, x0b), ref_b(p, rows, ctb)
    xla_f = jax.jit(pc.gather_dot_fwd)
    xla_b = jax.jit(pc.gather_dot_bwd)
    res = {"xla_fwd_ms": device_ms(xla_f, p, rows, x0b),
           "xla_bwd_ms": device_ms(xla_b, p, rows, ctb),
           "fwd": [], "bwd": []}
    default = (pc.FWD_BR, pc.FWD_BK, pc.FWD_SPLITS, pc.BWD_BR, pc.BWD_BKB,
               pc.NUM_WARPS, pc.NUM_STAGES)
    for br, bk, splits, warps, stages in [
        (64, 128, 8, 4, 3), (64, 64, 8, 4, 3), (128, 128, 4, 8, 3),
        (64, 128, 16, 4, 3), (32, 128, 16, 4, 3), (64, 128, 8, 4, 4),
    ]:
        rec = {"br": br, "bk": bk, "splits": splits, "warps": warps,
               "stages": stages}
        # the geometry is module constants: set, trace, restore below
        pc.FWD_BR, pc.FWD_BK, pc.FWD_SPLITS = br, bk, splits
        pc.NUM_WARPS, pc.NUM_STAGES = warps, stages
        try:
            f = jax.jit(lambda p, rows, x: pc.fused_fwd(p, rows, x))
            got = f(p, rows, x0b)
            rec["max_abs_err"] = float(jnp.max(jnp.abs(got - want_f)))
            rec["max_ref"] = float(jnp.max(jnp.abs(want_f)))
            rec["ms"] = device_ms(f, p, rows, x0b)
        except Exception as e:  # a geometry the compiler refuses
            rec["error"] = f"{type(e).__name__}: {str(e)[:300]}"
        log("fwd", rec)
        res["fwd"].append(rec)
    for br, bkb, warps, stages in [
        (64, 128, 4, 3), (64, 64, 4, 3), (32, 128, 4, 3), (64, 256, 8, 3),
        (128, 128, 8, 3),
    ]:
        rec = {"br": br, "bkb": bkb, "warps": warps, "stages": stages}
        pc.BWD_BR, pc.BWD_BKB = br, bkb
        pc.NUM_WARPS, pc.NUM_STAGES = warps, stages
        try:
            f = jax.jit(lambda p, rows, c: pc.fused_bwd(p, rows, c))
            got = f(p, rows, ctb)
            rec["max_abs_err"] = float(jnp.max(jnp.abs(got - want_b)))
            rec["max_ref"] = float(jnp.max(jnp.abs(want_b)))
            rec["ms"] = device_ms(f, p, rows, ctb)
        except Exception as e:
            rec["error"] = f"{type(e).__name__}: {str(e)[:300]}"
        log("bwd", rec)
        res["bwd"].append(rec)
    (pc.FWD_BR, pc.FWD_BK, pc.FWD_SPLITS, pc.BWD_BR, pc.BWD_BKB,
     pc.NUM_WARPS, pc.NUM_STAGES) = default
    return res


def pieces_study(model, tr):
    """Feature aggregation with dropout, and the 3-layer propagation,
    forward + backward, alone."""
    from igcn_cf.kernels.pcache import engine_ops
    from igcn_cf.utils.timing import device_ms

    params, buffers = tr.params, tr.buffers
    key = jax.random.PRNGKey(1)

    @jax.jit
    def feat(params, buffers, key):
        y, vjp = jax.vjp(lambda p: model.inductive_rep_layer(
            p, buffers, train=True, key=key), params)
        return y, vjp(y)[0]

    _, recompute = engine_ops(model.backend, buffers, model.n_layers)
    n = model.n_users + model.n_items
    x0 = jax.random.normal(key, (n, 64), jnp.float32)

    @jax.jit
    def prop(x0):
        y, vjp = jax.vjp(recompute, x0)
        return y, vjp(y)[0]

    return {"feat_agg_dropout_fwd_bwd_ms": device_ms(feat, params, buffers,
                                                      key),
            "propagation_fwd_bwd_ms": device_ms(prop, x0)}


def eval_study(model, tr, ds):
    import importlib

    ev = importlib.import_module("igcn_cf.evaluation.evaluate")
    from igcn_cf.evaluation.evaluate import (
        _eval_inputs, mask_topk_core, pad_user_blocks, score,
    )

    res = {}
    for name, chunk in (("chunk1024", 1024), ("flat", 1 << 30)):
        ev._TOPK_CHUNK = chunk
        model._jit_cache.clear()
        tr.eval("val")
        t = []
        for _ in range(3):
            t0 = time.time()
            tr.eval("val")
            t.append(time.time() - t0)
        res[f"eval_val_s_{name}"] = sorted(t)[1]
    ev._TOPK_CHUNK = 1024

    # exclusion: id-list scatter (the evaluator's) against packed bits
    rep = model._rep_eval(tr.params, tr.buffers)
    ur, it = rep[:ds.n_users], rep[ds.n_users:].T
    exclude_np, banned_np = _eval_inputs(ds, "val", None)
    users_pad = jnp.asarray(pad_user_blocks(ds.n_users, 512))
    n_items = ds.n_items
    nw = -(-n_items // 32)
    words = np.zeros((ds.n_users, nw), np.uint32)
    for u in range(ds.n_users):
        its = np.asarray(ds.train[u], np.int64)
        np.bitwise_or.at(words[u], its // 32,
                         (np.uint32(1) << (its % 32).astype(np.uint32)))
    words = jnp.asarray(words)
    excl = jnp.asarray(exclude_np)
    banned = jnp.asarray(banned_np)

    @jax.jit
    def ids_path(ur, it, users_pad, excl, banned):
        def body(c, users):
            return c, mask_topk_core(score(ur[users], it), excl[users],
                                     banned, 20, n_items)
        return jax.lax.scan(body, 0, users_pad)[1]

    @jax.jit
    def packed_path(ur, it, users_pad, words, banned):
        shifts = jnp.arange(32, dtype=jnp.uint32)

        def body(c, users):
            s = score(ur[users], it)
            w = words[users]
            bits = ((w[:, :, None] >> shifts) & 1).reshape(w.shape[0], -1)
            s = jnp.where((bits[:, :n_items] > 0) | banned[None, :],
                          -jnp.inf, s)
            return c, ev.exact_topk_ids(s, 20)
        return jax.lax.scan(body, 0, users_pad)[1]

    from igcn_cf.utils.timing import device_ms

    a = ids_path(ur, it, users_pad, excl, banned)
    b = packed_path(ur, it, users_pad, words, banned)
    res["packed_equals_ids"] = bool(jnp.all(a == b))
    res["scan_ids_ms"] = device_ms(ids_path, ur, it, users_pad, excl, banned,
                                   reps=5)
    res["scan_packed_ms"] = device_ms(packed_path, ur, it, users_pad, words,
                                      banned, reps=5)
    res["exclusion_bytes_ids"] = int(excl.size * 4)
    res["exclusion_bytes_packed"] = int(words.size * 4)
    return res


def run(name, fn):
    log(f"== {name}")
    t0 = time.time()
    try:
        OUT[name] = fn()
    except Exception as e:
        OUT[name] = {"error": f"{type(e).__name__}: {e}"}
        traceback.print_exc()
    log(name, json.dumps(OUT[name], default=str)[:2000],
        f"({time.time() - t0:.1f}s)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=".cache/study/study.json")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--tiny", action="store_true",
                    help="rehearse on the CPU at a tiny size")
    args = ap.parse_args()
    out_dir = os.path.dirname(os.path.abspath(args.out))

    from igcn_cf.core.compile_cache import enable_persistent_cache
    from igcn_cf.core.platform import platform
    from igcn_cf.data.synthetic import gowalla_shaped
    import igcn_cf.core.platform as plat
    from igcn_cf.utils.device import card_line, device_record, \
        peak_memory_bytes

    if platform() != "gpu" and not args.tiny:
        raise SystemExit("needs a GPU")
    enable_persistent_cache()
    OUT["device"] = device_record()
    OUT["card"] = card_line()
    OUT["memory_limit"] = plat.device_memory_bytes()
    log("device", OUT["device"], "card", OUT["card"])
    t0 = time.time()
    if args.tiny:
        from igcn_cf.data.synthetic import synthetic_interactions

        ds = synthetic_interactions(n_users=300, n_items=400, avg_degree=15,
                                    seed=1)
    else:
        ds = gowalla_shaped()
    OUT["data_s"] = time.time() - t0
    log("data", ds.n_users, ds.n_items, len(ds), OUT["data_s"])

    # sparse engine with the cache (auto): build + A/B + kernel study
    holder = {}

    def auto():
        model, tr, init_s = _trainer(ds)
        holder["m"], holder["t"] = model, tr
        return {"backend": model.backend, "pcache": model.pcache,
                "engine_ab": model.engine_ab, "init_s": init_s}

    run("auto_init", auto)
    model, tr = holder["m"], holder["t"]
    if not model.pcache:
        del model, tr, holder["m"], holder["t"]
        gc.collect()
        model, tr, _ = _trainer(ds, prop_cache=True)
    if "pcache" in tr.buffers:
        p = tr.buffers["pcache"]
        run("kernel", lambda: kernel_study(p, ds.n_users + ds.n_items))
        run("step_pcache_triton", lambda: time_steps(tr, args.steps))
        orig = plat.pcache_kernel
        plat.pcache_kernel = lambda: "xla"
        run("step_pcache_xla", lambda: time_steps(tr, args.steps))
        plat.pcache_kernel = orig
        tr.steps_per_epoch = lambda: 20
        tr._epoch_fn = None
        tr.train_one_epoch()

        def trace_step():
            d = os.path.join(out_dir, "trace_step")
            with jax.profiler.trace(d):
                jax.block_until_ready(tr.train_one_epoch())
            return device_op_times(d)

        run("trace_pcache_epoch20", trace_step)
    run("pieces_sparse", lambda: pieces_study(model, tr))
    run("eval", lambda: eval_study(model, tr, ds))

    def trace_eval():
        d = os.path.join(out_dir, "trace_eval")
        tr.eval("val")
        with jax.profiler.trace(d):
            tr.eval("val")
        return device_op_times(d)

    run("trace_eval", trace_eval)
    OUT["peak_bytes_auto"] = peak_memory_bytes()
    del model, tr
    holder.clear()
    gc.collect()

    def sparse_plain():
        model, tr, _ = _trainer(ds, prop_cache=False)
        out = time_steps(tr, args.steps)
        return out

    run("step_sparse_recompute", sparse_plain)
    gc.collect()

    def dense_plain():
        model, tr, _ = _trainer(ds, prop_cache=False, graph_backend="dense")
        out = time_steps(tr, 10)
        out.update(pieces_study(model, tr))
        return out

    run("step_dense_bitpack_xla", dense_plain)
    OUT["peak_bytes_end"] = peak_memory_bytes()
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(OUT, f, indent=1, default=str)
    print(json.dumps(OUT, default=str))


if __name__ == "__main__":
    main()
