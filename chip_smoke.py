"""End-to-end smoke run of the system on a GPU, through the entry points a
user calls, at the Gowalla shape (29,858 users x 40,981 items, ~833k
training interactions; data/synthetic.py, made from a seed).

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # the sharded path on four cards, and the
                                  # same on one card as its comparison

One card, in one process:
  * the device and the card (name, power limit);
  * one epoch of IGCN config 2 (d=64, 3 layers, dropout 0.3, batch 2048)
    through the CLI ``run`` flow, on the data written to disk in the
    processed format: the engines ``auto`` chose and the engine A/B, loss
    finite and falling within the epoch, val Recall/NDCG@20, peak device
    memory, compile seconds;
  * the propagation cache's Triton gather+matmul against its float32
    reference at real widths (error, tolerance) and against XLA's
    gather-then-dot (time);
  * ``Recommender.from_checkpoint`` on that checkpoint over the catalog
    before growth (``dropui``), a few hundred requests against a host
    float32 reference, then one ``refresh`` onto the grown catalog and the
    requests again.

Each phase prints its findings on lines of its own and raises on a failed
check; the last line is one JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Anything but a GPU is an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# config 2 of configs/presets.py (IGCN on Gowalla)
MODEL_CFG = {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
             "dropout": 0.3, "feature_ratio": 1.0}
TRAINER_CFG = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3,
               "l2_reg": 0.0, "aux_reg": 0.01, "n_epochs": 1,
               "batch_size": 2048, "test_batch_size": 512, "topks": [20]}

# Triton gather+matmul vs its float32 reference: the same bf16 operands and
# float32 sums, only the order of summation differs
KERNEL_RTOL = 1e-3
# device scores vs numpy float32: two float32 sums in different orders; ids
# may swap only between scores this close (a tie)
TIE_RTOL = 1e-5
# sharded vs one-card training/eval (dropout off: same batches, only the
# order of float32 sums differs)
LOSS_RTOL = 1e-3
METRIC_ATOL = 2e-3


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def require_gpu(count: int) -> dict:
    import jax

    from igcn_cf.utils.device import card_line, device_record

    dev = device_record()
    if dev["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {dev}")
    if dev["count"] < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {dev}")
    say("device", platform=dev["platform"], kind=repr(dev["kind"]),
        count=dev["count"], jax=jax.__version__)
    print(card_line(), flush=True)
    return dev


class CompileClock:
    """Sums XLA backend compile seconds (JAX's monitoring events)."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, *args, **kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            self.total += duration


def _memory(devices=None) -> str:
    import jax

    from igcn_cf.utils.device import peak_memory_bytes

    return ",".join(
        f"{d.id}:{(peak_memory_bytes(d) or 0) / 2**30:.2f}GiB"
        for d in (devices or jax.devices()[:1])
    )


# -- phases ---------------------------------------------------------------------


def phase_data(work: str, ds=None):
    """The Gowalla-shaped data, written in the processed format."""
    from igcn_cf.data.synthetic import gowalla_shaped

    t0 = time.time()
    ds = ds if ds is not None else gowalla_shaped()
    path = os.path.join(work, "data", "gowalla", "0")
    ds.output(path)
    say("data", users=ds.n_users, items=ds.n_items, train=len(ds),
        seconds=round(time.time() - t0, 3), path=path)
    return ds, path


def phase_train(work: str, data_path: str, clock: CompileClock):
    """One epoch of config 2 through the CLI run flow."""
    import jax

    from igcn_cf.cli.main import main as cli
    from igcn_cf.core.platform import pcache_kernel

    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.time()
        trainer, test_metrics = cli(["run", "--dataset", "gowalla",
                                     "--config", "2", "--data-path",
                                     data_path, "--n-epochs", "1"])
        wall = time.time() - t0
    finally:
        os.chdir(cwd)
    model = trainer.model
    say("engines", graph_engine=model.backend, pcache=model.pcache,
        pcache_kernel=pcache_kernel() if model.pcache else "none",
        engine_ab=json.dumps(model.engine_ab))
    losses = np.asarray(jax.device_get(trainer.last_step_losses))
    tenth = max(1, len(losses) // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    say("train", steps=len(losses), loss_epoch=float(losses.mean()),
        loss_first_tenth=first, loss_last_tenth=last,
        wall_s=round(wall, 3), compile_s=round(clock.total, 3),
        peak_memory=_memory())
    check(bool(np.isfinite(losses).all()), "training loss is not finite")
    check(last < first, "training loss did not fall within the epoch")
    _, val = trainer.eval("val")
    say("eval", split="val", recall20=val["Recall"][20],
        ndcg20=val["NDCG"][20], test_recall20=test_metrics["Recall"][20],
        test_ndcg20=test_metrics["NDCG"][20])
    check(val["NDCG"][20] > 0 and np.isfinite(val["NDCG"][20]),
          "val NDCG@20 is not positive")
    t0 = time.time()
    trainer.eval("val")
    secs = time.time() - t0
    say("eval", one_dispatch_val_s=round(secs, 4),
        users_per_s=round(trainer.dataset.n_users / secs, 1))
    return trainer


def phase_kernel(trainer):
    """The Triton gather+matmul against its float32 reference, and against
    XLA's gather-then-dot, at real widths (3*2048 rows of P)."""
    import jax
    import jax.numpy as jnp

    from igcn_cf.core.platform import pcache_kernel
    from igcn_cf.kernels import pcache as pc
    from igcn_cf.kernels.pcache import attach_pcache
    from igcn_cf.utils.timing import device_ms

    if pcache_kernel() != "triton":
        say("kernel", pcache="xla: no hand-written kernel on this platform")
        return
    p = trainer.buffers.get("pcache")
    if p is None:  # the A/B rejected the cache: build P for the check
        buffers = dict(trainer.buffers)
        model = trainer.model
        keep = model.config.get("prop_cache")
        model.config["prop_cache"] = True
        attach_pcache(model, buffers)
        model.config["prop_cache"] = keep
        p = buffers["pcache"]
    n = trainer.model.n_users + trainer.model.n_items
    r, d = 3 * trainer.batch_size, trainer.model.embedding_size
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    rows = jax.random.randint(k1, (r,), 0, n, dtype=jnp.int32)
    x0b = jax.random.normal(k2, (p.shape[1], d), jnp.float32).astype(
        jnp.bfloat16)
    ctb = jax.random.normal(k3, (r, d), jnp.float32).astype(jnp.bfloat16)
    hi = jax.lax.Precision.HIGHEST
    ref_f = jax.jit(lambda p, rows, x: jnp.dot(
        p[rows].astype(jnp.float32), x.astype(jnp.float32), precision=hi))
    ref_b = jax.jit(lambda p, rows, c: jnp.dot(
        p[rows].astype(jnp.float32).T, c.astype(jnp.float32), precision=hi))
    ker_f = jax.jit(pc.fused_fwd)
    ker_b = jax.jit(pc.fused_bwd)
    for name, ker, ref, xla, arg in (
        ("fwd", ker_f, ref_f, jax.jit(pc.gather_dot_fwd), x0b),
        ("bwd", ker_b, ref_b, jax.jit(pc.gather_dot_bwd), ctb),
    ):
        got, want = ker(p, rows, arg), ref(p, rows, arg)
        err = float(jnp.max(jnp.abs(got - want)))
        scale = float(jnp.max(jnp.abs(want)))
        say("kernel", op=f"pcache_gather_matmul_{name}",
            shape=f"P{tuple(p.shape)}xR{r}xd{d}", max_abs_err=err,
            max_abs_ref=scale, tol=KERNEL_RTOL * scale,
            kernel_ms=round(device_ms(ker, p, rows, arg), 4),
            xla_gather_dot_ms=round(device_ms(xla, p, rows, arg), 4))
        check(err <= KERNEL_RTOL * scale,
              f"pcache kernel {name}: error {err} > {KERNEL_RTOL * scale}")


def _host_topk(users_rep, items_t, users, excl, n_real_items, k):
    s = users_rep[users].astype(np.float32) @ items_t.astype(np.float32)
    s[:, n_real_items:] = -np.inf
    for row, u in enumerate(users):
        if len(excl[u]):
            s[row, np.asarray(excl[u], np.int64)] = -np.inf
    return s, np.argsort(-s, axis=1, kind="stable")[:, :k]


def compare_ids(rec, users, got, k):
    """Device ids against the host float32 reference over the same
    representations: equal, or swapped only within a tie."""
    from igcn_cf.data.padded import real_counts

    ds = rec.model.dataset
    _, n_real_items = real_counts(ds)
    ur = np.asarray(rec._users_rep)
    it = np.asarray(rec._items_t)
    s, want = _host_topk(ur, it, users, ds.train, n_real_items, k)
    equal_rows = int((got == want).all(axis=1).sum())
    ties = bad = 0
    for row in range(len(users)):
        if (got[row] == want[row]).all():
            continue
        sg, sw = s[row, got[row]], s[row, want[row]]
        tol = TIE_RTOL * max(1.0, float(np.abs(sw).max()))
        if np.all(np.abs(sg - sw) <= tol) and np.isfinite(sg).all():
            ties += 1
        else:
            bad += 1
    return equal_rows, ties, bad


def phase_serve(trainer, ds):
    """from_checkpoint on the pre-growth catalog, requests, refresh onto
    the grown catalog, requests again."""
    from igcn_cf.data.padded import real_counts
    from igcn_cf.data.transforms import dropui
    from igcn_cf.serve import Recommender

    ckpt = trainer.save_path
    small = dropui(ds)
    t0 = time.time()
    rec = Recommender.from_checkpoint(ckpt, dict(MODEL_CFG), small)
    say("serve", catalog="dropui", users=small.n_users, items=small.n_items,
        padded=f"{rec.model.n_users}x{rec.model.n_items}",
        from_checkpoint_s=round(time.time() - t0, 3))
    rng = np.random.default_rng(11)
    k = 20
    for stage in ("before_refresh", "after_refresh"):
        n_real_users, _ = real_counts(rec.model.dataset)
        users = rng.choice(n_real_users, size=300, replace=False)
        if stage == "after_refresh":  # include users new to the catalog
            users[:100] = rng.choice(
                np.arange(small.n_users, n_real_users), 100, replace=False)
        got = [rec.recommend(users[i:i + 100], k=k) for i in (0, 100, 200)]
        t0 = time.time()
        got = np.concatenate([rec.recommend(users[i:i + 100], k=k)
                              for i in (0, 100, 200)])
        lat = (time.time() - t0) / 3
        equal_rows, ties, bad = compare_ids(rec, users, got, k)
        say("serve", stage=stage, requests=len(users), k=k,
            rows_equal=equal_rows, rows_tie_swapped=ties, rows_wrong=bad,
            batch100_latency_ms=round(lat * 1e3, 3))
        check(bad == 0, f"serving ids differ from the host reference "
                        f"outside ties ({bad} rows, {stage})")
        if stage == "before_refresh":
            secs = rec.refresh(ds)
            say("serve", refresh_to=f"{ds.n_users}x{ds.n_items}",
                padded=f"{rec.model.n_users}x{rec.model.n_items}",
                refresh_s=round(secs, 3))


def phase_four(ds):
    """ShardedIGCNTrainer on a (1, 4) mesh against the same on one card,
    then sharded serving against one-card serving."""
    import gc

    import jax

    from igcn_cf.core.mesh import make_mesh
    from igcn_cf.core.platform import use_sharded_pcache
    from igcn_cf.models.base import get_model
    from igcn_cf.parallel.trainer import ShardedIGCNTrainer
    from igcn_cf.serve import Recommender

    devs = jax.devices()[:4]
    mc = dict(MODEL_CFG, dropout=0.0)
    say("four", sharded_pcache=use_sharded_pcache(
        ds.n_users, ds.n_items, 4, "auto"),
        note="dropout 0 so both meshes see identical batches")
    results = {}
    for name, mesh_devs in (("table4", devs), ("table1", devs[:1])):
        mesh = make_mesh(mesh_devs, data=1, table=len(mesh_devs))
        t0 = time.time()
        tr = ShardedIGCNTrainer(dict(TRAINER_CFG), ds, mesh, mc)
        build_s = time.time() - t0
        t0 = time.time()
        loss = tr.train_one_epoch()
        epoch_s = time.time() - t0
        _, val = tr.eval("val")
        results[name] = (loss, val)
        say("four", mesh=name, steps=tr.train_state.steps_per_epoch,
            loss_epoch=loss, val_recall20=val["Recall"][20],
            val_ndcg20=val["NDCG"][20], build_s=round(build_s, 3),
            epoch_s=round(epoch_s, 3), peak_memory=_memory(devs))
        del tr
        gc.collect()
    (l4, v4), (l1, v1) = results["table4"], results["table1"]
    say("four", loss_rel_diff=abs(l4 - l1) / abs(l1), loss_rtol=LOSS_RTOL,
        recall_diff=abs(v4["Recall"][20] - v1["Recall"][20]),
        ndcg_diff=abs(v4["NDCG"][20] - v1["NDCG"][20]),
        metric_atol=METRIC_ATOL)
    check(abs(l4 - l1) <= LOSS_RTOL * abs(l1), "sharded loss differs")
    for m in ("Recall", "NDCG"):
        check(abs(v4[m][20] - v1[m][20]) <= METRIC_ATOL,
              f"sharded val {m}@20 differs")

    # serving: one checkpoint (random weights from a seed), served on the
    # (1, 4) mesh and on one card
    model = get_model(dict(MODEL_CFG, prop_cache=False), ds)
    params = model.init_params(jax.random.PRNGKey(3))
    ckpt = os.path.join(HERE, ".cache", "smoke", "four_ckpt.pkl")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    model.save(ckpt, params)
    del model, params
    mesh4 = make_mesh(devs, data=1, table=4)
    one = Recommender.from_checkpoint(ckpt, dict(MODEL_CFG), ds)
    sharded = Recommender.from_checkpoint(ckpt, dict(MODEL_CFG), ds,
                                          mesh=mesh4)
    users = np.random.default_rng(5).choice(ds.n_users, 512, replace=False)
    a = one.recommend(users, k=20)
    b = sharded.recommend(users, k=20)
    equal_rows, ties, bad = compare_ids(one, users, b, 20)
    say("four", serving_requests=len(users),
        rows_equal_to_one_card=int((a == b).all(axis=1).sum()),
        rows_equal_to_host=equal_rows, rows_tie_swapped=ties,
        rows_wrong=bad, peak_memory=_memory(devs))
    check(bad == 0, "sharded serving ids differ outside ties")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded path and its one-card "
                         "comparison only")
    args = ap.parse_args(argv)

    from igcn_cf.core.compile_cache import enable_persistent_cache, state_dir

    dev = require_gpu(4 if args.four else 1)
    enable_persistent_cache()
    clock = CompileClock()
    work = os.path.join(state_dir(), "smoke")
    os.makedirs(work, exist_ok=True)
    t0 = time.time()
    if args.four:
        from igcn_cf.data.synthetic import gowalla_shaped

        phase_four(gowalla_shaped())
    else:
        ds, path = phase_data(work)
        trainer = phase_train(work, path, clock)
        phase_kernel(trainer)
        # the CLI flow saved its best checkpoint relative to ``work``
        trainer.save_path = os.path.join(work, trainer.save_path)
        phase_serve(trainer, ds)
    say("done", seconds=round(time.time() - t0, 3),
        compile_s=round(clock.total, 3))
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
