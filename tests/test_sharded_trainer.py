"""Sharded INMO trainer: full epoch loop over the virtual CPU mesh.

the sharded path must be a real trainer — epoch
scan with device-side positive-excluding sampling and a distinct aux stream,
per-epoch alpha anneal, sharded validation, best-checkpoint/early-stop, and
feature_ratio<1 template support — and it must reach the same quality as the
single-device trainer on the same data.
"""

import os

import jax
import numpy as np
import pytest

from igcn_cf.core.mesh import make_mesh
from igcn_cf.parallel.trainer import ShardedIGCNTrainer


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:8], data=2, table=4)


MODEL_CFG = {
    "name": "IGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.0,
    "feature_ratio": 1.0,
}
TRAIN_CFG = {
    "lr": 1e-2, "l2_reg": 0.0, "aux_reg": 0.01, "batch_size": 128,
    "test_batch_size": 64, "topks": [10], "n_epochs": 8, "val_interval": 2,
    "max_patience": 8,
}


def test_sharded_trainer_matches_single_device(small_ds, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    mesh = make_mesh(jax.devices()[:8], data=2, table=4)
    trainer = ShardedIGCNTrainer(dict(TRAIN_CFG), small_ds, mesh, dict(MODEL_CFG))
    best_sharded = trainer.train(verbose=False)
    assert np.isfinite(best_sharded) and best_sharded > 0.0
    # best checkpoint written, old best deleted (exactly one file)
    cpts = [f for f in os.listdir("checkpoints") if f.startswith("IGCN_Sharded")]
    assert len(cpts) == 1
    # alpha annealed delta^epochs_run
    alpha = float(np.asarray(trainer.train_state.buffers["alpha"]))
    assert abs(alpha - 0.99 ** (trainer.epoch + 1)) < 1e-5

    # single-device reference on the same data/hyperparameters (different
    # init/sampling streams -> statistical, not bitwise, agreement)
    from igcn_cf.models.base import get_model
    from igcn_cf.train.trainer import get_trainer

    model = get_model(dict(MODEL_CFG), small_ds)
    ref = get_trainer(
        dict(TRAIN_CFG, name="IGCNTrainer", optimizer="Adam"), small_ds, model
    )
    best_single = ref.train(verbose=False)
    # reference-matching claim needs a tight band:
    # both trainers run the same data/hyperparameters to (near) convergence,
    # so quality must agree within 15% relative despite distinct init/sampling
    # streams
    assert abs(best_sharded - best_single) <= 0.15 * max(best_sharded, best_single)


def test_sharded_trainer_feature_ratio(small_ds, tmp_path, monkeypatch):
    """feature_ratio < 1: template table shrinks; training + eval still run."""
    monkeypatch.chdir(tmp_path)
    mesh = make_mesh(jax.devices()[:8], data=2, table=4)
    trainer = ShardedIGCNTrainer(
        dict(TRAIN_CFG, n_epochs=2),
        small_ds,
        mesh,
        dict(MODEL_CFG, feature_ratio=0.6, ranking_metric="degree"),
    )
    n_core = len(trainer.train_state.user_map) + len(trainer.train_state.item_map)
    assert n_core < small_ds.n_users + small_ds.n_items
    loss = trainer.train_one_epoch()
    assert np.isfinite(loss)
    _, metrics = trainer.eval("val")
    assert np.isfinite(metrics["NDCG"][10])


def test_sharded_trainer_resume_roundtrip(small_ds, tmp_path, monkeypatch):
    """Full-state save/resume: a run interrupted mid-training and resumed
    from the state file continues from the next epoch with the same best
    metric, patience, alpha and RNG stream."""
    monkeypatch.chdir(tmp_path)
    mesh = make_mesh(jax.devices()[:8], data=2, table=4)
    cfg = dict(TRAIN_CFG, n_epochs=4, val_interval=1, state_interval=1)
    t1 = ShardedIGCNTrainer(dict(cfg), small_ds, mesh, dict(MODEL_CFG))
    t1.train(verbose=False)
    assert os.path.exists(t1.state_path)

    # fresh trainer resumes from the persisted state
    t2 = ShardedIGCNTrainer(dict(cfg), small_ds, mesh, dict(MODEL_CFG))
    t2.load_state(t1.state_path)
    assert t2.start_epoch == t1.epoch + 1
    assert t2.best_ndcg == t1.best_ndcg
    assert t2.patience == t1.patience
    # t1.train() reloaded its BEST checkpoint at the end; the resumed params
    # must match the LAST-epoch params recorded in the state file
    import pickle

    with open(t1.state_path, "rb") as f:
        saved = pickle.load(f)
    np.testing.assert_allclose(
        np.asarray(t2.train_state.params["embedding"]),
        saved["params"]["embedding"],
        rtol=1e-6,
    )
    a2 = float(np.asarray(t2.train_state.buffers["alpha"]))
    assert abs(saved["alpha"] - a2) < 1e-7
    # resumed training continues (start_epoch == n_epochs -> loop is a no-op
    # and best checkpoint reloads); extend the budget and run 1 more epoch
    t2.n_epochs = cfg["n_epochs"] + 1
    best = t2.train(verbose=False)
    assert np.isfinite(best) and t2.epoch == cfg["n_epochs"]


def test_sharded_sampler_streams_distinct(small_ds):
    """Main and aux samplers draw from distinct streams and exclude
    positives (reference trainer.py:287-296, dataset.py:125-128)."""
    from igcn_cf.parallel.steps import build_inmo_sharded_train

    mesh = make_mesh(jax.devices()[:4], data=1, table=4)
    ts = build_inmo_sharded_train(
        small_ds, mesh, embedding_size=8, n_layers=1, dropout=0.0,
        batch_size=64,
    )
    key = jax.random.PRNGKey(3)
    u1, p1, n1 = map(np.asarray, ts.samplers["main"].sample(key, 64))
    u2, p2, n2 = map(np.asarray, ts.samplers["aux"].sample(key, 64))
    # negatives exclude the user's train items
    train_sets = [set(small_ds.train[u]) for u in range(small_ds.n_users)]
    for u, n in zip(u1, n1[:, 0]):
        assert int(n) not in train_sets[int(u)]
    # identity templates: same id space, but an independent draw is used in
    # the epoch (keys are split); with the same key the streams coincide -
    # check the epoch fn splits them by running one epoch and ensuring loss
    # is finite (smoke)
    params, opt_state, loss = ts.epoch_fn(
        ts.params, ts.opt_state, ts.buffers, ts.samplers, key
    )
    assert np.isfinite(float(loss))


def test_sharded_dropui_zero_shot_matches_single_device(tiny_ds, tmp_path,
                                                        monkeypatch):
    """Sharded inductive rebuild: after training on the
    dropui (80%-users/items) split and rebuilding over the full split with
    the SAME template maps and parameters, the zero-shot representations of
    NEW users/items from the sharded path must match the single-chip IGCN
    rebuild on identical parameters."""
    monkeypatch.chdir(tmp_path)
    from igcn_cf.data.transforms import dropui
    from igcn_cf.models.base import get_model

    reduced = dropui(tiny_ds, 0.8)
    mesh = make_mesh(jax.devices()[:8], data=2, table=4)
    trainer = ShardedIGCNTrainer(
        dict(TRAIN_CFG, n_epochs=1, batch_size=64),
        reduced, mesh, dict(MODEL_CFG),
    )
    ts = trainer.train_state

    # single-chip model on the reduced split with the SAME params/maps
    model = get_model(
        dict(MODEL_CFG, graph_backend="dense", prop_cache=False), reduced
    )
    model.user_map, model.item_map = dict(ts.user_map), dict(ts.item_map)
    host_emb = np.asarray(ts.params["embedding"])[: model.n_templates]
    params = {
        "embedding": jax.numpy.asarray(host_emb),
        "w": jax.numpy.asarray(np.asarray(ts.params["w"])),
    }

    # inductive rebuild over the FULL split on both paths
    trainer.rebuild_for(tiny_ds)
    assert trainer.train_state.user_map == ts.user_map  # maps kept
    buffers = model.rebuild_for(tiny_ds)

    users_rep, items_rep = trainer._reps()
    rep_single = model.rep(params, buffers, train=False, key=None)
    n_u, n_i = tiny_ds.n_users, tiny_ds.n_items
    got_u = np.asarray(users_rep)[:n_u]
    got_i = np.asarray(items_rep)[:n_i]
    want_u = np.asarray(rep_single[:n_u])
    want_i = np.asarray(rep_single[n_u : n_u + n_i])
    scale = np.abs(want_u).max() + 1e-9
    # all users/items — including the zero-shot NEW ones past the reduced
    # counts — must agree; tolerance is bf16-matmul scale (the single-chip
    # dense backend runs bit-packed bf16 passes, the sharded path f32
    # segment-sums)
    np.testing.assert_allclose(got_u / scale, want_u / scale, atol=5e-3)
    np.testing.assert_allclose(got_i / scale, want_i / scale, atol=5e-3)
    assert reduced.n_users < n_u and reduced.n_items < n_i  # real new nodes

    # the 6-slice protocol runs end-to-end on the mesh
    out = trainer.inductive_eval(reduced.n_users, reduced.n_items)
    assert set(out) == {
        "all_users_all_items", "old_users_all_items", "new_users_all_items",
        "all_users_old_items", "all_users_new_items", "old_users_old_items",
    }
    for m in out.values():
        assert np.isfinite(m["NDCG"][10])


def test_sharded_dropit_rebuild_runs(tiny_ds, tmp_path, monkeypatch):
    """Sharded dropit: stale-vs-rebuilt eval both run; the rebuilt graph sees
    the full interactions (same node counts)."""
    monkeypatch.chdir(tmp_path)
    from igcn_cf.data.transforms import dropit

    reduced = dropit(tiny_ds, 0.8)
    assert reduced.n_users == tiny_ds.n_users
    mesh = make_mesh(jax.devices()[:8], data=2, table=4)
    trainer = ShardedIGCNTrainer(
        dict(TRAIN_CFG, n_epochs=1, batch_size=64),
        reduced, mesh, dict(MODEL_CFG),
    )
    trainer.train_one_epoch()
    trainer.dataset = tiny_ds  # stale structures
    _, stale = trainer.eval("test")
    trainer.rebuild_for(tiny_ds)
    _, rebuilt = trainer.eval("test")
    assert np.isfinite(stale["NDCG"][10]) and np.isfinite(rebuilt["NDCG"][10])
