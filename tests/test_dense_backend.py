"""Dense-bipartite backend tests: bit-packed kernel correctness (pack /
matmul / transpose / mask / VJP), parity with the sparse path, and dense-mode
training."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from igcn_cf.kernels.bitpack import (
    TK,
    TM,
    bb_matmul,
    bb_matmul_dropped,
    keep_mask_dense,
    pack_bits,
    pack_interactions,
    packed_lookup,
    unpack_bits_np,
    _seed_from_key,
)
from igcn_cf.kernels.dense_graph import (
    BipartiteDense,
    feat_aggregate,
    ngcf_propagate,
    sym_norm_propagate_mean,
)
from igcn_cf.models.base import get_model
from igcn_cf.train.trainer import get_trainer


def _rep(model_cfg, ds, backend, key=0):
    model = get_model(dict(model_cfg, graph_backend=backend), ds)
    params = model.init_params(jax.random.PRNGKey(key))
    buffers = model.init_buffers()
    rep = model.rep(params, buffers, train=False, key=None)
    return np.asarray(rep), model, params, buffers


@pytest.mark.parametrize("name,extra", [
    ("LightGCN", {"n_layers": 3}),
    ("IGCN", {"n_layers": 2, "dropout": 0.0, "feature_ratio": 1.0}),
    ("IMF", {"n_layers": 0, "dropout": 0.0, "feature_ratio": 1.0}),
    ("IGCN", {"n_layers": 2, "dropout": 0.0, "feature_ratio": 0.7}),
])
def test_dense_matches_sparse_rep(tiny_ds, name, extra):
    cfg = {"name": name, "embedding_size": 16, **extra}
    rep_s, *_ = _rep(cfg, tiny_ds, "sparse")
    rep_d, *_ = _rep(cfg, tiny_ds, "dense")
    scale = np.abs(rep_s).max() + 1e-9
    np.testing.assert_allclose(rep_d / scale, rep_s / scale, atol=2e-2)


# -- bit-packing layout -------------------------------------------------------


def test_pack_unpack_roundtrip(rng):
    b = (rng.random((16, 2 * TK)) < 0.1).astype(np.float32)
    packed = pack_bits(b)
    assert packed.dtype == np.uint32 and packed.shape == (16, 2 * TK // 32)
    np.testing.assert_array_equal(unpack_bits_np(packed), b)


def test_pack_interactions_matches_pack_bits(rng):
    n_rows, n_cols = 100, 5000
    arr = np.stack(
        [rng.integers(0, n_rows, 400), rng.integers(0, n_cols, 400)], axis=1
    )
    packed, mp, kp = pack_interactions(arr, n_rows, n_cols)
    assert mp % TM == 0 and kp % TK == 0
    dense = np.zeros((mp, kp), dtype=np.float32)
    dense[arr[:, 0], arr[:, 1]] = 1.0
    np.testing.assert_array_equal(packed, pack_bits(dense))


def test_packed_lookup(rng):
    n_rows, n_cols = 60, 4500
    arr = np.stack(
        [rng.integers(0, n_rows, 300), rng.integers(0, n_cols, 300)], axis=1
    )
    packed, _, _ = pack_interactions(arr, n_rows, n_cols)
    members = set(map(tuple, arr.tolist()))
    q_rows = rng.integers(0, n_rows, 500)
    q_cols = rng.integers(0, n_cols, 500)
    got = np.asarray(
        packed_lookup(jnp.asarray(packed), jnp.asarray(q_rows), jnp.asarray(q_cols))
    )
    want = np.array([(r, c) in members for r, c in zip(q_rows, q_cols)])
    np.testing.assert_array_equal(got, want)


# -- matmul + VJP correctness -------------------------------------------------


def test_bb_matmul_both_orientations(rng):
    m, k, d = 70, TK + 123, 8
    b = (rng.random((m, k)) < 0.15).astype(np.float32)
    bp = np.zeros((TM, 2 * TK), dtype=np.float32)
    bp[:m, :k] = b
    wp = jnp.asarray(pack_bits(bp))
    x = jnp.asarray(rng.normal(size=(2 * TK, d)).astype(np.float32))
    # bf16 rounding of x across ~600-term row dots: tolerance scales with
    # sqrt(row nnz) * 2^-8
    y = np.asarray(bb_matmul(wp, x, False))
    np.testing.assert_allclose(y[:m], bp[:m] @ np.asarray(x), rtol=2e-2, atol=0.5)
    xu = jnp.asarray(rng.normal(size=(TM, d)).astype(np.float32))
    yt = np.asarray(bb_matmul(wp, xu, True))
    np.testing.assert_allclose(yt, bp.T @ np.asarray(xu), rtol=2e-2, atol=0.5)
    # VJP: d/dx sum(c * Bx) == B^T c
    c = jnp.asarray(rng.normal(size=(TM, d)).astype(np.float32))
    g = np.asarray(jax.grad(lambda x: jnp.sum(c * bb_matmul(wp, x, False)))(x))
    np.testing.assert_allclose(g, bp.T @ np.asarray(c), rtol=2e-2, atol=0.5)


def test_keep_mask_deterministic_rate():
    m1 = np.asarray(keep_mask_dense(1234, 256, TK, 0.3))
    m2 = np.asarray(keep_mask_dense(1234, 256, TK, 0.3))
    np.testing.assert_array_equal(m1, m2)
    assert abs((~m1).mean() - 0.3) < 0.02
    m3 = np.asarray(keep_mask_dense(1235, 256, TK, 0.3))
    assert (m1 != m3).mean() > 0.2  # different seed, different mask
    assert np.asarray(keep_mask_dense(7, 8, TK, 0.0)).all()  # p=0 keeps all


def test_bb_matmul_dropped_fwd_bwd_consistent(rng):
    d, p = 8, 0.4
    b = (rng.random((TM, TK)) < 0.2).astype(np.float32)
    wp = jnp.asarray(pack_bits(b))
    x = jnp.asarray(rng.normal(size=(TK, d)).astype(np.float32))
    key = jax.random.PRNGKey(7)
    seed = int(_seed_from_key(key))

    mask = np.asarray(keep_mask_dense(seed, TM, TK, p))
    y = np.asarray(bb_matmul_dropped(wp, x, key, p, False))
    np.testing.assert_allclose(y, (b * mask) @ np.asarray(x), rtol=2e-2, atol=0.5)

    # gradient must regenerate the SAME mask: d/dx sum(c*(B∘M)x) == (B∘M)^T c
    c = jnp.asarray(rng.normal(size=(TM, d)).astype(np.float32))
    grad = np.asarray(
        jax.grad(lambda x: jnp.sum(c * bb_matmul_dropped(wp, x, key, p, False)))(x)
    )
    np.testing.assert_allclose(
        grad, (b * mask).T @ np.asarray(c), rtol=5e-2, atol=0.5
    )

    # transposed orientation uses the identical canonical-coordinate mask
    xu = jnp.asarray(rng.normal(size=(TM, d)).astype(np.float32))
    yt = np.asarray(bb_matmul_dropped(wp, xu, key, p, True))
    np.testing.assert_allclose(
        yt, (b * mask).T @ np.asarray(xu), rtol=2e-2, atol=0.5
    )


def test_bbt_pair_matches_dense(rng):
    """Transposed-layout pair (round 5): y1t = (B @ x1t^T)^T, y2t =
    (B^T @ x2t^T)^T, plus the swapped-direction VJP."""
    from igcn_cf.kernels.bitpack import bbt_pair

    d = 8
    b = (rng.random((TM, TK)) < 0.15).astype(np.float32)
    wp = jnp.asarray(pack_bits(b))
    x1t = jnp.asarray(rng.normal(size=(d, TK)).astype(np.float32))
    x2t = jnp.asarray(rng.normal(size=(d, TM)).astype(np.float32))
    y1t, y2t = bbt_pair(wp, x1t, x2t)
    np.testing.assert_allclose(
        np.asarray(y1t), np.asarray(x1t) @ b.T, rtol=2e-2, atol=0.5
    )
    np.testing.assert_allclose(
        np.asarray(y2t), np.asarray(x2t) @ b, rtol=2e-2, atol=0.5
    )
    c1 = jnp.asarray(rng.normal(size=(d, TM)).astype(np.float32))
    c2 = jnp.asarray(rng.normal(size=(d, TK)).astype(np.float32))

    def loss(x1t, x2t):
        a, bb = bbt_pair(wp, x1t, x2t)
        return jnp.sum(c1 * a) + jnp.sum(c2 * bb)

    g1, g2 = jax.grad(loss, argnums=(0, 1))(x1t, x2t)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(c1) @ b,
                               rtol=2e-2, atol=0.5)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(c2) @ b.T,
                               rtol=2e-2, atol=0.5)


def test_bbt_pair_dropped_masks_and_vjp(rng):
    """Each direction drops with ITS key; the backward's swapped directions
    carry their original masks (kernels/bitpack.py docstring)."""
    from igcn_cf.kernels.bitpack import bbt_pair_dropped

    d, p = 8, 0.3
    b = (rng.random((TM, TK)) < 0.2).astype(np.float32)
    wp = jnp.asarray(pack_bits(b))
    k1, k2 = jax.random.PRNGKey(3), jax.random.PRNGKey(11)
    m1 = np.asarray(keep_mask_dense(int(_seed_from_key(k1)), TM, TK, p))
    m2 = np.asarray(keep_mask_dense(int(_seed_from_key(k2)), TM, TK, p))
    b1, b2 = b * m1, b * m2
    x1t = jnp.asarray(rng.normal(size=(d, TK)).astype(np.float32))
    x2t = jnp.asarray(rng.normal(size=(d, TM)).astype(np.float32))
    y1t, y2t = bbt_pair_dropped(wp, x1t, x2t, k1, k2, p)
    np.testing.assert_allclose(
        np.asarray(y1t), np.asarray(x1t) @ b1.T, rtol=2e-2, atol=0.5
    )
    np.testing.assert_allclose(
        np.asarray(y2t), np.asarray(x2t) @ b2, rtol=2e-2, atol=0.5
    )
    c1 = jnp.asarray(rng.normal(size=(d, TM)).astype(np.float32))
    c2 = jnp.asarray(rng.normal(size=(d, TK)).astype(np.float32))

    def loss(x1t, x2t):
        a, bb = bbt_pair_dropped(wp, x1t, x2t, k1, k2, p)
        return jnp.sum(c1 * a) + jnp.sum(c2 * bb)

    g1, g2 = jax.grad(loss, argnums=(0, 1))(x1t, x2t)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(c1) @ b1,
                               rtol=5e-2, atol=0.5)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(c2) @ b2.T,
                               rtol=5e-2, atol=0.5)


def test_mask_words_matches_dense_mask(rng):
    """mask_words applies the EXACT keep decision keep_mask_dense describes
    (same _keepword frame): unpacked masked words == B * mask."""
    from igcn_cf.kernels.bitpack import mask_words, _seed_from_key

    p = 0.3
    b = (rng.random((TM, TK)) < 0.2).astype(np.float32)
    wp = jnp.asarray(pack_bits(b))
    key = jax.random.PRNGKey(21)
    w1 = mask_words(wp, key, p)
    mask = np.asarray(keep_mask_dense(int(_seed_from_key(key)), TM, TK, p))
    np.testing.assert_array_equal(unpack_bits_np(np.asarray(w1)), b * mask)


def test_bbt_pair_premasked_matches_dropped(rng):
    """feat_aggregate's premasked training path == the in-kernel masked pair
    (same masks, same dots), including the swapped-operand VJP."""
    from igcn_cf.kernels.bitpack import (
        bbt_pair_dropped,
        bbt_pair_premasked,
        mask_words,
    )

    d, p = 8, 0.3
    b = (rng.random((TM, TK)) < 0.2).astype(np.float32)
    wp = jnp.asarray(pack_bits(b))
    k1, k2 = jax.random.PRNGKey(3), jax.random.PRNGKey(11)
    x1t = jnp.asarray(rng.normal(size=(d, TK)).astype(np.float32))
    x2t = jnp.asarray(rng.normal(size=(d, TM)).astype(np.float32))
    w1, w2 = mask_words(wp, k1, p), mask_words(wp, k2, p)

    want = bbt_pair_dropped(wp, x1t, x2t, k1, k2, p)
    got = bbt_pair_premasked(w1, w2, x1t, x2t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-4)

    c1 = jnp.asarray(rng.normal(size=(d, TM)).astype(np.float32))
    c2 = jnp.asarray(rng.normal(size=(d, TK)).astype(np.float32))

    def loss_pre(x1t, x2t):
        a, bb = bbt_pair_premasked(w1, w2, x1t, x2t)
        return jnp.sum(c1 * a) + jnp.sum(c2 * bb)

    def loss_drop(x1t, x2t):
        a, bb = bbt_pair_dropped(wp, x1t, x2t, k1, k2, p)
        return jnp.sum(c1 * a) + jnp.sum(c2 * bb)

    gp = jax.grad(loss_pre, argnums=(0, 1))(x1t, x2t)
    gd = jax.grad(loss_drop, argnums=(0, 1))(x1t, x2t)
    for g, w in zip(gp, gd):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-4)


def test_bipartite_dense_padding(tiny_ds):
    g = BipartiteDense.build(tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items)
    assert g.B.dtype == jnp.uint32
    assert g.rows_padded % TM == 0 and g.cols_padded % TK == 0
    # bit-count equals the number of interactions (padding all zero)
    bits = unpack_bits_np(np.asarray(g.B))
    assert bits.sum() == len(tiny_ds)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(tiny_ds.n_items, 8)).astype(np.float32))
    y = g.mm_ui(x)
    assert y.shape == (tiny_ds.n_users, 8)


def test_feat_aggregate_dropout_expectation(tiny_ds):
    g = BipartiteDense.build(tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items)
    d = 8
    rng = np.random.default_rng(0)
    e_i = jnp.asarray(rng.normal(size=(tiny_ds.n_items, d)).astype(np.float32))
    e_u = jnp.asarray(rng.normal(size=(tiny_ds.n_users, d)).astype(np.float32))
    tok_u = jnp.asarray(rng.normal(size=(d,)).astype(np.float32))
    tok_i = jnp.asarray(rng.normal(size=(d,)).astype(np.float32))
    w_u = jnp.ones((tiny_ds.n_users,))
    w_i = jnp.ones((tiny_ds.n_items,))
    base = np.asarray(feat_aggregate(g, e_i, e_u, tok_u, tok_i, w_u, w_i))
    samples = []
    for s in range(32):
        samples.append(
            np.asarray(
                feat_aggregate(
                    g, e_i, e_u, tok_u, tok_i, w_u, w_i,
                    dropout=0.3, key=jax.random.PRNGKey(s),
                )
            )
        )
    mean = np.mean(samples, axis=0)
    err = np.abs(mean - base).max() / (np.abs(base).max() + 1e-9)
    assert err < 0.25


def test_igcn_dense_training_runs(tmp_path, monkeypatch, tiny_ds):
    monkeypatch.chdir(tmp_path)
    model_cfg = {
        "name": "IGCN", "embedding_size": 16, "n_layers": 2,
        "dropout": 0.3, "feature_ratio": 1.0, "graph_backend": "dense",
    }
    cfg = {
        "name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-2, "l2_reg": 0.0,
        "aux_reg": 0.01, "batch_size": 128, "test_batch_size": 64,
        "topks": [10], "n_epochs": 3,
    }
    model = get_model(model_cfg, tiny_ds)
    trainer = get_trainer(cfg, tiny_ds, model)
    best = trainer.train(verbose=False)
    assert np.isfinite(best) and best > 0.0


def test_ngcf_propagate_dense_matches_sparse(tiny_ds):
    from igcn_cf.graph.build import l1_norm_adjacency_with_self_loops
    from igcn_cf.kernels.sparse import SparseGraph, spmm

    coo = l1_norm_adjacency_with_self_loops(
        tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items
    )
    sg = SparseGraph.from_coo(coo)
    g = BipartiteDense.build(tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items)
    x = jnp.asarray(
        np.random.default_rng(1)
        .normal(size=(tiny_ds.n_users + tiny_ds.n_items, 8))
        .astype(np.float32)
    )
    a = np.asarray(spmm(sg, x))
    b = np.asarray(ngcf_propagate(g, x))
    np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name,extra", [
    ("NGCF", {"layer_sizes": [16, 16], "dropout": 0.0}),
    ("IMCGAE", {"n_layers": 2, "dropout": 0.0}),
])
def test_dense_matches_sparse_rep_ngcf_imcgae(tiny_ds, name, extra):
    cfg = {"name": name, "embedding_size": 16, **extra}
    rep_s, *_ = _rep(cfg, tiny_ds, "sparse")
    rep_d, *_ = _rep(cfg, tiny_ds, "dense")
    scale = np.abs(rep_s).max() + 1e-9
    np.testing.assert_allclose(rep_d / scale, rep_s / scale, atol=2e-2)


def test_ngcf_dense_training_runs(tmp_path, monkeypatch, tiny_ds):
    monkeypatch.chdir(tmp_path)
    model_cfg = {
        "name": "NGCF", "embedding_size": 16, "layer_sizes": [16, 16],
        "dropout": 0.2, "graph_backend": "dense",
    }
    cfg = {
        "name": "BPRTrainer", "optimizer": "Adam", "lr": 1e-2, "l2_reg": 1e-4,
        "batch_size": 128, "test_batch_size": 64, "topks": [10], "n_epochs": 2,
    }
    model = get_model(model_cfg, tiny_ds)
    trainer = get_trainer(cfg, tiny_ds, model)
    best = trainer.train(verbose=False)
    assert np.isfinite(best) and best > 0.0


def test_imcgae_dense_training_runs(tmp_path, monkeypatch, tiny_ds):
    monkeypatch.chdir(tmp_path)
    model_cfg = {
        "name": "IMCGAE", "embedding_size": 16, "n_layers": 2,
        "dropout": 0.3, "graph_backend": "dense",
    }
    cfg = {
        "name": "BPRTrainer", "optimizer": "Adam", "lr": 1e-2, "l2_reg": 0.0,
        "batch_size": 128, "test_batch_size": 64, "topks": [10], "n_epochs": 2,
    }
    model = get_model(model_cfg, tiny_ds)
    trainer = get_trainer(cfg, tiny_ds, model)
    best = trainer.train(verbose=False)
    assert np.isfinite(best) and best > 0.0


def test_device_build_matches_host_build(tiny_ds):
    """BipartiteDense.build (device scatter pack) is bit-identical to the
    host pack oracle, including with duplicate interaction pairs."""
    from igcn_cf.kernels.dense_graph import BipartiteDense

    a = BipartiteDense.build(tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items)
    b = BipartiteDense.build_host(
        tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items
    )
    np.testing.assert_array_equal(np.asarray(a.B), np.asarray(b.B))
    np.testing.assert_array_equal(np.asarray(a.deg_u), np.asarray(b.deg_u))
    np.testing.assert_array_equal(np.asarray(a.deg_i), np.asarray(b.deg_i))

    # duplicates must not corrupt bits (add==or only holds after dedupe)
    dup = np.concatenate([tiny_ds.train_array, tiny_ds.train_array[:7]])
    c = BipartiteDense.build(dup, tiny_ds.n_users, tiny_ds.n_items)
    np.testing.assert_array_equal(np.asarray(c.B), np.asarray(b.B))

    # empty
    e = BipartiteDense.build(np.zeros((0, 2), np.int64), 4, 4)
    assert not np.asarray(e.B).any()
