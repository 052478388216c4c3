"""Propagation-cache tests: the precomputed P = mean_k A^k operator
(kernels/pcache.py) against the dense NumPy oracle, built through either
graph engine; the gather+matmul forward/backward (the gather-then-dot
reference, and the Triton kernel in interpret mode against it); train-path
parity of IGCN/LightGCN with the cache on vs the exact recompute path; and
end-to-end metric parity of a short training run on both engines."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import igcn_cf.core.platform as platform
from igcn_cf.core.platform import use_pcache
from igcn_cf.graph.build import sym_norm_adjacency
from igcn_cf.kernels.dense_graph import BipartiteDense, sym_norm_propagate
from igcn_cf.kernels.pcache import (
    BWD_BR,
    FWD_BR,
    build_prop_cache,
    cached_prop,
    fused_bwd,
    gather_dot_bwd,
    gather_dot_fwd,
    pcache_bytes,
    prop_cache_oracle,
)
from igcn_cf.kernels.sparse import SparseGraph, spmm
from igcn_cf.models.base import get_model

# bf16 storage: ~2^-8 relative per entry; P entries are in [0, 1]
BF16_ATOL = 8e-3


def _bip(ds):
    return BipartiteDense.build(ds.train_array, ds.n_users, ds.n_items)


def _sparse(ds):
    """One A @ x step of the sparse engine, as the build's (fn, graph)."""
    adj = sym_norm_adjacency(ds.train_array, ds.n_users, ds.n_items)
    return spmm, SparseGraph.from_coo(adj)


def _p(ds, k):
    return build_prop_cache(_sparse(ds), ds.n_users + ds.n_items, k)


def test_build_matches_oracle(tiny_ds):
    n = tiny_ds.n_users + tiny_ds.n_items
    for k in (1, 3):
        p = np.asarray(_p(tiny_ds, k), dtype=np.float32)
        assert p.ndim == 2
        oracle = prop_cache_oracle(
            tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items, k
        )
        assert p.shape[0] == n and p.shape[1] >= n
        np.testing.assert_allclose(p[:, :n], oracle, atol=BF16_ATOL)
        # padding columns must be exactly zero
        assert not p[:, n:].any()
        # P is symmetric (A is): stored rows double as columns in backward
        np.testing.assert_allclose(p[:, :n], p[:, :n].T, atol=BF16_ATOL)


def test_build_through_dense_engine_matches_sparse(tiny_ds):
    """The build takes whichever engine the model chose: the bit-packed
    engine's one-layer step gives the same P as the sparse engine's."""
    n = tiny_ds.n_users + tiny_ds.n_items
    got = build_prop_cache((sym_norm_propagate, _bip(tiny_ds)), n, 2)
    want = _p(tiny_ds, 2)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=8e-3)


def test_cached_prop_forward_and_grad(tiny_ds):
    n = tiny_ds.n_users + tiny_ds.n_items
    p = _p(tiny_ds, 2)
    key = jax.random.PRNGKey(0)
    x0 = jax.random.normal(key, (n, 8), jnp.float32)
    rows = jnp.asarray([0, 5, tiny_ds.n_users + 3, n - 1], jnp.int32)

    out = cached_prop(p, rows, x0)
    oracle = prop_cache_oracle(
        tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items, 2
    )
    want = oracle[np.asarray(rows)] @ np.asarray(x0)
    np.testing.assert_allclose(np.asarray(out), want, atol=0.05, rtol=0.05)

    # backward: d/dx0 sum(P[rows] @ x0 * c) == P[rows]^T @ c, via the same
    # bf16 rows — compare against the explicit contraction
    c = jax.random.normal(jax.random.PRNGKey(1), out.shape, jnp.float32)
    g = jax.grad(lambda x: jnp.sum(cached_prop(p, rows, x) * c))(x0)
    p_rows = np.asarray(p, np.float32)[np.asarray(rows)]
    want_g = p_rows[:, :n].T @ np.asarray(c)
    np.testing.assert_allclose(np.asarray(g), want_g, atol=3e-3, rtol=3e-2)


def _kernel_case(n, npad, d, r, seed=0):
    rng = np.random.default_rng(seed)
    p = jnp.asarray(rng.standard_normal((n, npad)).astype(np.float32)).astype(
        jnp.bfloat16
    )
    rows = jnp.asarray(rng.integers(0, n, size=r).astype(np.int32))
    x0 = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    ct = jnp.asarray(rng.standard_normal((r, d)).astype(np.float32))
    return p, rows, x0, ct


@pytest.mark.parametrize("r", [FWD_BR, 3 * FWD_BR, 2 * FWD_BR + 17])
def test_triton_kernel_interpret_forward(r):
    """The Triton gather+matmul forward (interpret mode: the kernel's
    indexing, split loop and partial-sum pass, not Triton's compiler)
    against gather-then-dot, at row counts that do and do not divide the
    block, with several column splits."""
    p, rows, x0, _ = _kernel_case(300, 2048, 32, r)
    x0b = jnp.concatenate(
        [x0, jnp.zeros((2048 - 300, 32), x0.dtype)]
    ).astype(jnp.bfloat16)
    want = gather_dot_fwd(p, rows, x0b)
    got = cached_prop(p, rows, x0, kernel="interpret")
    assert got.shape == (r, 32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("r", [BWD_BR, 2 * BWD_BR + 5])
def test_triton_kernel_interpret_backward(r):
    """The Triton backward: P[rows]^T @ ct per column stripe; padded rows
    (row counts not dividing the block) carry zero cotangent and add
    nothing."""
    p, rows, x0, ct = _kernel_case(200, 1024, 16, r, seed=1)
    want = gather_dot_bwd(p, rows, ct.astype(jnp.bfloat16))
    rp = -(-r // BWD_BR) * BWD_BR
    rows_p = jnp.concatenate([rows, jnp.zeros(rp - r, rows.dtype)])
    ct_p = jnp.concatenate([ct, jnp.zeros((rp - r, 16), ct.dtype)])
    got = fused_bwd(p, rows_p, ct_p.astype(jnp.bfloat16), interpret=True)
    assert got.shape == (1024, 16)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


def test_triton_kernel_custom_vjp_matches_reference():
    """cached_prop's custom VJP through the kernel (interpret mode) equals
    the one through gather-then-dot: same forward, same dX0 (sliced back
    to the n real rows)."""
    p, rows, x0, ct = _kernel_case(150, 1024, 16, 100, seed=2)

    def run(kernel):
        y, vjp = jax.vjp(lambda x: cached_prop(p, rows, x, kernel=kernel), x0)
        return y, vjp(ct)[0]

    y_ref, g_ref = run("xla")
    y, g = run("interpret")
    assert g.shape == x0.shape
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-4)


def _pieces(name, ds, prop_cache, extra, drop_key=None):
    cfg = {
        "name": name,
        "embedding_size": 16,
        "n_layers": 2,
        "graph_backend": "dense",
        "prop_cache": prop_cache,
        **extra,
    }
    model = get_model(cfg, ds)
    assert model.pcache is bool(prop_cache)
    params = model.init_params(jax.random.PRNGKey(3))
    buffers = model.init_buffers()
    users = jnp.asarray([1, 4, 9], jnp.int32)
    pos = jnp.asarray([0, 2, 7], jnp.int32)
    neg = jnp.asarray([5, 5, 1], jnp.int32)

    def loss(p):
        u, pp, nn, l2 = model.bpr_pieces(
            p, buffers, users, pos, neg, train=True, key=drop_key
        )
        return (
            jnp.sum(u * pp) - jnp.sum(u * nn) + 0.1 * jnp.sum(l2)
        )

    val, grads = jax.value_and_grad(loss)(params)
    return np.asarray(val), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize(
    "name,extra",
    [
        ("LightGCN", {}),
        ("IGCN", {"dropout": 0.0, "feature_ratio": 1.0}),
        ("IGCN", {"dropout": 0.0, "feature_ratio": 0.7}),
    ],
)
def test_train_path_parity(tiny_ds, name, extra):
    """Loss and gradients through the cached operator match the exact
    recompute path to bf16-storage tolerance."""
    v_exact, g_exact = _pieces(name, tiny_ds, False, extra)
    v_cache, g_cache = _pieces(name, tiny_ds, True, extra)
    np.testing.assert_allclose(v_cache, v_exact, rtol=2e-2, atol=2e-2)

    def check(a, b):
        scale = np.abs(a).max() + 1e-6
        np.testing.assert_allclose(b / scale, a / scale, atol=3e-2)

    jax.tree_util.tree_map(check, g_exact, g_cache)


def test_igcn_pcache_with_dropout_runs(tiny_ds):
    """Dropout applies to the feat layer only; the cached path must accept a
    dropout key and stay finite."""
    v, g = _pieces(
        "IGCN",
        tiny_ds,
        True,
        {"dropout": 0.3, "feature_ratio": 1.0},
        drop_key=jax.random.PRNGKey(11),
    )
    assert np.isfinite(v)
    assert all(np.isfinite(x).all() for x in jax.tree_util.tree_leaves(g))


def test_engine_end_to_end_metric_parity(tiny_ds):
    """The bf16 cached operator must not change converged quality — train the same IGCN for a few epochs on both engines and
    compare best val NDCG."""
    from igcn_cf.train.trainer import get_trainer

    def run(prop_cache):
        model = get_model(
            {
                "name": "IGCN",
                "embedding_size": 16,
                "n_layers": 2,
                "dropout": 0.0,
                "feature_ratio": 1.0,
                "graph_backend": "dense",
                "prop_cache": prop_cache,
            },
            tiny_ds,
        )
        trainer = get_trainer(
            {
                "name": "IGCNTrainer",
                "optimizer": "Adam",
                "lr": 1e-2,
                "l2_reg": 0.0,
                "aux_reg": 0.01,
                "n_epochs": 8,
                "batch_size": 64,
                "test_batch_size": 64,
                "topks": [10],
                "seed": 2021,
            },
            tiny_ds,
            model,
        )
        for _ in range(8):
            trainer.train_one_epoch()
        _, metrics = trainer.eval("val")
        return metrics["NDCG"][10]

    exact = run(False)
    cached = run(True)
    assert exact > 0.0
    # identical seeds/sampling; engines differ only by bf16-P numerics
    assert abs(cached - exact) <= 0.15 * exact + 1e-3, (cached, exact)


def test_eval_path_ignores_cache(tiny_ds):
    """rep(train=False) never reads the cache — metrics see the exact
    operator (kernels/pcache.py docstring contract)."""
    cfg = {
        "name": "LightGCN",
        "embedding_size": 16,
        "n_layers": 2,
        "graph_backend": "dense",
        "prop_cache": True,
    }
    model = get_model(cfg, tiny_ds)
    params = model.init_params(jax.random.PRNGKey(0))
    buffers = model.init_buffers()
    rep_with = model.rep(params, buffers, train=False, key=None)
    del buffers["pcache"]
    rep_without = model.rep(params, buffers, train=False, key=None)
    np.testing.assert_array_equal(np.asarray(rep_with), np.asarray(rep_without))


def test_gating():
    # 'auto' needs a GPU (then confirmed by the measured A/B); the test mesh
    # is the CPU (conftest), where auto always stays off
    assert not use_pcache(100, 100, 3, "auto")
    assert use_pcache(100, 100, 3, True)
    assert not use_pcache(100, 100, 0, True)
    assert not use_pcache(100, 100, 3, False)
    with pytest.raises(ValueError):
        use_pcache(100, 100, 3, "always")
    # the Gowalla-shaped P is ~10 GB; Amazon-book's ~42 GB
    assert 10e9 < pcache_bytes(29858, 40981) < 11e9
    assert 41e9 < pcache_bytes(52643, 91599) < 43e9


def test_forced_overbudget_raises(monkeypatch):
    """prop_cache=True on the GPU with an over-budget P must raise a clear
    error instead of running out of memory mid-build; the budget follows
    the device's memory limit."""
    monkeypatch.setattr(platform.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(platform, "device_memory_bytes", lambda: 16 * 2**30)
    with pytest.raises(ValueError, match="too large"):
        platform.use_pcache(78578, 77801, 3, True)
    # Gowalla's P (9.7 GiB) is over a 16 GiB card's 8 GiB budget...
    assert not platform.use_pcache(29858, 40981, 3, "auto")
    # ...and within an 80 GB card's
    monkeypatch.setattr(platform, "device_memory_bytes", lambda: 60 * 2**30)
    assert platform.use_pcache(29858, 40981, 3, True)
    assert platform.use_pcache(29858, 40981, 3, "auto")


def test_ab_batch_follows_trainer(tiny_ds, monkeypatch):
    """The engine A/B must measure at the trainer's real
    batch size — a model built under a batch-512 trainer measures at 512, not
    the 2048 default; an explicit prop_cache_ab_batch still wins."""
    from igcn_cf.train.trainer import get_trainer

    import igcn_cf.kernels.pcache as pc

    seen = {}
    real = pc.maybe_build_pcache

    def spy(*args, ab_batch=2048, **kw):
        seen["ab_batch"] = ab_batch
        return real(*args, ab_batch=ab_batch, **kw)

    monkeypatch.setattr(pc, "maybe_build_pcache", spy)

    def build(extra_model_cfg):
        model = get_model(
            {
                "name": "IGCN", "embedding_size": 16, "n_layers": 2,
                "dropout": 0.0, "feature_ratio": 1.0,
                "graph_backend": "dense", "prop_cache": True,
                **extra_model_cfg,
            },
            tiny_ds,
        )
        get_trainer(
            {
                "name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-2,
                "l2_reg": 0.0, "aux_reg": 0.01, "n_epochs": 1,
                "batch_size": 512, "test_batch_size": 64, "topks": [10],
                "seed": 2021,
            },
            tiny_ds,
            model,
        )

    build({})
    assert seen["ab_batch"] == 512
    build({"prop_cache_ab_batch": 4096})
    assert seen["ab_batch"] == 4096

    # and the memo key itself distinguishes batch sizes
    from igcn_cf.kernels.pcache import _ab_memo_key

    assert _ab_memo_key(100, 16, 2, 512) != _ab_memo_key(100, 16, 2, 2048)


def test_ab_memo_key_derived_from_kernels():
    """The memo version is a hash of the sources of what the A/B times
    (kernel and reference, both directions) and the kernel geometry, not a
    hand-bumped string."""
    import igcn_cf.kernels.pcache as pc

    k1 = pc._ab_version()
    assert len(k1) == 10
    assert not hasattr(pc, "_AB_VERSION")  # the hand-bumped constant is gone
    assert k1 == pc._ab_version()  # deterministic


def test_rows_padding(tiny_ds):
    """R not a multiple of the kernel's row block pads internally and
    slices back."""
    n = tiny_ds.n_users + tiny_ds.n_items
    p = _p(tiny_ds, 1)
    x0 = jax.random.normal(jax.random.PRNGKey(2), (n, 16), jnp.float32)
    rows = jnp.arange(FWD_BR + 3, dtype=jnp.int32) % n
    out = cached_prop(p, rows, x0, kernel="interpret")
    assert out.shape == (FWD_BR + 3, 16)
    oracle = prop_cache_oracle(
        tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items, 1
    )
    want = oracle[np.asarray(rows)] @ np.asarray(x0)
    np.testing.assert_allclose(np.asarray(out), want, atol=0.05, rtol=0.05)


def test_refresh_buffers_reuses_pcache(tiny_ds):
    """End-of-training reload must not rebuild P next to the live copy
    (two multi-GB caches): unchanged interaction graph -> the cache array
    is reused; a changed dataset -> full rebuild."""
    import jax

    from igcn_cf.data.synthetic import synthetic_interactions
    from igcn_cf.models.base import get_model

    model = get_model(
        {"name": "IGCN", "embedding_size": 8, "n_layers": 2, "dropout": 0.0,
         "feature_ratio": 1.0, "graph_backend": "dense", "prop_cache": True},
        tiny_ds,
    )
    buffers = model.init_buffers()
    assert "pcache" in buffers
    refreshed = model.refresh_buffers(buffers)
    assert refreshed["pcache"] is buffers["pcache"]  # reused, not rebuilt
    # the rest of the buffers are freshly derived
    assert refreshed["bip"] is not buffers["bip"]

    # changed interactions -> the guard must fall through to a rebuild
    other = synthetic_interactions(
        n_users=tiny_ds.n_users, n_items=tiny_ds.n_items, avg_degree=5,
        seed=99,
    )
    model.dataset = other
    refreshed2 = model.refresh_buffers(buffers)
    assert refreshed2["pcache"] is not buffers["pcache"]
