"""Data layer tests: text round-trip, splits, transforms, samplers."""

import numpy as np
import pytest

from igcn_cf.data.dataset import Interactions, get_dataset
from igcn_cf.data.loaders import split_interactions
from igcn_cf.data.sampler import DeviceNegativeSampler, sample_bpr_epoch
from igcn_cf.data.synthetic import synthetic_interactions
from igcn_cf.data.transforms import auxiliary_interactions, dropit, dropui

import jax


def test_processed_roundtrip(tmp_path, tiny_ds):
    """output() then ProcessedDataset load reproduces the splits (reference
    dataset.py:133-164 text format)."""
    path = str(tmp_path / "ds")
    tiny_ds.output(path)
    loaded = get_dataset({"name": "ProcessedDataset", "path": path})
    assert loaded.n_users == tiny_ds.n_users
    assert loaded.n_items <= tiny_ds.n_items  # inferred from max id seen
    assert loaded.train == tiny_ds.train
    assert loaded.val == tiny_ds.val
    assert loaded.test == tiny_ds.test
    assert np.array_equal(loaded.train_array, tiny_ds.train_array)


def test_split_ratios():
    inter_lists = [[[i, 100 + i] for i in range(10)] for _ in range(4)]
    ds = split_interactions(inter_lists, 4, 10, (0.7, 0.1, 0.2))
    for u in range(4):
        assert ds.train[u] == list(range(7))
        assert ds.val[u] == [7]
        assert ds.test[u] == [8, 9]


def test_split_time_ordering():
    # interactions given unsorted by time must be time-sorted before split
    inter_lists = [[[3, 30], [1, 10], [2, 20], [0, 5], [4, 40]]]
    ds = split_interactions(inter_lists, 1, 5, (0.6, 0.2, 0.2))
    assert ds.train[0] == [0, 1, 2]
    assert ds.val[0] == [3]
    assert ds.test[0] == [4]


def test_dropit(tiny_ds):
    d = dropit(tiny_ds, 0.8)
    for u in range(tiny_ds.n_users):
        n = int(len(tiny_ds.train[u]) * 0.8)
        assert d.train[u] == tiny_ds.train[u][:n]
    assert d.val == tiny_ds.val and d.test == tiny_ds.test


def test_dropui(tiny_ds):
    d = dropui(tiny_ds, 0.8)
    assert d.n_users == int(tiny_ds.n_users * 0.8)
    assert d.n_items == int(tiny_ds.n_items * 0.8)
    for u in range(d.n_users):
        assert all(i < d.n_items for i in d.train[u] + d.val[u] + d.test[u])
        assert d.train[u] == [i for i in tiny_ds.train[u] if i < d.n_items]


def test_auxiliary_identity_maps(tiny_ds):
    user_map = {u: u for u in range(tiny_ds.n_users)}
    item_map = {i: i for i in range(tiny_ds.n_items)}
    aux = auxiliary_interactions(tiny_ds, user_map, item_map)
    assert aux.train == tiny_ds.train


def test_auxiliary_subset(tiny_ds):
    core_users = list(range(0, tiny_ds.n_users, 2))
    core_items = list(range(0, tiny_ds.n_items, 2))
    user_map = {u: k for k, u in enumerate(core_users)}
    item_map = {i: k for k, i in enumerate(core_items)}
    aux = auxiliary_interactions(tiny_ds, user_map, item_map)
    assert aux.n_users == len(core_users)
    for o_user in core_users:
        expect = [item_map[i] for i in tiny_ds.train[o_user] if i in item_map]
        assert aux.train[user_map[o_user]] == expect


def test_device_sampler_validity(tiny_ds):
    s = DeviceNegativeSampler.build(tiny_ds)
    key = jax.random.PRNGKey(0)
    users, pos, negs = s.sample(key, 512, neg_ratio=2)
    users, pos, negs = map(np.asarray, (users, pos, negs))
    assert users.shape == (512,) and pos.shape == (512,) and negs.shape == (512, 2)
    train_sets = [set(t) for t in tiny_ds.train]
    for b in range(512):
        assert len(train_sets[users[b]]) > 0
        assert pos[b] in train_sets[users[b]]
        for r in range(2):
            assert 0 <= negs[b, r] < tiny_ds.n_items
            assert negs[b, r] not in train_sets[users[b]]


def test_device_sampler_deterministic(tiny_ds):
    s = DeviceNegativeSampler.build(tiny_ds)
    key = jax.random.PRNGKey(42)
    a = s.sample(key, 64)
    b = s.sample(key, 64)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_host_sampler_oracle(tiny_ds, rng):
    users, pos, negs = sample_bpr_epoch(tiny_ds, rng, 200, neg_ratio=1)
    train_sets = [set(t) for t in tiny_ds.train]
    for b in range(200):
        assert pos[b] in train_sets[users[b]]
        assert negs[b, 0] not in train_sets[users[b]]


def test_sampler_marginals(small_ds):
    """Positives should be ~uniform over a user's train items; users ~uniform
    over active users (reference dataset.py:119-123 semantics)."""
    s = DeviceNegativeSampler.build(small_ds)
    users, pos, _ = s.sample(jax.random.PRNGKey(1), 20000)
    users = np.asarray(users)
    active = np.array([u for u in range(small_ds.n_users) if small_ds.train[u]])
    counts = np.bincount(users, minlength=small_ds.n_users)[active]
    expected = 20000 / len(active)
    assert abs(counts.mean() - expected) < 1e-6
    assert counts.std() < 4 * np.sqrt(expected)
