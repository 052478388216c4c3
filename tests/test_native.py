"""Native (C++) data-path kernels vs the dict-based reference transcription."""

import numpy as np
import pytest

from igcn_cf import native
from igcn_cf.data.loaders import (
    _RawRecords,
    _update_ui_sets,
    remove_sparse_ui,
)


def _random_records(rng, n=3000, n_users=120, n_items=150):
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    times = rng.integers(0, 10_000, n)
    return [(f"u{u}", f"i{i}", int(t)) for u, i, t in zip(users, items, times)]


def test_native_builds():
    assert native.native_available(), "C++ kernel failed to build (g++/make)"


def test_kcore_matches_reference_dict_peel(rng):
    records = _random_records(rng)
    # reference transcription over unique pairs
    user_sets, item_sets = {}, {}
    for u, i, _ in records:
        _update_ui_sets(u, i, user_sets, item_sets)
    ref_user_map, ref_item_map = remove_sparse_ui(user_sets, item_sets, 5)

    raw = _RawRecords(iter(records), 5)
    # identical surviving node SETS (id assignment may permute; the reference
    # numbers nodes by raw insertion order, ours by surviving-edge order)
    assert set(raw.user_map) == set(ref_user_map)
    assert set(raw.item_map) == set(ref_item_map)
    assert raw.n_users == len(ref_user_map)
    assert raw.n_items == len(ref_item_map)


def test_kcore_degrees_after_peel(rng):
    records = _random_records(rng, n=5000)
    raw = _RawRecords(iter(records), 5)
    # every surviving user/item keeps >= min_inter unique neighbors
    item_deg = {}
    for u in range(raw.n_users):
        items = {e[0] for e in raw.inter_lists[u]}
        assert len(items) >= 5
        for i in items:
            item_deg[i] = item_deg.get(i, 0) + 1
    assert all(d >= 5 for d in item_deg.values())


def test_dedup_earliest_semantics(rng):
    users = np.array([0, 1, 0, 0, 1], dtype=np.int64)
    items = np.array([5, 6, 5, 7, 6], dtype=np.int64)
    times = np.array([30, 10, 20, 40, 5], dtype=np.int64)
    idx, t = native.dedup_earliest(users, items, times)
    # first-appearance order with min timestamps
    assert idx.tolist() == [0, 1, 3]
    assert t.tolist() == [20, 5, 40]


def test_native_vs_numpy_kcore(rng):
    users = rng.integers(0, 200, 4000).astype(np.int64)
    items = rng.integers(0, 260, 4000).astype(np.int64)
    # dedupe pairs first (degree = unique-neighbor count in both impls)
    pairs = np.unique(np.stack([users, items], 1), axis=0)
    users, items = pairs[:, 0], pairs[:, 1]
    keep_n, um_n, im_n = native.kcore_filter(users, items, 200, 260, 4)
    keep_p, um_p, im_p = native._kcore_numpy(users, items, 200, 260, 4)
    np.testing.assert_array_equal(keep_n, keep_p)
    np.testing.assert_array_equal(um_n >= 0, um_p >= 0)
    np.testing.assert_array_equal(um_n, um_p)
    np.testing.assert_array_equal(im_n, im_p)
