"""Ranking metrics: Precision/Recall/NDCG@k.

``calculate_metrics`` is a vectorized numpy reimplementation of the
reference's pure-Python hit-matrix double loop (reference trainer.py:109-138),
with identical numerics: hits against the per-user eval set, ideal DCG from
min(|eval|, k) leading ones, and users with empty eval sets masked out of the
means. ``calculate_metrics_slow`` is a direct transcription of the reference
loop kept as the test oracle (SURVEY.md §4)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _pad_sorted(eval_data: List[List[int]], sentinel: int) -> np.ndarray:
    n = len(eval_data)
    width = max(1, max((len(e) for e in eval_data), default=1))
    out = np.full((n, width), sentinel, dtype=np.int64)
    for u, items in enumerate(eval_data):
        if items:
            out[u, : len(items)] = np.sort(np.asarray(items, dtype=np.int64))
    return out


def hit_matrix(eval_data: List[List[int]], rec_items: np.ndarray) -> np.ndarray:
    """hit[u, j] = 1 if rec_items[u, j] is in eval_data[u].

    One flat ``np.searchsorted`` over all users at once: each row of the
    sorted padded matrix is offset by ``u * stride`` so the flattened table
    stays globally sorted, and the queries get the same offsets. This
    replaces a per-user python searchsorted loop that cost ~an OOM more than
    the device eval at 30k users."""
    sentinel = int(rec_items.max(initial=0)) + 1
    padded = _pad_sorted(eval_data, sentinel)
    n, w = padded.shape
    stride = max(sentinel, int(padded.max()) + 1) + 1
    offsets = np.arange(n, dtype=np.int64)[:, None] * stride
    table = (padded + offsets).ravel()
    queries = (rec_items.astype(np.int64) + offsets).ravel()
    idx = np.minimum(np.searchsorted(table, queries), table.size - 1)
    found = (table[idx] == queries).reshape(rec_items.shape)
    return found.astype(np.float32)


def calculate_metrics(
    eval_data: List[List[int]],
    rec_items: np.ndarray,
    topks: Sequence[int],
) -> Dict[str, Dict[int, float]]:
    results: Dict[str, Dict[int, float]] = {"Precision": {}, "Recall": {}, "NDCG": {}}
    hits = hit_matrix(eval_data, rec_items)
    eval_len = np.array([len(e) for e in eval_data], dtype=np.int32)

    for k in topks:
        hit_num = hits[:, :k].sum(axis=1)
        precisions = hit_num / k
        with np.errstate(invalid="ignore"):
            recalls = hit_num / eval_len

        max_hit_num = np.minimum(eval_len, k)
        denom = np.log2(np.arange(2, k + 2, dtype=np.float32))[None, :]
        dcgs = (hits[:, :k] / denom).sum(axis=1)
        # ideal DCG: first min(|eval|, k) positions hit
        ones_mask = np.arange(k)[None, :] < max_hit_num[:, None]
        idcgs = (ones_mask / denom).sum(axis=1)
        with np.errstate(invalid="ignore"):
            ndcgs = dcgs / idcgs

        mask = max_hit_num > 0
        results["Precision"][k] = float(precisions[mask].mean())
        results["Recall"][k] = float(recalls[mask].mean())
        results["NDCG"][k] = float(ndcgs[mask].mean())
    return results


def calculate_metrics_slow(
    eval_data: List[List[int]],
    rec_items: np.ndarray,
    topks: Sequence[int],
) -> Dict[str, Dict[int, float]]:
    """Direct transcription of the reference metric loop (reference
    trainer.py:109-138); O(users * k * |eval|) — tests only."""
    results: Dict[str, Dict[int, float]] = {"Precision": {}, "Recall": {}, "NDCG": {}}
    hits = np.zeros_like(rec_items, dtype=np.float32)
    for user in range(rec_items.shape[0]):
        eval_set = set(eval_data[user])
        for j in range(rec_items.shape[1]):
            if rec_items[user, j] in eval_set:
                hits[user, j] = 1.0
    eval_len = np.array([len(e) for e in eval_data], dtype=np.int32)
    for k in topks:
        hit_num = hits[:, :k].sum(axis=1)
        precisions = hit_num / k
        with np.errstate(invalid="ignore"):
            recalls = hit_num / eval_len
        max_hit_num = np.minimum(eval_len, k)
        max_hits = np.zeros((rec_items.shape[0], k), dtype=np.float32)
        for user, num in enumerate(max_hit_num):
            max_hits[user, :num] = 1.0
        denom = np.log2(np.arange(2, k + 2, dtype=np.float32))[None, :]
        dcgs = (hits[:, :k] / denom).sum(axis=1)
        idcgs = (max_hits / denom).sum(axis=1)
        with np.errstate(invalid="ignore"):
            ndcgs = dcgs / idcgs
        mask = max_hit_num > 0
        results["Precision"][k] = float(precisions[mask].mean())
        results["Recall"][k] = float(recalls[mask].mean())
        results["NDCG"][k] = float(ndcgs[mask].mean())
    return results


def _pad_eval_device(eval_data: List[List[int]]):
    """(padded (n, W) int32 with -1 sentinel, lens (n,) int32) as numpy —
    the device-metrics inputs (cached per dataset+split by the caller)."""
    n = len(eval_data)
    width = max(1, max((len(e) for e in eval_data), default=1))
    out = np.full((n, width), -1, dtype=np.int32)
    lens = np.zeros(n, dtype=np.int32)
    for u, items in enumerate(eval_data):
        if items:
            out[u, : len(items)] = np.asarray(items, dtype=np.int32)
            lens[u] = len(items)
    return out, lens


def device_metrics_core(rec, padded, lens, topks):
    """TRACED metric reductions (Precision/Recall/NDCG@k means) — pure
    function of device arrays, composable inside a larger jit (the
    one-dispatch eval chains rep -> retrieval -> this, evaluation/
    evaluate.py). Returns a flat (3*len(topks),) f32 vector."""
    import jax.numpy as jnp

    # hit[u, j] = rec[u, j] in eval set u (sentinel -1 never matches)
    hits = (
        (rec[:, :, None] == padded[:, None, :]).any(-1).astype(jnp.float32)
    )
    out = []
    for k in topks:
        hk = hits[:, :k]
        hit_num = hk.sum(1)
        max_hit = jnp.minimum(lens, k).astype(jnp.float32)
        mask = (max_hit > 0).astype(jnp.float32)
        msum = jnp.maximum(mask.sum(), 1.0)
        denom = 1.0 / jnp.log2(jnp.arange(2, k + 2, dtype=jnp.float32))
        dcg = (hk * denom[None, :]).sum(1)
        ones = (
            jnp.arange(k, dtype=jnp.float32)[None, :] < max_hit[:, None]
        ).astype(jnp.float32)
        idcg = (ones * denom[None, :]).sum(1)
        ndcg = dcg / jnp.maximum(idcg, 1e-9)
        recall = hit_num / jnp.maximum(lens.astype(jnp.float32), 1.0)
        out += [
            (hit_num / k * mask).sum() / msum,
            (recall * mask).sum() / msum,
            (ndcg * mask).sum() / msum,
        ]
    return jnp.stack(out)


def _device_metrics_jit_factory():
    import jax
    from functools import partial

    @partial(jax.jit, static_argnames=("topks",))
    def f(rec, padded, lens, *, topks):
        return device_metrics_core(rec, padded, lens, topks)

    return f


_device_metrics_jit = None


def padded_eval_dev(eval_data: List[List[int]], cache_on=None, cache_key=None):
    """Device-resident (padded, lens) eval arrays, memoized via
    (cache_on, cache_key) — shared by the standalone device metrics and the
    one-dispatch fused eval."""
    import jax.numpy as jnp

    dev = None
    cache = None
    if cache_on is not None:
        cache = getattr(cache_on, "_eval_pad_cache", None)
        if cache is None:
            cache = {}
            try:
                cache_on._eval_pad_cache = cache
            except AttributeError:
                cache = None
        if cache is not None:
            dev = cache.get(cache_key)
    if dev is None:
        padded_np, lens_np = _pad_eval_device(eval_data)
        dev = (jnp.asarray(padded_np), jnp.asarray(lens_np))
        if cache is not None:
            cache[cache_key] = dev
    return dev


def unflatten_metrics(flat, topks: Sequence[int]) -> Dict[str, Dict[int, float]]:
    """(3*len(topks),) vector (device_metrics_core order) -> metrics dict."""
    results: Dict[str, Dict[int, float]] = {"Precision": {}, "Recall": {}, "NDCG": {}}
    for i, k in enumerate(topks):
        results["Precision"][k] = float(flat[3 * i])
        results["Recall"][k] = float(flat[3 * i + 1])
        results["NDCG"][k] = float(flat[3 * i + 2])
    return results


def calculate_metrics_device(
    rec_dev, eval_data: List[List[int]], topks: Sequence[int], cache_on=None,
    cache_key=None,
) -> Dict[str, Dict[int, float]]:
    """calculate_metrics with the hit matrix and reductions ON DEVICE —
    ``rec_dev`` is a device array and only len(topks)*3 scalars travel D2H.
    Same numerics as the numpy path (asserted in tests). The padded eval
    matrix is cacheable via (cache_on, cache_key)."""
    global _device_metrics_jit
    if _device_metrics_jit is None:
        _device_metrics_jit = _device_metrics_jit_factory()

    padded, lens = padded_eval_dev(eval_data, cache_on, cache_key)
    flat = np.asarray(
        _device_metrics_jit(rec_dev, padded, lens, topks=tuple(topks))
    )
    return unflatten_metrics(flat, topks)


def format_metrics(metrics: Dict[str, Dict[int, float]], topks: Sequence[int]) -> str:
    """Reference-format result string (reference trainer.py:169-177)."""
    parts = {"Precision": "", "Recall": "", "NDCG": ""}
    for name in parts:
        for k in topks:
            parts[name] += "{:.3f}%@{:d}, ".format(metrics[name][k] * 100.0, k)
    return "Precision: {:s}Recall: {:s}NDCG: {:s}".format(
        parts["Precision"], parts["Recall"], parts["NDCG"]
    )
