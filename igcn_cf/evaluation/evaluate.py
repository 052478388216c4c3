"""Masked full-catalog top-k retrieval evaluation.

Reproduces the reference eval protocol (reference trainer.py:140-177): for
each user-batch, score the full catalog, mask the user's train items (plus val
items when testing) and any banned items to -inf, take top-k, then compute
Precision/Recall/NDCG against the split's eval lists.

Differences from the reference:
  * representations are computed once per eval, not once per user batch
    (reference model.py:118-123 recomputes get_rep() per 512-user batch; at
    eval there is no dropout so caching is exact — SURVEY.md §7 hard part 1);
  * train/val exclusion masking is a device scatter over a padded per-user
    exclusion-id matrix instead of a host python loop building index lists
    (reference trainer.py:149-159);
  * scores are float32 products at ``precision=HIGHEST`` (the reference
    scores in float32; a default-precision float32 product may run in TF32
    on the GPU, which keeps ~3 decimal digits);
  * for dot-scored models the whole eval is one jitted call
    (``evaluate_one_dispatch``): representations, a ``lax.scan`` of
    score/mask/top-k over user blocks, and the metric reductions; only
    3*len(topks) scalars travel to the host.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from igcn_cf.evaluation.metrics import calculate_metrics, format_metrics

NEG_INF = -np.inf


def build_exclusion(
    ds, include_val: bool
) -> Tuple[np.ndarray, int]:
    """Padded per-user exclusion items (train, +val when testing), padded with
    ``n_items`` (a sentinel column sliced off after the scatter). Memoized on
    the dataset instance — the host loop over all users costs real wall-clock
    per eval at 30k+ users, and train/val never change within a run (inductive
    slices swap in FRESH dataset objects, so a stale hit is impossible)."""
    cache = getattr(ds, "_exclusion_cache", None)
    if cache is None:
        cache = {}
        try:
            ds._exclusion_cache = cache
        except AttributeError:
            pass  # exotic dataset object: just rebuild each call
    if include_val in cache:
        return cache[include_val]
    lists = []
    for u in range(ds.n_users):
        items = list(ds.train[u])
        if include_val:
            items = items + list(ds.val[u])
        lists.append(items)
    width = max(1, max(len(x) for x in lists))
    out = np.full((ds.n_users, width), ds.n_items, dtype=np.int32)
    for u, items in enumerate(lists):
        out[u, : len(items)] = items
    cache[include_val] = (out, width)
    return out, width


def score(users_rep: jnp.ndarray, items_t: jnp.ndarray) -> jnp.ndarray:
    """(B, d) @ (d, n_items) float32 scores at full float32 precision."""
    return jnp.dot(users_rep, items_t, precision=jax.lax.Precision.HIGHEST)


_TOPK_CHUNK = 1024


def exact_topk(scores: jnp.ndarray, k: int,
               chunk: int = _TOPK_CHUNK):
    """Exact two-stage top-k (values, ids) over the item axis: per-chunk
    lax.top_k, then re-rank the C*k candidates. Every global top-k element
    is in its chunk's top-k, so the result set is exact (ties: stable by
    chunk order, matching flat top_k's lower-index-first up to equal-value
    permutations). The chunk size is timed against one flat ``lax.top_k``
    on the card in KERNEL_FINDINGS.md."""
    b, n = scores.shape
    if n <= 2 * chunk or k > chunk:
        return jax.lax.top_k(scores, k)
    c = -(-n // chunk)
    pad = c * chunk - n
    if pad:
        scores = jnp.concatenate(
            [scores, jnp.full((b, pad), NEG_INF, scores.dtype)], axis=1
        )
    cv, ci = jax.lax.top_k(scores.reshape(b, c, chunk), k)
    base = (jnp.arange(c, dtype=ci.dtype) * chunk)[None, :, None]
    cand_idx = (ci + base).reshape(b, c * k)
    cand_val = cv.reshape(b, c * k)
    vals, sel = jax.lax.top_k(cand_val, k)
    return vals, jnp.take_along_axis(cand_idx, sel, axis=1)


def exact_topk_ids(scores: jnp.ndarray, k: int,
                   chunk: int = _TOPK_CHUNK) -> jnp.ndarray:
    """Ids-only wrapper of ``exact_topk``."""
    return exact_topk(scores, k, chunk)[1]


def mask_topk_core(
    scores: jnp.ndarray,
    exclude: jnp.ndarray,
    banned_mask: jnp.ndarray,
    max_k: int,
    n_items: int,
) -> jnp.ndarray:
    """scores (B, n_items); exclude (B, W) item ids padded with n_items;
    banned_mask (n_items,) bool. Returns (B, max_k) top item ids. Pure
    traced function — jitted per call site (the per-batch path below and the
    models' single-dispatch scan both build on it)."""
    b = scores.shape[0]
    # one sentinel column absorbs the padding scatter
    ext = jnp.concatenate([scores, jnp.zeros((b, 1), scores.dtype)], axis=1)
    rows = jnp.broadcast_to(jnp.arange(b)[:, None], exclude.shape)
    ext = ext.at[rows, exclude].set(NEG_INF, mode="drop")
    scores = ext[:, :n_items]
    scores = jnp.where(banned_mask[None, :], NEG_INF, scores)
    return exact_topk_ids(scores, max_k, _TOPK_CHUNK)


_mask_and_topk = jax.jit(
    mask_topk_core, static_argnames=("max_k", "n_items")
)


def pad_user_blocks(
    n_users: int, block: int
) -> np.ndarray:
    """(nb, block) user ids covering 0..n_users-1, tail padded by repeating
    the last user (its duplicate rows are sliced off after the scan)."""
    nb = -(-n_users // block)
    users = np.arange(nb * block, dtype=np.int32)
    return np.minimum(users, n_users - 1).reshape(nb, block)


def scan_topk(users_rep, items_t, users_pad, exclude, banned_mask,
              max_k: int, n_items: int) -> jnp.ndarray:
    """Traced full-catalog retrieval: one ``lax.scan`` over the (nb, B)
    user blocks of score -> mask -> top-k. Returns (nb*B, max_k) ids."""

    def body(c, users):
        return c, mask_topk_core(
            score(users_rep[users], items_t), exclude[users], banned_mask,
            max_k, n_items,
        )

    _, recs = jax.lax.scan(body, jnp.int32(0), users_pad)
    return recs.reshape(-1, max_k)


def _exclusion_dev(ds, split, exclude_np):
    """The (n_users, W) exclusion-id matrix, resident on the device and
    cached per dataset+split."""
    dev_cache = getattr(ds, "_exclusion_dev_cache", None)
    if dev_cache is None:
        dev_cache = {}
        try:
            ds._exclusion_dev_cache = dev_cache
        except AttributeError:
            pass
    ck = (split, exclude_np.shape)
    exclude_dev = dev_cache.get(ck)
    if exclude_dev is None:
        exclude_dev = dev_cache[ck] = jnp.asarray(exclude_np)
    return exclude_dev


def _eval_inputs(ds, split, banned_items):
    n_users, n_items = ds.n_users, ds.n_items
    if split != "train":
        exclude_np, _ = build_exclusion(ds, include_val=(split == "test"))
    else:
        exclude_np = np.full((n_users, 1), n_items, dtype=np.int32)
    banned_mask_np = np.zeros(n_items, dtype=bool)
    if banned_items is not None:
        banned_mask_np[np.asarray(banned_items, dtype=np.int64)] = True
    return exclude_np, banned_mask_np


def recommend(
    predict_fn: Callable[[jnp.ndarray], jnp.ndarray],
    ds,
    split: str,
    topks: Sequence[int],
    banned_items: Optional[np.ndarray] = None,
    test_batch_size: int = 512,
    recommend_fn=None,
) -> np.ndarray:
    """Top-max(topks) recommendations for every user (reference
    trainer.py:140-166).

    Two paths:
      * ``recommend_fn`` (from ``model.make_recommend_fn``): the whole eval
        is one jitted ``lax.scan`` over user blocks — one dispatch, one
        device-to-host copy of the (n_users, max_k) ids.
      * fallback: per-batch ``predict_fn`` ((B,) user ids -> (B, n_items)
        scores) + jitted mask/topk, dispatched without synchronizing,
        concatenated on device, one copy to the host at the end.
    """
    n_users, n_items = ds.n_users, ds.n_items
    max_k = max(topks)

    exclude_np, banned_mask_np = _eval_inputs(ds, split, banned_items)
    banned_mask = jnp.asarray(banned_mask_np)

    if recommend_fn is not None:
        users_pad = pad_user_blocks(n_users, test_batch_size)
        exclude_dev = _exclusion_dev(ds, split, exclude_np)
        rec_dev = recommend_fn(
            jnp.asarray(users_pad), exclude_dev, banned_mask, max_k
        )
        return np.asarray(rec_dev[:n_users]).astype(np.int64)

    exclude = jnp.asarray(exclude_np)
    parts = []
    for start in range(0, n_users, test_batch_size):
        stop = min(start + test_batch_size, n_users)
        users_np = np.arange(start, stop, dtype=np.int32)
        if stop - start < test_batch_size:
            pad = np.full(test_batch_size - (stop - start), stop - 1, dtype=np.int32)
            users_np = np.concatenate([users_np, pad])
        users = jnp.asarray(users_np)
        scores = predict_fn(users)
        parts.append(
            _mask_and_topk(scores, exclude[users], banned_mask, max_k, n_items)
        )
    rec_dev = jnp.concatenate(parts, axis=0)[:n_users]
    return np.asarray(rec_dev).astype(np.int64)


def evaluate_one_dispatch(eval_fn, ds, split: str, topks: Sequence[int],
                          banned_items: Optional[np.ndarray] = None,
                          test_batch_size: int = 512):
    """One-dispatch metric eval: ``eval_fn`` (from ``model.make_eval_fn``)
    runs rep -> scan of score/mask/top-k -> device metric reductions inside
    a single jitted call; this wrapper only supplies the device-resident
    cached inputs (exclusion ids, banned mask, padded eval lists) and
    unflattens the 3*len(topks) scalars that come back. Reference protocol:
    trainer.py:140-177."""
    from igcn_cf.evaluation.metrics import padded_eval_dev, unflatten_metrics

    exclude_np, banned_mask_np = _eval_inputs(ds, split, banned_items)
    users_pad = pad_user_blocks(ds.n_users, test_batch_size)
    eval_data: List[List[int]] = getattr(ds, split)
    padded, lens = padded_eval_dev(eval_data, cache_on=ds, cache_key=split)
    flat = np.asarray(
        eval_fn(jnp.asarray(users_pad), _exclusion_dev(ds, split, exclude_np),
                jnp.asarray(banned_mask_np), padded, lens, topks, max(topks))
    )
    metrics = unflatten_metrics(flat, topks)
    return format_metrics(metrics, topks), metrics


def evaluate(
    predict_fn,
    ds,
    split: str,
    topks: Sequence[int],
    banned_items: Optional[np.ndarray] = None,
    test_batch_size: int = 512,
    recommend_fn=None,
):
    """Returns (formatted_results_str, metrics dict) like the reference
    ``BasicTrainer.eval`` (reference trainer.py:140-177)."""
    eval_data: List[List[int]] = getattr(ds, split)
    rec = recommend(
        predict_fn, ds, split, topks, banned_items, test_batch_size,
        recommend_fn=recommend_fn,
    )
    metrics = calculate_metrics(eval_data, rec, topks)
    return format_metrics(metrics, topks), metrics
