"""Geometric catalog-shape bucketing for the serving/inductive flows.

THE problem: every distinct (n_users, n_items) is a
new set of XLA program shapes, and the first inductive refresh at a GROWN
catalog — the exact scenario INMO exists for (reference
run/dropui/igcn_dropui.py:26-35) — paid multi-second recompiles: 46.3 s vs
the reference's 3.4 s. The reference never recompiles because torch kernels
are shape-polymorphic.

Fix: pad the LOGICAL catalog up to geometric buckets (~1.25x steps, aligned
to the kernels' natural tile sizes), so

  * growth WITHIN a bucket changes no shapes at all — refresh reuses every
    compiled executable (serve.Recommender restores its arg-pure jit cache);
  * crossing into a new bucket compiles ONCE PER MACHINE, not once per
    process — the persistent compilation cache (core/compile_cache.py)
    serves later processes from disk.

Ghost users/items (ids in [n_real, n_bucket)) have empty interaction lists:
zero graph degree, zero feat rows (token-only reps). Correctness guards:
callers ban item ids >= ``n_real_items`` in scoring (ghost items score 0 on
the raw dot, which would outrank true negatives) and only request real user
ids; both are pinned by tests/test_padded.py.

The padded object IS a plain ``Interactions`` (same contract everywhere)
carrying ``n_real_users`` / ``n_real_items`` attributes.
"""

from __future__ import annotations

from igcn_cf.data.dataset import Interactions

GROWTH = 1.25
ALIGN = 512  # bucket sizes align to the kernel row tile; the item axis gets
#              its kernel padding (TK/LI 4096) downstream of the bucket


def bucket_size(n: int, align: int = ALIGN, growth: float = GROWTH) -> int:
    """Smallest bucket >= n from the geometric series b_{k+1} =
    align_up(b_k * growth), b_0 = align. Deterministic and monotone: any two
    catalogs within ~growth of each other share a bucket."""
    if n <= 0:
        return align
    b = align
    while b < n:
        b = -(-int(b * growth) // align) * align
    return b


def real_counts(ds) -> tuple[int, int]:
    """(n_real_users, n_real_items) — the unpadded catalog counts."""
    return (
        getattr(ds, "n_real_users", ds.n_users),
        getattr(ds, "n_real_items", ds.n_items),
    )


def pad_catalog(ds: Interactions, growth: float = GROWTH) -> Interactions:
    """``ds`` with n_users/n_items padded up to their buckets (ghosts have
    empty splits). Idempotent on already-padded input (re-buckets from the
    REAL counts, so repeated wrapping never compounds)."""
    nru, nri = real_counts(ds)
    bu = bucket_size(nru, growth=growth)
    bi = bucket_size(nri, growth=growth)
    if bu == ds.n_users and bi == ds.n_items:
        ds.n_real_users, ds.n_real_items = nru, nri
        return ds
    ghosts_u = bu - nru
    out = Interactions(
        name=ds.name,
        n_users=bu,
        n_items=bi,
        train=list(ds.train[:nru]) + [[] for _ in range(ghosts_u)],
        val=list(ds.val[:nru]) + [[] for _ in range(ghosts_u)],
        test=list(ds.test[:nru]) + [[] for _ in range(ghosts_u)],
        neg_ratio=getattr(ds, "neg_ratio", 1),
    )
    out.n_real_users, out.n_real_items = nru, nri
    return out
