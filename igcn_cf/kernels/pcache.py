"""Propagation cache: the precomputed ``P = mean_{k=0..K} A^k`` for models
whose propagation operator is fixed across training, with a fused Pallas
gather+matmul for the train step.

The reference recomputes the full-graph K-layer propagation for every
2048-interaction batch (reference model.py:434-446 for IGCN, model.py:95-106
for LightGCN) and then gathers the ~6k rows the batch needs. For IGCN the
per-batch edge dropout applies only to the feature matrix (reference
model.py:435); the K-layer propagation runs over the fixed ``norm_adj`` with
a mean over layers 0..K, and the per-epoch alpha anneal (reference
model.py:374-381) only rescales feature rows. LightGCN has no dropout at all.
So the linear operator

    P = (A^0 + A^1 + ... + A^K) / (K + 1),      A = D^-1/2 [[0,B],[B^T,0]] D^-1/2

is constant for the whole run. It is built once, column block by column
block through the model's own graph engine, stored as an (n, npad) bfloat16
matrix, and each train step computes only

    rows  = [users, n_users+pos, n_users+neg]          (3·batch ids)
    reps  = P[rows] @ X0                                (forward)
    dX0   = P[rows]^T @ d(reps)                         (backward)

A is symmetric, so P is symmetric and the same rows serve forward and
backward.

The fused kernel (``backend="triton"``). XLA runs gather-then-dot as: write
the gathered ``P[rows]`` block (3·2048 x npad bf16, ~0.9 GB at the Gowalla
shape), then read it back in the dot. The kernels read each gathered row
once and never write the block:

  * forward: grid (row blocks, column splits). A program loads its own row
    ids and streams (BR, BK) tiles of the gathered rows against (BK, d) tiles
    of X0 over its share of the columns; a second pass sums the splits (96
    row blocks alone would leave most of 132 SMs idle).
  * backward: one program per (BKB)-column stripe of P, looping over all
    rows: dX0[stripe] = P[rows, stripe]^T @ d(reps).

Numerics: P is stored in bfloat16 (relative error <= 2^-9 per entry; the
training matmuls already take bfloat16 inputs). Products accumulate in
float32. The backward uses the same bf16 P, so gradients are exact for the
forward actually computed. Evaluation never reads the cache: it keeps the
exact engine (tests/test_pcache.py).

Engine selection is measured (``ab_select``): ``core/platform.use_pcache``
gates on capacity, and on the GPU the model init times the cached step piece
against the recompute step piece, keeping the cache only if it wins, with
the verdict remembered on disk per shape.
"""

from __future__ import annotations

import json
import os
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

# Column padding of P: a multiple of every kernel column tile and split.
ALIGN = 1024

# Column-block width of the build: one one-hot block of this many columns
# propagates per dispatch.
BUILD_BLOCK = 512

# Kernel geometry. Forward: BR gathered rows x BK columns per tile, the
# column range split SPLITS ways. Backward: BKB-column stripes, BR rows per
# loop step. All powers of two (Triton's block shapes).
FWD_BR = 64
FWD_BK = 128
FWD_SPLITS = 8
BWD_BR = 64
BWD_BKB = 128
NUM_WARPS = 4
NUM_STAGES = 3


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def pcache_bytes(n_users: int, n_items: int) -> int:
    n = n_users + n_items
    return n * _pad_to(n, ALIGN) * 2


# -- build ---------------------------------------------------------------------


def build_prop_cache(propagate: Callable, n: int, n_layers: int,
                     block: int = BUILD_BLOCK) -> jnp.ndarray:
    """P = mean_{k=0..K} A^k as an (n, npad) bfloat16 matrix, npad = n
    padded to ALIGN. ``propagate(graph, x)`` is one A @ x step of the
    model's graph engine (``kernels.sparse.spmm`` over the sym-norm
    adjacency, or ``kernels.dense_graph.sym_norm_propagate``) and ``graph``
    its first argument; see ``build_prop_cache_cols``."""
    return build_prop_cache_cols(propagate, n, n_layers, 0,
                                 _pad_to(n, ALIGN), block=block)


def build_prop_cache_cols(propagate, n: int, n_layers: int, col_start: int,
                          col_width: int, block: int = BUILD_BLOCK):
    """Columns [col_start, col_start + col_width) of P as an (n, col_width)
    bfloat16 matrix. Built one ``block``-wide column block per dispatch:
    x = I[:, c0:c0+block] one-hot, K propagate passes in float32, the mean
    written bf16 into a donated buffer (in place; the multi-GB matrix is
    never copied). Columns >= n (padding) propagate to zero.

    ``propagate`` is a pair ``(fn, graph)`` with ``fn(graph, x)`` one A @ x
    step; the graph travels as a jit argument so it is not baked into the
    compiled program. This is also the per-shard build of the sharded cache
    (parallel/pcache.py): P is symmetric, so shard t's column slab
    P[:, ct] doubles as its row block P[ct, :]^T."""
    fn, graph = propagate
    assert col_width % block == 0, (col_width, block)
    inv = 1.0 / float(n_layers + 1)

    @partial(jax.jit, donate_argnums=(0,))
    def fill(p, g, c0):
        rows = jax.lax.broadcasted_iota(jnp.int32, (n, block), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (n, block), 1) + c0
        x = (rows == cols + col_start).astype(jnp.float32)
        acc = x * inv
        for _ in range(n_layers):
            x = fn(g, x)
            acc = acc + x * inv
        return jax.lax.dynamic_update_slice(
            p, acc.astype(jnp.bfloat16), (0, c0)
        )

    p = jnp.zeros((n, col_width), jnp.bfloat16)
    for c0 in range(0, col_width, block):
        p = fill(p, graph, jnp.int32(c0))
    return p


# -- fused gather+matmul (Pallas, Triton route) -----------------------------------


def fused_fwd(p, rows, x0b, *, interpret: bool = False):
    """(R, d) float32 = P[rows] @ X0 for R % FWD_BR == 0 and npad % ALIGN
    == 0: the split partial sums of the kernel, summed here."""
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import triton as plgpu

    npad = p.shape[1]
    d = x0b.shape[1]
    r = rows.shape[0]
    br, bk, splits = FWD_BR, FWD_BK, FWD_SPLITS
    kc = npad // splits
    assert r % br == 0 and npad % (splits * bk) == 0, (r, npad)

    def kernel(rows_ref, p_ref, x_ref, o_ref):
        i, s = pl.program_id(0), pl.program_id(1)
        ids = rows_ref[pl.ds(i * br, br)]

        def body(t, acc):
            k0 = s * kc + t * bk
            a = p_ref[ids, pl.ds(k0, bk)]
            b = x_ref[pl.ds(k0, bk), :]
            return acc + pl.dot(a, b)

        o_ref[...] = jax.lax.fori_loop(
            0, kc // bk, body, jnp.zeros((br, d), jnp.float32)
        )

    parts = pl.pallas_call(
        kernel,
        grid=(r // br, splits),
        in_specs=[
            pl.BlockSpec(rows.shape, lambda i, s: (0,)),
            pl.BlockSpec(p.shape, lambda i, s: (0, 0)),
            pl.BlockSpec(x0b.shape, lambda i, s: (0, 0)),
        ],
        out_specs=pl.BlockSpec((None, br, d), lambda i, s: (s, i, 0)),
        out_shape=jax.ShapeDtypeStruct((splits, r, d), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="pcache_gather_matmul_fwd",
    )(rows, p, x0b)
    return parts.sum(axis=0)


def fused_bwd(p, rows, ctb, *, interpret: bool = False):
    """(npad, d) float32 = P[rows]^T @ ct for R % BWD_BR == 0; padded rows
    must carry a zero cotangent."""
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import triton as plgpu

    npad = p.shape[1]
    d = ctb.shape[1]
    r = rows.shape[0]
    br, bkb = BWD_BR, BWD_BKB
    assert r % br == 0 and npad % bkb == 0, (r, npad)

    def kernel(rows_ref, p_ref, ct_ref, o_ref):
        c0 = pl.program_id(0) * bkb

        def body(t, acc):
            ids = rows_ref[pl.ds(t * br, br)]
            a = p_ref[ids, pl.ds(c0, bkb)]
            g = ct_ref[pl.ds(t * br, br), :]
            return acc + pl.dot(a, g, trans_a=True)

        o_ref[...] = jax.lax.fori_loop(
            0, r // br, body, jnp.zeros((bkb, d), jnp.float32)
        )

    return pl.pallas_call(
        kernel,
        grid=(npad // bkb,),
        in_specs=[
            pl.BlockSpec(rows.shape, lambda c: (0,)),
            pl.BlockSpec(p.shape, lambda c: (0, 0)),
            pl.BlockSpec(ctb.shape, lambda c: (0, 0)),
        ],
        out_specs=pl.BlockSpec((bkb, d), lambda c: (c, 0)),
        out_shape=jax.ShapeDtypeStruct((npad, d), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="pcache_gather_matmul_bwd",
    )(rows, p, ctb)


def _pad_rows_to(x, n_pad):
    if x.shape[0] == n_pad:
        return x
    return jnp.concatenate(
        [x, jnp.zeros((n_pad - x.shape[0],) + x.shape[1:], x.dtype)], axis=0
    )


def gather_dot_fwd(p, rows, x0b):
    """The plain reference: gather the rows, then one dot."""
    return jnp.dot(p[rows], x0b, preferred_element_type=jnp.float32)


def gather_dot_bwd(p, rows, ctb):
    return jax.lax.dot_general(
        p[rows], ctb,
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def _cp_fwd_impl(kernel, p, rows, x0):
    r = rows.shape[0]
    x0b = _pad_rows_to(x0, p.shape[1]).astype(jnp.bfloat16)
    if kernel == "xla":
        return gather_dot_fwd(p, rows, x0b)
    interpret = kernel == "interpret"
    rp = _pad_to(r, FWD_BR)
    out = fused_fwd(p, _pad_rows_to(rows, rp), x0b, interpret=interpret)
    return out[:r]


def _cp_bwd_impl(kernel, p, rows, ct):
    ctb = ct.astype(jnp.bfloat16)
    if kernel == "xla":
        return gather_dot_bwd(p, rows, ctb)
    # padded rows alias row 0 and carry a zero cotangent: they add nothing
    rp = _pad_to(rows.shape[0], BWD_BR)
    return fused_bwd(p, _pad_rows_to(rows, rp), _pad_rows_to(ctb, rp),
                     interpret=kernel == "interpret")


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def _cached_prop(p, rows, x0, kernel):
    return _cp_fwd_impl(kernel, p, rows, x0)


def _cp_fwd(p, rows, x0, kernel):
    return _cp_fwd_impl(kernel, p, rows, x0), (p, rows, x0.shape[0])


def _cp_bwd(kernel, res, ct):
    p, rows, n = res
    dx0 = _cp_bwd_impl(kernel, p, rows, ct)
    return None, None, dx0[:n].astype(jnp.float32)


_cached_prop.defvjp(_cp_fwd, _cp_bwd)


def cached_prop(p, rows, x0, kernel: str | None = None):
    """reps = P[rows] @ X0. ``p`` is the (n, npad) bf16 cache and is not
    differentiated; ``rows`` is (R,) int32; ``x0`` is (n or npad, d) f32.
    The backward contracts the same row stream (P symmetric). ``kernel``:
    'triton', 'xla' or 'interpret' (the Triton kernel in interpret mode,
    for tests); None asks core/platform."""
    if kernel is None:
        from igcn_cf.core.platform import pcache_kernel

        kernel = pcache_kernel()
    return _cached_prop(p, rows, x0, kernel)


# -- measured engine A/B ---------------------------------------------------------


def _ab_memo_path() -> str:
    from igcn_cf.core.compile_cache import state_dir

    return os.path.join(state_dir(), "engine_ab.json")


def _ab_version() -> str:
    """Memo version: a hash of the sources of what the A/B times (the
    cached gather+matmul, forward and backward, and its geometry), so an
    edit never reuses a stale verdict."""
    import hashlib
    import inspect

    src = "".join(
        inspect.getsource(f)
        for f in (fused_fwd, fused_bwd, gather_dot_fwd, gather_dot_bwd,
                  _cp_fwd_impl, _cp_bwd_impl)
    )
    geom = (f"|{FWD_BR},{FWD_BK},{FWD_SPLITS},{BWD_BR},{BWD_BKB},"
            f"{NUM_WARPS},{NUM_STAGES},{ALIGN}")
    return hashlib.sha1((src + geom).encode()).hexdigest()[:10]


def _ab_memo_key(n: int, d: int, n_layers: int, batch_size: int,
                 engine: str = "sparse") -> str:
    from igcn_cf.core.platform import pcache_kernel

    dev = jax.devices()[0].device_kind.replace(" ", "_")
    return (f"{_ab_version()}|{dev}|{engine}|{pcache_kernel()}|n={n}|d={d}"
            f"|K={n_layers}|B={batch_size}")


def _ab_memo_load() -> dict:
    try:
        with open(_ab_memo_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _ab_memo_store(key: str, entry: dict) -> None:
    memo = _ab_memo_load()
    memo[key] = entry
    path = _ab_memo_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(memo, f, indent=1)
    os.replace(tmp, path)


def measure_engines_ms(recompute: Callable, p, n: int, d: int,
                       batch_size: int) -> dict:
    """Device ms of the part of a step where the engines differ,
    propagation forward + backward: the cached gather+matmul on R=3·batch
    rows against the K-layer recompute ``recompute(x0) -> (n, d)``.
    Everything else in the step (X0, loss, Adam) is the same."""
    from igcn_cf.utils.timing import device_ms

    r_tot = 3 * batch_size
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    x0 = jax.random.normal(k1, (n, d), jnp.float32)
    rows = jax.random.randint(k2, (r_tot,), 0, n, dtype=jnp.int32)
    ct = jax.random.normal(k3, (r_tot, d), jnp.float32)
    ct_full = jax.random.normal(k4, (n, d), jnp.float32)

    @jax.jit
    def pc_step(p, rows, x0, ct):
        y, vjpf = jax.vjp(lambda x: cached_prop(p, rows, x), x0)
        return y, vjpf(ct)[0]

    @jax.jit
    def rc_step(x0, ct):
        y, vjpf = jax.vjp(recompute, x0)
        return y, vjpf(ct)[0]

    return {
        "pcache_ms": device_ms(pc_step, p, rows, x0, ct),
        "recompute_ms": device_ms(rc_step, x0, ct_full),
    }


def ab_select(recompute: Callable, p, n: int, n_layers: int, d: int,
              batch_size: int, engine: str) -> tuple[bool, dict]:
    """Measured engine choice, remembered on disk: True = train through the
    cache."""
    key = _ab_memo_key(n, d, n_layers, batch_size, engine)
    entry = _ab_memo_load().get(key)
    if not entry:
        times = measure_engines_ms(recompute, p, n, d, batch_size)
        entry = dict(times,
                     use_pcache=times["pcache_ms"] < times["recompute_ms"])
        _ab_memo_store(key, entry)
    return bool(entry["use_pcache"]), entry


def maybe_build_pcache(propagate, recompute: Callable, n: int, n_layers: int,
                       d: int, requested="auto", ab_batch: int = 2048,
                       engine: str = "sparse"):
    """Build the cache for a model whose capacity gate passed. For 'auto'
    where core/platform runs the A/B, confirm it by measurement; a
    remembered rejection skips the multi-GB build. Returns (p or None,
    entry or None); None p means train on the recompute engine. The entry
    itemizes the cold start: ``p_build_s`` (the column-blocked build with
    its compiles) and ``ab_measure_s`` (0.0 when a remembered verdict was
    reused)."""
    import time

    from igcn_cf.core.platform import pcache_ab

    if requested == "auto" and pcache_ab():
        key = _ab_memo_key(n, d, n_layers, ab_batch, engine)
        verdict = _ab_memo_load().get(key) or None
        if verdict is not None and not verdict["use_pcache"]:
            return None, verdict
        t0 = time.time()
        p = jax.block_until_ready(build_prop_cache(propagate, n, n_layers))
        p_build_s = round(time.time() - t0, 3)
        if verdict is not None:
            return p, dict(verdict, p_build_s=p_build_s, ab_measure_s=0.0)
        t0 = time.time()
        use, entry = ab_select(recompute, p, n, n_layers, d, ab_batch, engine)
        entry = dict(entry, p_build_s=p_build_s,
                     ab_measure_s=round(time.time() - t0, 3))
        return (p if use else None), entry
    return build_prop_cache(propagate, n, n_layers), None


def graph_fingerprint(train_array) -> str:
    """What P depends on besides K: the interaction edges."""
    import hashlib

    arr = np.ascontiguousarray(np.asarray(train_array, dtype=np.int64))
    return hashlib.sha1(arr.tobytes()).hexdigest()


def engine_ops(backend: str, buffers: dict, n_layers: int):
    """The model graph engine's one-layer step, as the ``(fn, graph)`` pair
    the build takes, and its K-layer recompute ``x0 -> reps`` the A/B
    times."""
    from igcn_cf.kernels.dense_graph import (
        sym_norm_propagate,
        sym_norm_propagate_mean,
    )
    from igcn_cf.kernels.sparse import propagate_mean, spmm

    if backend == "dense":
        g = buffers["bip"]
        return (sym_norm_propagate, g), (
            lambda x: sym_norm_propagate_mean(g, x, n_layers)
        )
    g = buffers["norm_adj"]
    return (spmm, g), (lambda x: propagate_mean(g, x, n_layers))


def attach_pcache(model, buffers: dict) -> None:
    """Build ``buffers['pcache']`` for a model whose capacity gate passed
    (IGCN, LightGCN), through the model's own engine. A/B batch: an explicit
    ``prop_cache_ab_batch`` in the model config, else the trainer's batch
    size (set on the model before init_buffers), else 2048. Turns
    ``model.pcache`` off when the measured A/B rejects the cache."""
    propagate, recompute = engine_ops(model.backend, buffers, model.n_layers)
    p, model.engine_ab = maybe_build_pcache(
        propagate, recompute, model.n_users + model.n_items, model.n_layers,
        model.embedding_size, model.config.get("prop_cache", "auto"),
        ab_batch=int(model.config.get("prop_cache_ab_batch",
                                      getattr(model, "ab_batch", 2048))),
        engine=model.backend,
    )
    if p is None:
        model.pcache = False
    else:
        buffers["pcache"] = p
        model.pcache_fingerprint = graph_fingerprint(
            model.dataset.train_array
        )


# -- test oracle -----------------------------------------------------------------


def prop_cache_oracle(train_array: np.ndarray, n_users: int, n_items: int,
                      n_layers: int) -> np.ndarray:
    """Dense NumPy mean_k A^k for tests (exact, f32)."""
    n = n_users + n_items
    a = np.zeros((n, n), np.float64)
    for u, i in np.asarray(train_array):
        a[u, n_users + i] = 1.0
        a[n_users + i, u] = 1.0
    deg = np.maximum(a.sum(1), 1.0)
    s = 1.0 / np.sqrt(deg)
    a = s[:, None] * a * s[None, :]
    p = np.eye(n)
    x = np.eye(n)
    for _ in range(n_layers):
        x = a @ x
        p = p + x
    return (p / (n_layers + 1)).astype(np.float32)
