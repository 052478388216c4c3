"""Bit-packed binary matrix products in plain XLA: Y = B @ X, Y = B^T @ X,
their dropout-masked variants, and the transposed-layout pair that serves
INMO's feature aggregation, with B stored at one bit per entry.

Every graph matrix in this workload is a binary interaction pattern
(reference model.py:85-94 adjacency, model.py:386-421 feat-mat patterns), so
B is stored bit-packed: 32 entries per uint32 word, 16x less memory than
bf16. No transpose copy is stored: the transposed product contracts dim 0 of
the same matrix.

Packing layout (``pack_bits``): columns are grouped in TK=4096-wide tiles;
within a tile, bit b of word lane w holds column ``b*128 + w``:

    word_index(c) = (c // 4096) * 128 + (c % 128)
    bit_index(c)  = (c % 4096) // 128

Each product unpacks B to a dense matrix and runs one XLA dot. That does
n_users * n_items * d multiply-adds per pass whatever the density, so this
engine is chosen only by asking for ``graph_backend='dense'``; the sparse
segment-sum engine (kernels/sparse.py) is the default (core/platform.py).

Dropout masking (reference model.py:263-275 edge dropout; masking structural
zeros is a no-op) is one bitwise AND on the packed words: a 32-bit keep-word
is built per packed word from 8 salted coordinate hashes via a bit-sliced
>=threshold comparator: all 32 columns' 8-bit uniform variates are compared
against round(p*256) at once with ~30 bitwise ops. The keep decision is a
pure function of the canonical (row, column) coordinate, so the backward
pass over the same matrix regenerates the bit-identical mask (p is quantized
to 1/256 steps, a documented deviation).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

TM = 512  # row padding
TKP = 128  # packed word lanes per tile
TK = TKP * 32  # unpacked columns per tile

# multiply-xorshift mixing constants (splitmix/wyhash-style finalizer on u32)
_C1 = np.uint32(0x9E3779B9)
_C2 = np.uint32(0x85EBCA6B)
_C3 = np.uint32(0xC2B2AE35)


def pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


# -- host-side packing --------------------------------------------------------


def pack_bits(b: np.ndarray) -> np.ndarray:
    """(M, K) 0/1 -> (M, K/32) uint32 in the bit-plane tile layout. K must be
    a multiple of TK (pad first)."""
    m, k = b.shape
    assert k % TK == 0, (m, k)
    ntiles = k // TK
    r = b.reshape(m, ntiles, 32, TKP).astype(np.uint32)
    words = (r << np.arange(32, dtype=np.uint32)[None, None, :, None]).sum(
        axis=2, dtype=np.uint32
    )
    return np.ascontiguousarray(words.reshape(m, ntiles * TKP))


def pack_interactions(
    train_array: np.ndarray, n_rows: int, n_cols: int
) -> tuple[np.ndarray, int, int]:
    """Pack a [row, col] interaction list into the padded bit layout without
    materializing the dense matrix. Returns (packed, rows_padded, cols_padded)."""
    mp, kp = pad_to(n_rows, TM), pad_to(n_cols, TK)
    packed = np.zeros((mp, kp // 32), dtype=np.uint32)
    if len(train_array):
        rows = train_array[:, 0].astype(np.int64)
        cols = train_array[:, 1].astype(np.int64)
        word = (cols // TK) * TKP + (cols % TKP)
        bit = (cols % TK) // TKP
        np.bitwise_or.at(packed, (rows, word), (np.uint32(1) << bit.astype(np.uint32)))
    return packed, mp, kp


def unpack_bits_np(packed: np.ndarray) -> np.ndarray:
    """Inverse of pack_bits (host; tests/fallback)."""
    m, kp = packed.shape
    ntiles = kp // TKP
    w = packed.reshape(m, ntiles, 1, TKP)
    bits = (w >> np.arange(32, dtype=np.uint32)[None, None, :, None]) & 1
    return bits.reshape(m, ntiles * TK).astype(np.float32)


def _unpack_bits_jnp(packed: jnp.ndarray) -> jnp.ndarray:
    m, kp = packed.shape
    ntiles = kp // TKP
    w = packed.reshape(m, ntiles, 1, TKP)
    bits = (w >> jnp.arange(32, dtype=jnp.uint32)[None, None, :, None]) & jnp.uint32(1)
    return bits.reshape(m, ntiles * TK).astype(jnp.bfloat16)


# -- keep-mask ----------------------------------------------------------------


def _threshold_u8(p: float) -> int:
    """Dropout prob quantized to 1/256 steps (documented deviation: p becomes
    round(p*256)/256)."""
    return max(0, min(255, int(round(p * 256))))


def _mix_hash(seed, rows, words):
    h = (rows.astype(jnp.uint32) * _C1) ^ (words.astype(jnp.uint32) * _C2) ^ seed
    h = (h ^ (h >> 16)) * _C3
    return h ^ (h >> 16)


def _mix_base(rows, words):
    """The round-independent part of ``_mix_hash``: rows*C1 ^ words*C2,
    hoisted out of ``_keepword``'s 8 rounds (16 of the 24 u32 multiplies
    per keep word) with bit-identical output."""
    return (rows.astype(jnp.uint32) * _C1) ^ (words.astype(jnp.uint32) * _C2)


def _mix_finish(base, seed):
    h = base ^ seed
    h = (h ^ (h >> 16)) * _C3
    return h ^ (h >> 16)


def _salt(i: int) -> np.uint32:
    return np.uint32((i * 0x9E3779B1 + 1) & 0xFFFFFFFF)


def _keepword(seed, rows, words, thr: int):
    """32-bit keep word for a (.., TKP) grid of packed words: bit b is
    [byte(r, c) >= thr] for column c = tile_base + b*128 + lane, where
    byte(r, c)'s 8 bits are bit-sliced across 8 salted hash grids. The
    comparator runs on all 32 bit positions at once via bitwise ops."""
    ge = jnp.zeros(rows.shape, dtype=jnp.uint32)
    eq = jnp.full(rows.shape, 0xFFFFFFFF, dtype=jnp.uint32)
    base = _mix_base(rows, words)  # hoisted: identical across the 8 rounds
    for i in range(7, -1, -1):
        h = _mix_finish(base, seed + _salt(i))
        if (thr >> i) & 1:
            eq = eq & h
        else:
            ge = ge | (eq & h)
            eq = eq & (~h)
    return ge | eq


def keep_mask_dense(seed, n_rows: int, n_cols: int, p: float) -> jnp.ndarray:
    """Unpacked (n_rows, n_cols) bool keep mask — the identical decision the
    masked products make, materialized for the products and oracle tests."""
    thr = _threshold_u8(p)
    cols = jnp.arange(n_cols, dtype=jnp.uint32)
    words = (cols // TK) * TKP + (cols % TKP)  # (C,)
    bit = ((cols % TK) // TKP).astype(jnp.uint32)  # (C,)
    rows = jnp.arange(n_rows, dtype=jnp.uint32)
    kw = _keepword(
        jnp.uint32(seed), rows[:, None], words[None, :], thr
    )  # (R, C) keep words (bit per column's plane)
    return ((kw >> bit[None, :]) & jnp.uint32(1)).astype(bool)


def _seed_from_key(key: jax.Array) -> jnp.ndarray:
    data = jax.random.key_data(key).reshape(-1)
    return (data[0] ^ data[-1]).astype(jnp.uint32)


def packed_lookup(packed: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray):
    """Membership test B[rows, cols] != 0 from the packed layout (used by the
    device-side negative sampler for O(1) positive exclusion)."""
    cols = cols.astype(jnp.uint32)
    word = (cols // TK) * TKP + (cols % TKP)
    bit = (cols % TK) // TKP
    w = packed[rows, word.astype(jnp.int32)]
    return ((w >> bit) & jnp.uint32(1)) > 0


def _t_xla(wp, x1t, x2t, seed1, seed2, p: float, masked: bool):
    """Both directions of the transposed-layout pair: y1t (d, m) =
    (B1 @ x1t^T)^T and y2t (d, K) = (B2^T @ x2t^T)^T, B1/B2 the unpacked
    matrix under each direction's keep mask. Inputs are rounded to bf16 and
    dotted in f32: 0/1 entries and bf16 values are exact in f32, so the
    products equal a bf16 x bf16 -> f32 dot."""
    b = _unpack_bits_jnp(wp).astype(jnp.float32)
    m, k = b.shape
    b1 = b2 = b
    if masked:
        b1 = jnp.where(keep_mask_dense(seed1, m, k, p), b, 0.0)
        b2 = jnp.where(keep_mask_dense(seed2, m, k, p), b, 0.0)
    x1f = x1t.astype(jnp.bfloat16).astype(jnp.float32)
    x2f = x2t.astype(jnp.bfloat16).astype(jnp.float32)
    y1t = jax.lax.dot_general(
        x1f, b1,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    y2t = jnp.dot(x2f, b2, preferred_element_type=jnp.float32)
    return y1t, y2t


def mask_words(wp: jnp.ndarray, key: jax.Array, p: float) -> jnp.ndarray:
    """Packed words with the coordinate-hashed keep mask APPLIED:
    ``wp & keepword(seed, row, word)`` over the full (m, kp) grid: the
    identical keep decision ``keep_mask_dense`` describes, materialized
    once per direction so all four products of a train step (forward and
    backward, both directions) reuse it instead of rehashing."""
    m, kp = wp.shape
    seed = _seed_from_key(key)
    rows = jax.lax.broadcasted_iota(jnp.uint32, (m, kp), 0)
    words = jax.lax.broadcasted_iota(jnp.uint32, (m, kp), 1)
    return wp & _keepword(seed, rows, words, _threshold_u8(p))


def _t1_unmasked(wp, x1t):
    b = _unpack_bits_jnp(wp).astype(jnp.float32)
    return jax.lax.dot_general(
        x1t.astype(jnp.bfloat16).astype(jnp.float32), b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def _t2_unmasked(wp, x2t):
    b = _unpack_bits_jnp(wp).astype(jnp.float32)
    return jnp.dot(
        x2t.astype(jnp.bfloat16).astype(jnp.float32), b,
        preferred_element_type=jnp.float32,
    )


@jax.custom_vjp
def bbt_pair_premasked(w1, w2, x1t, x2t):
    """Transposed-layout pair over PRE-MASKED packed operands: y1t (d, m) =
    (W1 @ x1t^T)^T, y2t (d, K) = (W2^T @ x2t^T)^T, where W1/W2 are
    ``mask_words`` outputs (or any packed matrices). The backward swaps the
    directions AND the operands with them — no hash anywhere in the four
    dots. This is feat_aggregate's training path (kernels/dense_graph.py)."""
    return _t1_unmasked(w1, x1t), _t2_unmasked(w2, x2t)


def _bbtp_fwd(w1, w2, x1t, x2t):
    return bbt_pair_premasked(w1, w2, x1t, x2t), (w1, w2)


def _bbtp_bwd(res, cts):
    w1, w2 = res
    dy1t, dy2t = cts
    # dx1t (d, K) = dy1t @ W1  (t2-orientation on W1);
    # dx2t (d, m) = (W2 @ dy2t^T)^T  (t1-orientation on W2)
    dx1t = _t2_unmasked(w1, dy1t)
    dx2t = _t1_unmasked(w2, dy2t)
    return (None, None, dx1t.astype(jnp.float32), dx2t.astype(jnp.float32))


bbt_pair_premasked.defvjp(_bbtp_fwd, _bbtp_bwd)


@jax.custom_vjp
def bbt_pair(wp, x1t, x2t):
    """Unmasked pair: y1t (d, m) = (B @ x1t^T)^T, y2t (d, K) = (B^T @ x2t^T)^T
    — both directions of the bit-packed operator in transposed layout."""
    return _t_xla(wp, x1t, x2t, jnp.uint32(0), jnp.uint32(0), 0.0, False)


def _bbt_fwd(wp, x1t, x2t):
    return bbt_pair(wp, x1t, x2t), (wp,)


def _bbt_bwd(res, cts):
    (wp,) = res
    dy1t, dy2t = cts
    # swap directions: dx2t (d, m) = (B @ dy2t^T)^T, dx1t (d, K) = dy1t @ B
    dx2t, dx1t = _t_xla(
        wp, dy2t, dy1t, jnp.uint32(0), jnp.uint32(0), 0.0, False
    )
    return (None, dx1t.astype(jnp.float32), dx2t.astype(jnp.float32))


bbt_pair.defvjp(_bbt_fwd, _bbt_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(5,))
def bbt_pair_dropped(wp, x1t, x2t, key1, key2, p: float):
    """Masked pair WITHOUT the 1/(1-p) rescale: direction 1 drops with
    ``key1``, direction 2 with ``key2`` (independent edge sets, reference
    model.py:435 — the feat matrix's user-side and item-side blocks each get
    their own keeps). Coordinate-hashed masks: the backward regenerates
    bit-identical drops from the same seeds."""
    s1, s2 = _seed_from_key(key1), _seed_from_key(key2)
    return _t_xla(wp, x1t, x2t, s1, s2, p, True)


def _bbtd_fwd(wp, x1t, x2t, key1, key2, p):
    s1, s2 = _seed_from_key(key1), _seed_from_key(key2)
    out = _t_xla(wp, x1t, x2t, s1, s2, p, True)
    return out, (wp, s1, s2)


def _bbtd_bwd(p, res, cts):
    wp, s1, s2 = res
    dy1t, dy2t = cts
    # swapped directions carry their ORIGINAL masks with them: direction-1's
    # cotangent flows through mask1 (now applied on the dir-2 orientation)
    dx2t, dx1t = _t_xla(wp, dy2t, dy1t, s2, s1, p, True)
    return (None, dx1t.astype(jnp.float32), dx2t.astype(jnp.float32),
            None, None)


bbt_pair_dropped.defvjp(_bbtd_fwd, _bbtd_bwd)


def _mm_xla(wp, x, seed, p: float, masked: bool, transpose: bool):
    b = _unpack_bits_jnp(wp)
    m, k = b.shape
    if masked:
        keep = keep_mask_dense(seed, m, k, p)
        b = jnp.where(keep, b, jnp.bfloat16(0.0))
    if transpose:
        return jax.lax.dot_general(
            b, x.astype(jnp.bfloat16),
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    return jnp.dot(b, x.astype(jnp.bfloat16), preferred_element_type=jnp.float32)


# -- public ops with custom VJPs ----------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def bb_matmul(wp, x, transpose: bool = False):
    """B @ x (or B^T @ x) with 1-bit-packed B; x grads flow through the
    opposite-orientation product over the same packed matrix."""
    return _mm_xla(wp, x, jnp.uint32(0), 0.0, False, transpose)


def _bb_fwd(wp, x, transpose):
    return bb_matmul(wp, x, transpose), (wp,)


def _bb_bwd(transpose, res, ct):
    (wp,) = res
    dx = _mm_xla(wp, ct, jnp.uint32(0), 0.0, False, not transpose)
    return (None, dx.astype(jnp.float32))


bb_matmul.defvjp(_bb_fwd, _bb_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def bb_matmul_dropped(wp, x, key, p: float, transpose: bool = False):
    """(B ∘ keep-mask(key, p)) @ x (or transposed), WITHOUT the 1/(1-p)
    rescale (callers fold the uniform scalar). The mask is coordinate-hashed,
    so forward and backward see bit-identical drops."""
    seed = _seed_from_key(key)
    return _mm_xla(wp, x, seed, p, True, transpose)


def _bbd_fwd(wp, x, key, p, transpose):
    seed = _seed_from_key(key)
    out = _mm_xla(wp, x, seed, p, True, transpose)
    return out, (wp, seed)


def _bbd_bwd(p, transpose, res, ct):
    wp, seed = res
    dx = _mm_xla(wp, ct, seed, p, True, not transpose)
    return (None, dx.astype(jnp.float32), None)


bb_matmul_dropped.defvjp(_bbd_fwd, _bbd_bwd)
