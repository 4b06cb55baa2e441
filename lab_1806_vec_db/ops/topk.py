"""Top-k selection over distance tiles.

The reference maintains a bounded-k BTreeSet per query
(`ResultSet::add`, src/index_algorithm/candidate_pair.rs:61-74).  Here the
equivalent is a running (dists, ids) pair per query, merged tile-by-tile with
`lax.top_k` so the full (B, N) distance matrix never materializes in device
memory for large N — the blocked scan streams base tiles through one GEMM
each and keeps only the k-best.

Ordering parity: results ascend by distance; for ties, `lax.top_k` keeps the
lower-position element first, and tiles are scanned in index order, so ties
break toward the smaller index like the reference's (distance, index) order
(candidate_pair.rs:36-40).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import distance as D

INVALID_ID = jnp.int32(-1)
# Losing sentinel of the int8 scan mirror's additive channel: invalid rows
# carry it (with a zero cross factor) so they lose every min, for both
# metrics.  Finite, so the f32 epilogue never produces inf - inf.
BIG = 3.0e38
# Base rows per stage-1 survivor in the chunk-min scans.
CHUNK = 128


def topk_smallest(dists: jax.Array, ids: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Select the k smallest distances (last axis), sorted ascending.

    `dists` (..., C), `ids` (..., C) int32. Returns ((..., k), (..., k)).
    Padded slots should carry +inf distance.
    """
    neg, pos = jax.lax.top_k(-dists, k)
    return -neg, jnp.take_along_axis(ids, pos, axis=-1)


def merge_topk(
    best_d: jax.Array, best_i: jax.Array, new_d: jax.Array, new_i: jax.Array, k: int
) -> tuple[jax.Array, jax.Array]:
    """Merge a new candidate tile into the running k-best (both (..., *))."""
    d = jnp.concatenate([best_d, new_d], axis=-1)
    i = jnp.concatenate([best_i, new_i], axis=-1)
    return topk_smallest(d, i, k)


def select_smallest(d: jax.Array, ids: jax.Array, kk: int) -> tuple[jax.Array, jax.Array]:
    """Exact kk-smallest over the last axis, routed by width: wide rows use
    `approx_min_k(recall_target=1.0)` (exact at that target; XLA lowers
    it to an exact top-k on GPU and CPU), narrow rows the plain sort."""
    if d.shape[-1] > 4 * kk:
        bd, pos = jax.lax.approx_min_k(d, kk, recall_target=1.0)
        return bd, jnp.take_along_axis(ids, pos, axis=-1)
    return topk_smallest(d, ids, kk)


@partial(jax.jit, static_argnames=("k", "dist", "block"))
def knn_scan(
    queries: jax.Array,
    base: jax.Array,
    base_cache: jax.Array,
    n_valid: jax.Array,
    k: int,
    dist: str,
    block: int = 65536,
) -> tuple[jax.Array, jax.Array]:
    """Exact brute-force kNN: the Flat index hot loop as a blocked GEMM scan.

    The batched reformulation of `FlatIndex::knn`
    (reference: src/index_algorithm/flat_index.rs:48-57).

    queries: (B, dim); base: (N_pad, dim) with rows >= n_valid as padding;
    base_cache: (N_pad,) per-row dist cache. Returns (B, k) dists ascending
    and (B, k) int32 ids (-1 for missing when n_valid < k).
    """
    B = queries.shape[0]
    n_pad = base.shape[0]
    q = queries.astype(jnp.float32)
    q_cache = D.dist_cache(q, dist)

    select = select_smallest

    if n_pad <= block:
        d = D.pairwise(q, base, dist, q_cache=q_cache)
        ids = jax.lax.broadcasted_iota(jnp.int32, (B, n_pad), 1)
        d = jnp.where(ids < n_valid, d, jnp.inf)
        kk = min(k, n_pad)
        bd, bi = select(d, ids, kk)
        if kk < k:
            bd = jnp.pad(bd, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
            bi = jnp.pad(bi, ((0, 0), (0, k - kk)), constant_values=-1)
        return bd, jnp.where(jnp.isfinite(bd), bi, INVALID_ID)

    num_blocks = (n_pad + block - 1) // block
    pad_to = num_blocks * block
    if pad_to != n_pad:
        base = jnp.pad(base, ((0, pad_to - n_pad), (0, 0)))
        base_cache = jnp.pad(base_cache, (0, pad_to - n_pad))

    def body(carry, blk_idx):
        best_d, best_i = carry
        start = blk_idx * block
        tile = jax.lax.dynamic_slice(base, (start, 0), (block, base.shape[1]))
        tile_cache = jax.lax.dynamic_slice(base_cache, (start,), (block,))
        d = D.pairwise(q, tile, dist, q_cache=q_cache, base_cache=tile_cache)
        ids = start + jax.lax.broadcasted_iota(jnp.int32, (B, block), 1)
        d = jnp.where(ids < n_valid, d, jnp.inf)
        td, ti = select(d, ids, k)
        best_d, best_i = merge_topk(best_d, best_i, td, ti, k)
        return (best_d, best_i), None

    init = (
        jnp.full((B, k), jnp.inf, dtype=jnp.float32),
        jnp.full((B, k), INVALID_ID, dtype=jnp.int32),
    )
    (bd, bi), _ = jax.lax.scan(body, init, jnp.arange(num_blocks, dtype=jnp.int32))
    return bd, jnp.where(jnp.isfinite(bd), bi, INVALID_ID)


@partial(jax.jit, static_argnames=("dist",))
def int8_ordering_selftest(vecs: jax.Array, n_valid: jax.Array, key: jax.Array, dist: str) -> jax.Array:
    """Estimate whether per-row int8 quantization preserves NEIGHBOR ORDER
    on this dataset: mean fraction of each sampled query's exact top-10
    (within a 2048-row sample) found in its int8 top-12.

    Per-row int8 fails when inter-point gaps are tiny relative to point
    magnitudes (e.g. dense clusters far from the origin: the quantization
    step is sized by the large common component, the signal lives in the
    small residual).  Calibration: healthy datasets (uniform, or clusters
    with gaps >= ~1% of magnitudes) score 1.0; the pathological regime
    scores ~0.7 with end-to-end recall collapse.  Runs fully on device,
    returns a scalar in [0, 1].
    """
    ks, kq = jax.random.split(key)
    n = jnp.maximum(n_valid, 1)
    si = jax.random.randint(ks, (2048,), 0, n)
    qi = jax.random.randint(kq, (32,), 0, n)
    samp = vecs[si].astype(jnp.float32)
    qs = vecs[qi].astype(jnp.float32)

    def dists(a_dot_b, a_sq, b_sq):
        if dist == "l2sqr":
            return a_sq[:, None] + b_sq[None, :] - 2.0 * a_dot_b
        denom = jnp.maximum(
            jnp.sqrt(a_sq)[:, None] * jnp.sqrt(b_sq)[None, :], 1e-10
        )
        return 1.0 - a_dot_b / denom

    q_sq = jnp.sum(qs * qs, axis=1)
    s_sq = jnp.sum(samp * samp, axis=1)
    d_exact = dists(
        jnp.dot(qs, samp.T, precision=jax.lax.Precision.HIGHEST), q_sq, s_sq
    )
    q8s, ss = quantize_rows_int8(samp)
    q8q, sq = quantize_rows_int8(qs)
    dots8 = jnp.dot(q8q.astype(jnp.int32), q8s.astype(jnp.int32).T).astype(
        jnp.float32
    ) * (sq[:, None] * ss[None, :])
    d_int8 = dists(dots8, q_sq, s_sq)

    _, t_exact = jax.lax.top_k(-d_exact, 10)  # (32, 10)
    _, t_int8 = jax.lax.top_k(-d_int8, 12)  # (32, 12)
    hit = jnp.any(t_exact[:, :, None] == t_int8[:, None, :], axis=2)
    return jnp.mean(hit.astype(jnp.float32))


@jax.jit
def decode_perm(cand: jax.Array, perm: jax.Array, n_valid: jax.Array) -> jax.Array:
    """Map candidate ids from the scan-PERMUTED int8 mirror back to original
    row ids (store.device_int8 permutes rows to de-cluster storage order for
    the chunk-min scans).  Drops -1 inputs and decoded ids >= n_valid
    (invalid mirror rows carry losing sentinels but can still surface when a
    query's survivor group holds nothing better)."""
    orig = jnp.where(cand >= 0, perm[jnp.clip(cand, 0, perm.shape[0] - 1)], INVALID_ID)
    return jnp.where(orig < n_valid, orig, INVALID_ID)


@partial(jax.jit, static_argnames=("r", "dist", "block", "recall_target"))
def scan_candidates(
    queries: jax.Array,
    base_scan: jax.Array,
    base_cache: jax.Array,
    n_valid: jax.Array,
    r: int,
    dist: str,
    block: int = 0,
    recall_target: float = 0.99,
) -> tuple[jax.Array, jax.Array]:
    """Stage 1 of the two-stage exact scan: approximate candidate selection.

    One (or a few) bf16 GEMM(s) over the scan copy of the base set +
    `lax.approx_min_k`.  The distance
    matrix is kept in bf16 to halve its memory traffic — candidates are
    reranked exactly in f32 afterwards (stage 2, `knn_gathered`), so only
    candidate *selection* sees the quantization.  Blocking is chosen so the
    (B, block) intermediate stays under ~2 GB; per-block results are merged
    with a tiny top_k.

    queries: (B, dim) f32; base_scan: (N_pad, dim) bf16 (or f32);
    base_cache: (N_pad,) f32 per-row dist cache. Returns ((B, r) approx
    dists, (B, r) int32 ids, -1 padded), ascending.
    """
    B = queries.shape[0]
    n_pad, dim = base_scan.shape
    qs = queries.astype(base_scan.dtype)
    q_cache = D.dist_cache(queries.astype(jnp.float32), dist)
    if block <= 0:
        # bound the (B, block) bf16 intermediate to ~2 GB
        block = max(65536, min(n_pad, (2 << 30) // (2 * max(B, 1))))

    def block_dist(tile, tile_cache, start):
        dots = jax.lax.dot_general(
            qs, tile, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.bfloat16,
        )  # (B, block) — bf16 multiplies and output; selection-grade only
        if dist == "l2sqr":
            d = (q_cache[:, None] + tile_cache[None, :]).astype(jnp.bfloat16) - 2.0 * dots
        else:
            denom = jnp.maximum(q_cache[:, None] * tile_cache[None, :], 1e-10)
            d = 1.0 - dots / denom.astype(jnp.bfloat16)
        ids = start + jax.lax.broadcasted_iota(jnp.int32, (B, tile.shape[0]), 1)
        return jnp.where(ids < n_valid, d, jnp.inf).astype(jnp.bfloat16), ids

    def select(d, ids, rr):
        bd, pos = jax.lax.approx_min_k(d, rr, recall_target=recall_target)
        return bd.astype(jnp.float32), jnp.take_along_axis(ids, pos, axis=1)

    def pad_out(bd, bi, rr):
        if rr < r:
            bd = jnp.pad(bd, ((0, 0), (0, r - rr)), constant_values=jnp.inf)
            bi = jnp.pad(bi, ((0, 0), (0, r - rr)), constant_values=-1)
        return bd, jnp.where(jnp.isfinite(bd), bi, INVALID_ID)

    if n_pad <= block:
        d, ids = block_dist(base_scan, base_cache, jnp.int32(0))
        rr = min(r, n_pad)
        bd, bi = select(d, ids, rr)
        return pad_out(bd, bi, rr)

    num_blocks = (n_pad + block - 1) // block
    pad_to = num_blocks * block
    if pad_to != n_pad:
        base_scan = jnp.pad(base_scan, ((0, pad_to - n_pad), (0, 0)))
        base_cache = jnp.pad(base_cache, (0, pad_to - n_pad))
    rr = min(r, block)

    def body(carry, blk_idx):
        best_d, best_i = carry
        start = blk_idx * block
        tile = jax.lax.dynamic_slice(base_scan, (start, 0), (block, dim))
        tile_cache = jax.lax.dynamic_slice(base_cache, (start,), (block,))
        d, ids = block_dist(tile, tile_cache, start)
        td, ti = select(d, ids, rr)
        return merge_topk(best_d, best_i, td, ti, rr), None

    init = (
        jnp.full((B, rr), jnp.inf, dtype=jnp.float32),
        jnp.full((B, rr), INVALID_ID, dtype=jnp.int32),
    )
    (bd, bi), _ = jax.lax.scan(body, init, jnp.arange(num_blocks, dtype=jnp.int32))
    return pad_out(bd, bi, rr)


def quantize_rows_int8(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-row symmetric int8 quantization: x ~= q8 * scale[:, None].

    Returns ((N, dim) int8, (N,) f32 scales).  Zero rows get scale 1.
    """
    x = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(x), axis=1)
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    q8 = jnp.clip(jnp.round(x / scale[:, None]), -127, 127).astype(jnp.int8)
    return q8, scale


def query_channels(q_scale: jax.Array, q_cache: jax.Array, dist: str):
    """Query-side (qs2, qc) of the unified int8 scan formula

        d = cache_x + qc_q - dots * (scale_x * qs2_q)

    l2sqr:  cache=|x|^2, qc=|q|^2, scale=s_x,     qs2=2*s_q
    cosine: cache=0,     qc=1,     scale=s_x/|x|, qs2=s_q/|q|

    (1 - cos = 1 - dot/(|x||q|); the norms fold into the cross factors, so
    the cache channel is a pure additive bias: rows carrying +BIG there lose
    every min for both metrics.)  q_cache is D.dist_cache(q, dist)."""
    q_scale = q_scale.astype(jnp.float32)
    q_cache = q_cache.astype(jnp.float32)
    if dist == "l2sqr":
        return 2.0 * q_scale, q_cache
    return q_scale / jnp.maximum(q_cache, 1e-20), jnp.ones_like(q_cache)


def int8_queries(queries: jax.Array, dim_pad: int, dist: str):
    """(B, dim) f32 queries -> ((B, dim_pad) int8, (B,) qs2, (B,) qc) in the
    unified channel convention; columns zero-padded to the mirror's width
    (zeros are dot-transparent)."""
    q = queries.astype(jnp.float32)
    q8, q_scale = quantize_rows_int8(q)
    if dim_pad != q8.shape[1]:
        q8 = jnp.pad(q8, ((0, 0), (0, dim_pad - q8.shape[1])))
    qs2, qc = query_channels(q_scale, D.dist_cache(q, dist), dist)
    return q8, qs2, qc


def _int8_block_dist(q8, qs2, qc, tile, tile_scale, tile_cache):
    """(B, rows) f32 distances of one int8 base tile: exact int32 dots,
    then the unified channel epilogue in f32."""
    dots = jax.lax.dot_general(
        q8, tile, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
    ).astype(jnp.float32)
    return (tile_cache[None, :] + qc[:, None]) - dots * (
        tile_scale[None, :] * qs2[:, None]
    )


def _scan_block_rows(n_pad: int, B: int, bytes_per: int, floor: int) -> int:
    """Rows per scan block: bound the (B, block) intermediate to ~1 GB."""
    block = max(floor, (1 << 30) // (bytes_per * max(B, 1)))
    block = (block // floor) * floor
    return min(block, -(-n_pad // floor) * floor)


@partial(jax.jit, static_argnames=("r", "dist", "recall_target", "block"))
def scan_candidates_int8(
    queries: jax.Array,  # (B, dim) f32
    base_i8: jax.Array,  # (N_pad, dim_pad) int8 per-row quantized
    base_scale: jax.Array,  # (N_pad,) f32 cross-term factors (s_x or s_x/|x|)
    base_cache: jax.Array,  # (N_pad,) f32 additive terms (|x|^2 / 0 / +BIG)
    n_valid: jax.Array,
    r: int,
    dist: str,
    recall_target: float = 0.99,
    block: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Stage-1 candidate selection on an int8 GEMM (half the bytes of bf16).
    Same contract as `scan_candidates`.

    The int8 x int8 -> int32 GEMM computes raw dot products; dequantization
    is a rank-1 scale (q_scale x row_scale) fused into the distance epilogue.
    Exact caches keep the |q|^2/|x|^2 terms full-precision, so only the
    cross-term carries quantization error — selection-grade, reranked
    exactly afterwards (reference f32 parity: src/distance/mod.rs:71-95).
    Blocked over N so the (B, block) intermediate stays bounded at any N;
    per-block top-r lists merge with a small top_k.
    """
    B = queries.shape[0]
    n_pad, dim_pad = base_i8.shape
    q8, qs2, qc = int8_queries(queries, dim_pad, dist)
    if block <= 0:
        block = _scan_block_rows(n_pad, B, 4, 65536)
    rr = min(r, n_pad)

    def block_topr(start, rows):
        # bf16 (B, rows) distances: selection-grade values, half the bytes
        # into the top-r (the exact rerank fixes final distances anyway)
        d = _int8_block_dist(
            q8, qs2, qc,
            jax.lax.dynamic_slice_in_dim(base_i8, start, rows),
            jax.lax.dynamic_slice_in_dim(base_scale, start, rows),
            jax.lax.dynamic_slice_in_dim(base_cache, start, rows),
        ).astype(jnp.bfloat16)
        ids = start + jax.lax.broadcasted_iota(jnp.int32, (B, rows), 1)
        d = jnp.where(ids < n_valid, d, jnp.inf)
        k = min(rr, rows)
        if rows > 4 * k:
            bd, pos = jax.lax.approx_min_k(d, k, recall_target=recall_target)
            bi = jnp.take_along_axis(ids, pos, axis=1)
        else:
            bd, bi = topk_smallest(d, ids, k)
        return bd.astype(jnp.float32), bi

    best = _scan_blocks(block_topr, n_pad, block, B, rr)
    bd, bi = best
    if rr < r:
        bd = jnp.pad(bd, ((0, 0), (0, r - rr)), constant_values=jnp.inf)
        bi = jnp.pad(bi, ((0, 0), (0, r - rr)), constant_values=-1)
    return bd, jnp.where(jnp.isfinite(bd), bi, INVALID_ID)


def _scan_blocks(block_topr, n_pad: int, block: int, B: int, rr: int):
    """Running top-rr over `n_pad` rows: full `block`-row tiles in a
    lax.scan, then the tail tile once (no whole-base padding copy)."""
    best = (
        jnp.full((B, rr), jnp.inf, jnp.float32),
        jnp.full((B, rr), INVALID_ID, jnp.int32),
    )
    n_full = n_pad // block

    def body(carry, blk):
        return merge_topk(*carry, *block_topr(blk * block, block), rr), None

    if n_full:
        best, _ = jax.lax.scan(body, best, jnp.arange(n_full, dtype=jnp.int32))
    tail = n_pad - n_full * block
    if tail:
        best = merge_topk(*best, *block_topr(jnp.int32(n_full * block), tail), rr)
    return best


@partial(jax.jit, static_argnames=("block",))
def scan_chunkmin_int8(
    q8: jax.Array,  # (B, dim_pad) int8
    qs2: jax.Array,  # (B,) f32 query cross factors (query_channels)
    qc: jax.Array,  # (B,) f32 query additive terms
    base_i8: jax.Array,  # (N_pad, dim_pad) int8, N_pad a multiple of CHUNK
    base_scale: jax.Array,  # (N_pad,) f32
    base_cache: jax.Array,  # (N_pad,) f32, +BIG on invalid rows
    block: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Plain chunk-min int8 scan: the reference for the stage-1 kernel
    (ops/scan_triton.py) and its exact survivor contract.

    Chunk c is base rows [c*CHUNK, (c+1)*CHUNK).  Its survivor for query b
    is (min distance, row id of the min; the lowest row on ties), with the
    distance from exact int32 dots and the unified channel epilogue in f32.
    Returns ((B, S) f32, (B, S) int32), S = N_pad / CHUNK.  There is no
    positional masking: invalid rows must carry +BIG in the cache channel
    (store.device_int8's contract).
    """
    B = q8.shape[0]
    n_pad = base_i8.shape[0]
    if n_pad % CHUNK:
        raise ValueError(f"base rows {n_pad} must be a multiple of {CHUNK}")
    if block <= 0:
        block = _scan_block_rows(n_pad, B, 4, CHUNK)
    q8, qs2, qc = q8.astype(jnp.int8), qs2.astype(jnp.float32), qc.astype(jnp.float32)

    def chunk_min(start, rows):
        d = _int8_block_dist(
            q8, qs2, qc,
            jax.lax.dynamic_slice_in_dim(base_i8, start, rows),
            jax.lax.dynamic_slice_in_dim(base_scale, start, rows),
            jax.lax.dynamic_slice_in_dim(base_cache, start, rows),
        ).reshape(B, rows // CHUNK, CHUNK)
        arg = jnp.argmin(d, axis=2).astype(jnp.int32)
        first = start + jnp.arange(0, rows, CHUNK, dtype=jnp.int32)
        return jnp.min(d, axis=2), first[None, :] + arg

    n_full = n_pad // block
    parts_d, parts_i = [], []
    if n_full:
        _, (dm, im) = jax.lax.scan(
            lambda c, blk: (c, chunk_min(blk * block, block)),
            None, jnp.arange(n_full, dtype=jnp.int32),
        )
        parts_d.append(jnp.transpose(dm, (1, 0, 2)).reshape(B, -1))
        parts_i.append(jnp.transpose(im, (1, 0, 2)).reshape(B, -1))
    tail = n_pad - n_full * block
    if tail:
        dm, im = chunk_min(jnp.int32(n_full * block), tail)
        parts_d.append(dm)
        parts_i.append(im)
    return jnp.concatenate(parts_d, axis=1), jnp.concatenate(parts_i, axis=1)


def select_survivors(
    dmin: jax.Array, imin: jax.Array, r: int
) -> tuple[jax.Array, jax.Array]:
    """Top-r of the chunk-min survivors ((B, S) each) -> ((B, r) dists
    ascending, (B, r) ids, -1 padded).  Sentinel-valued survivors (chunks
    holding only invalid rows) come back as (inf, -1)."""
    rr = min(r, dmin.shape[1])
    bd, bi = select_smallest(dmin, imin, rr)
    if rr < r:
        bd = jnp.pad(bd, ((0, 0), (0, r - rr)), constant_values=jnp.inf)
        bi = jnp.pad(bi, ((0, 0), (0, r - rr)), constant_values=-1)
    bad = bd >= jnp.float32(1.0e38)
    return jnp.where(bad, jnp.inf, bd), jnp.where(bad, INVALID_ID, bi)


@partial(jax.jit, static_argnames=("dist",))
def exact_distances_sorted(
    queries: jax.Array,
    base: jax.Array,
    ids: jax.Array,
    dist: str,
    base_cache: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Exact f32 distances for small per-query id lists, sorted ascending.

    The final step of the two-stage scan: after candidate *selection* on the
    bf16 copy, gather only the chosen k rows from the f32 store and compute
    the exact distances the API returns (parity with the reference's f32
    scalar distances, src/distance/mod.rs:71-95).
    """
    B, k = ids.shape
    safe = jnp.maximum(ids, 0)
    v = base[safe].astype(jnp.float32)  # (B, k, dim)
    q = queries.astype(jnp.float32)
    if dist == "l2sqr":
        diff = q[:, None, :] - v
        d = jnp.sum(diff * diff, axis=-1)
    else:
        dots = jnp.sum(q[:, None, :] * v, axis=-1)
        if base_cache is not None:
            v_n = base_cache[safe]
        else:
            v_n = jnp.sqrt(jnp.sum(v * v, axis=-1))
        q_n = jnp.sqrt(jnp.sum(q * q, axis=-1, keepdims=True))
        d = 1.0 - dots / jnp.maximum(q_n * v_n, 1e-10)
    d = jnp.where(ids >= 0, d, jnp.inf)
    bd, pos = jax.lax.top_k(-d, k)
    bi = jnp.take_along_axis(ids, pos, axis=-1)
    bd = -bd
    return bd, jnp.where(jnp.isfinite(bd), bi, INVALID_ID)


def knn_gathered(
    queries: jax.Array,
    base: jax.Array,
    cand_ids: jax.Array,
    k: int,
    dist: str,
    base_cache: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """kNN over per-query candidate id lists (IVF probe scan, PQ rerank).

    queries: (B, dim); cand_ids: (B, C) int32 with -1 padding. Gathers the
    candidate vectors and reduces with one batched GEMV per query row.
    """
    B, C = cand_ids.shape
    safe = jnp.maximum(cand_ids, 0)
    vecs = base[safe]  # (B, C, dim)
    q = queries.astype(jnp.float32)
    if dist == "l2sqr":
        dots = jnp.einsum("bd,bcd->bc", q, vecs.astype(jnp.float32),
                          preferred_element_type=jnp.float32, precision=D.PRECISION)
        if base_cache is not None:
            v_sq = base_cache[safe]
        else:
            v_sq = jnp.sum(vecs.astype(jnp.float32) ** 2, axis=-1)
        q_sq = jnp.sum(q * q, axis=-1, keepdims=True)
        d = jnp.maximum(q_sq + v_sq - 2.0 * dots, 0.0)
    else:
        dots = jnp.einsum("bd,bcd->bc", q, vecs.astype(jnp.float32),
                          preferred_element_type=jnp.float32, precision=D.PRECISION)
        if base_cache is not None:
            v_n = base_cache[safe]
        else:
            v_n = jnp.sqrt(jnp.sum(vecs.astype(jnp.float32) ** 2, axis=-1))
        q_n = jnp.sqrt(jnp.sum(q * q, axis=-1, keepdims=True))
        d = 1.0 - dots / jnp.maximum(q_n * v_n, 1e-10)
    d = jnp.where(cand_ids >= 0, d, jnp.inf)
    kk = min(k, C)
    bd, bi = topk_smallest(d, cand_ids, kk)
    if kk < k:
        bd = jnp.pad(bd, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
        bi = jnp.pad(bi, ((0, 0), (0, k - kk)), constant_values=-1)
    return bd, jnp.where(jnp.isfinite(bd), bi, INVALID_ID)


@partial(jax.jit, static_argnames=("k", "dist", "block"))
def knn_gathered_blocked(
    queries: jax.Array,
    base: jax.Array,
    cand_ids: jax.Array,
    k: int,
    dist: str,
    block: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """`knn_gathered` over a wide candidate list in column blocks: each
    block gathers (B, block, dim) rows and keeps exact distances
    (`exact_distances_sorted`), merged into a running top-k, so the gather
    stays bounded (~1 GB) however many rows the candidate union spans.
    Returns ((B, k) exact dists ascending, (B, k) ids, -1 padded)."""
    B, C = cand_ids.shape
    if block <= 0:
        block = max(8, (1 << 28) // max(B * base.shape[1], 1))
    block = min(block, C)
    kk = min(k, block)
    n_full = C // block

    def part(ids):
        d, i = exact_distances_sorted(queries, base, ids, dist)
        return d[:, :kk], i[:, :kk]

    best = (
        jnp.full((B, kk), jnp.inf, jnp.float32),
        jnp.full((B, kk), INVALID_ID, jnp.int32),
    )

    def body(carry, blk):
        ids = jax.lax.dynamic_slice_in_dim(cand_ids, blk * block, block, axis=1)
        return merge_topk(*carry, *part(ids), kk), None

    if n_full:
        best, _ = jax.lax.scan(body, best, jnp.arange(n_full, dtype=jnp.int32))
    if C - n_full * block:
        best = merge_topk(*best, *part(cand_ids[:, n_full * block:]), kk)
    bd, bi = best
    if kk < k:
        bd = jnp.pad(bd, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
        bi = jnp.pad(bi, ((0, 0), (0, k - kk)), constant_values=-1)
    return bd, jnp.where(jnp.isfinite(bd), bi, INVALID_ID)
