"""Product quantization (PQ) kernels.

Device reformulation of the reference's PQ/ADC machinery
(src/distance/pq_table.rs):
- group split over dim with the same uneven `div_ceil` rule (pq_table.rs:38-53)
- per-group codebook training = m-way vmapped k-means over zero-padded
  subspace slices (pq_table.rs:141-191 trains each group's k-means on a
  dim-slice via `selected`; here the slice axis is padded to the max group
  width so all groups train in one batched kernel)
- encode = per-group distance GEMM + argmin -> (N, m) uint8 codes
  (pq_table.rs:66-91); 4-bit nibble packing (low nibble first) only for
  serialization parity (pq_table.rs:74-83)
- query lookup table build = m small GEMMs producing an (m, k) table of
  partial distances (L2Sqr) or partial dot products (Cosine)
  (pq_table.rs:195-224)
- ADC distance = gather-accumulate of table rows by code
  (pq_table.rs:239-301), with the Cosine norm reconstructed from cached
  per-centroid dot products exactly like the reference (pq_table.rs:291-299)

Zero-padding the subspace axis is distance-transparent: padded dims
contribute 0 to both dot products and squared distances.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import distance as D
from . import kmeans as KM
from . import topk as T


def pq_groups(dim: int, m: int) -> list[tuple[int, int]]:
    """Uneven group split, identical rule to pq_table.rs:38-53."""
    assert dim > 0 and m > 0 and dim >= m
    groups = []
    current = 0
    while current < dim:
        remaining_groups = m - len(groups)
        group_size = -(-(dim - current) // remaining_groups)  # div_ceil
        groups.append((current, current + group_size))
        current += group_size
    return groups


def group_gather_indices(dim: int, m: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(m, dsub_max) gather indices into the dim axis + validity mask."""
    groups = pq_groups(dim, m)
    dsub_max = max(e - s for s, e in groups)
    idx = np.zeros((m, dsub_max), dtype=np.int32)
    mask = np.zeros((m, dsub_max), dtype=bool)
    for g, (s, e) in enumerate(groups):
        w = e - s
        idx[g, :w] = np.arange(s, e)
        mask[g, :w] = True
    return idx, mask, dsub_max


def regroup(data: jax.Array, idx: jax.Array, mask: jax.Array) -> jax.Array:
    """(N, dim) -> (m, N, dsub_max) zero-padded subspace slices."""
    sliced = data[:, idx]  # (N, m, dsub_max)
    sliced = jnp.where(mask[None, :, :], sliced, 0.0)
    return jnp.transpose(sliced, (1, 0, 2))


@partial(jax.jit, static_argnames=("k", "max_iter", "dist"))
def train_codebooks(
    key: jax.Array,
    grouped: jax.Array,
    n_valid: jax.Array,
    k: int,
    max_iter: int,
    tol: float,
    dist: str,
) -> jax.Array:
    """Train all m codebooks in one vmapped k-means. grouped: (m, N, dsub)."""
    m = grouped.shape[0]
    keys = jax.random.split(key, m)
    fit = jax.vmap(lambda kk, gd: KM.kmeans_fit(kk, gd, n_valid, k, max_iter, tol, dist))
    return fit(keys, grouped)  # (m, k, dsub)


@partial(jax.jit, static_argnames=("dist",))
def encode(grouped: jax.Array, codebooks: jax.Array, dist: str) -> jax.Array:
    """Encode vectors: (m, N, dsub) x (m, k, dsub) -> (N, m) uint8 codes."""
    codes = jax.vmap(lambda gd, cb: KM.find_nearest(gd, cb, dist))(grouped, codebooks)
    return jnp.transpose(codes, (1, 0)).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("dist",))
def build_lookup(q_grouped: jax.Array, codebooks: jax.Array, dist: str) -> jax.Array:
    """Per-query lookup table: (m, B, dsub) x (m, k, dsub) -> (B, m, k).

    L2Sqr entries are partial squared distances; Cosine entries are partial
    dot products (pq_table.rs:204-213).
    """
    cb = codebooks.astype(jnp.float32)
    qg = q_grouped.astype(jnp.float32)
    dots = jnp.einsum(
        "mbd,mkd->bmk", qg, cb,
        preferred_element_type=jnp.float32, precision=D.PRECISION,
    )
    if dist == "cosine":
        return dots
    q_sq = jnp.sum(qg * qg, axis=-1)  # (m, B)
    c_sq = jnp.sum(cb * cb, axis=-1)  # (m, k)
    d = q_sq.T[:, :, None] + c_sq[None, :, :] - 2.0 * dots
    return jnp.maximum(d, 0.0)


def centroid_sqnorm_cache(codebooks: jax.Array) -> jax.Array:
    """(m, k) dot(c, c) cache for Cosine norm reconstruction
    (pq_table.rs:163-170)."""
    cb = codebooks.astype(jnp.float32)
    return jnp.sum(cb * cb, axis=-1)


def adc_lookup_codes(
    codes: jax.Array,
    lookup: jax.Array,
    cb_sqnorm: jax.Array | None,
    dist: str,
    q_norms: jax.Array | None = None,
) -> jax.Array:
    """ADC distances for per-query candidate code lists.

    codes: (B, C, m) uint8 candidate codes for each of B queries;
    lookup: (B, m, k) per-query table; q_norms: (B,) query norms (cosine).
    Returns (B, C) f32 distances.

    Batched equivalent of the scalar accumulation loop at pq_table.rs:252-299.
    """
    B, C, m = codes.shape
    k = lookup.shape[-1]
    offs = jnp.arange(m, dtype=jnp.int32) * k
    flat_idx = codes.astype(jnp.int32) + offs  # (B, C, m)
    lut_flat = lookup.reshape(B, m * k)
    gathered = jnp.take_along_axis(lut_flat, flat_idx.reshape(B, C * m), axis=-1)
    s = jnp.sum(gathered.reshape(B, C, m), axis=-1)
    if dist == "l2sqr":
        return s
    cb_flat = cb_sqnorm.reshape(-1)
    c_sq = jnp.sum(cb_flat[flat_idx], axis=-1)  # (B, C)
    norm0 = jnp.sqrt(c_sq)
    return 1.0 - s / jnp.maximum(norm0 * q_norms[:, None], 1e-10)


@partial(jax.jit, static_argnames=("k_out", "dist", "block"))
def adc_scan(
    lookup: jax.Array,
    codes: jax.Array,
    n_valid: jax.Array,
    cb_sqnorm: jax.Array,
    q_norms: jax.Array,
    k_out: int,
    dist: str,
    block: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Full ADC scan + top-k: the `FlatIndex::knn_pq` hot loop
    (reference: src/index_algorithm/flat_index.rs:84-104).

    lookup: (B, m, k); codes: (N_pad, m) uint8; q_norms: (B,) query norms
    (cosine) or zeros. Returns (B, k_out) dists/ids.

    The tile gather materializes (B, block, m) f32, so the block size must
    scale inversely with B*m (at B=1000, m=240, N=1e6 a fixed 131072 block
    meant a 126 GB intermediate).  ADC is a LUT-gather workload — the
    accelerated quantized scan is the int8 chunk-min scan (ops/backend.py);
    this path exists for reference parity and 8x-smaller-than-int8 memory.
    """
    B, m, k = lookup.shape
    n_pad = codes.shape[0]
    if block is None:
        # ~512 MB gather transient cap (floor 128 so huge B*m stays bounded)
        block = max(128, (1 << 27) // max(B * m, 1))
    lut_flat = lookup.reshape(B, m * k)
    offs = jnp.arange(m, dtype=jnp.int32) * k
    cb_flat = cb_sqnorm.reshape(-1)

    def tile_dists(code_tile):
        # code_tile: (nb, m) -> (B, nb) distances
        flat_idx = code_tile.astype(jnp.int32) + offs[None, :]  # (nb, m)
        g = lut_flat[:, flat_idx]  # (B, nb, m)
        s = jnp.sum(g, axis=-1)  # (B, nb)
        if dist == "l2sqr":
            return s
        c_sq = jnp.sum(cb_flat[flat_idx], axis=-1)  # (nb,)
        norm0 = jnp.sqrt(c_sq)[None, :]
        return 1.0 - s / jnp.maximum(norm0 * q_norms[:, None], 1e-10)

    if n_pad <= block:
        d = tile_dists(codes)
        ids = jax.lax.broadcasted_iota(jnp.int32, (B, n_pad), 1)
        d = jnp.where(ids < n_valid, d, jnp.inf)
        kk = min(k_out, n_pad)
        bd, bi = T.topk_smallest(d, ids, kk)
        if kk < k_out:
            bd = jnp.pad(bd, ((0, 0), (0, k_out - kk)), constant_values=jnp.inf)
            bi = jnp.pad(bi, ((0, 0), (0, k_out - kk)), constant_values=-1)
        return bd, jnp.where(jnp.isfinite(bd), bi, -1)

    num_blocks = (n_pad + block - 1) // block
    pad_to = num_blocks * block
    if pad_to != n_pad:
        codes = jnp.pad(codes, ((0, pad_to - n_pad), (0, 0)))

    def body(carry, blk):
        best_d, best_i = carry
        start = blk * block
        tile = jax.lax.dynamic_slice(codes, (start, 0), (block, m))
        d = tile_dists(tile)
        ids = start + jax.lax.broadcasted_iota(jnp.int32, (B, block), 1)
        d = jnp.where(ids < n_valid, d, jnp.inf)
        return T.merge_topk(best_d, best_i, d, ids, k_out), None

    init = (
        jnp.full((B, k_out), jnp.inf, jnp.float32),
        jnp.full((B, k_out), -1, jnp.int32),
    )
    (bd, bi), _ = jax.lax.scan(body, init, jnp.arange(num_blocks, dtype=jnp.int32))
    return bd, jnp.where(jnp.isfinite(bd), bi, -1)


def pack_codes_4bit(codes: np.ndarray) -> np.ndarray:
    """(N, m) 4-bit codes -> (N, ceil(m/2)) packed bytes, low nibble first
    (parity with pq_table.rs:74-83)."""
    n, m = codes.shape
    if m % 2 == 1:
        codes = np.concatenate([codes, np.zeros((n, 1), dtype=codes.dtype)], axis=1)
    lo = codes[:, 0::2].astype(np.uint8)
    hi = codes[:, 1::2].astype(np.uint8)
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_codes_4bit_dev(packed: jax.Array, m: int) -> jax.Array:
    """Device-side nibble unpack: (..., ceil(m/2)) bytes -> (..., m) codes
    (low nibble first, pq_table.rs:55-65).  Used where gathered packed code
    rows feed the XLA ADC lookup (the Pallas scan unpacks in-kernel)."""
    p = packed.astype(jnp.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    out = jnp.stack([lo, hi], axis=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)
    return out[..., :m]


def unpack_codes_4bit(packed: np.ndarray, m: int) -> np.ndarray:
    """(N, ceil(m/2)) packed bytes -> (N, m) codes (pq_table.rs:55-65)."""
    lo = packed & 0xF
    hi = packed >> 4
    n = packed.shape[0]
    out = np.empty((n, packed.shape[1] * 2), dtype=np.uint8)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    return out[:, :m]
