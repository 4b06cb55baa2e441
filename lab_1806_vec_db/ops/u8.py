"""First-class u8 compute: exact uint8 distances and k-means as GEMMs.

The reference treats `u8` as a full Scalar (src/scalar.rs:117-119): vectors
may live as raw bytes, distances are f32-mediated elementwise loops
(src/distance/mod.rs:79-95), and k-means accumulates in f32 to avoid u8
overflow, quantizing centroids back to u8 every Lloyd round
(src/distance/k_means.rs:113-160, overflow-guard test :222-240).

Device re-design — u8 is a NATIVE compute dtype here, not an ingest cast:
int8 GEMMs multiply int8 operands with int32 accumulation, so a u8 GEMM runs
at the device's int8 rate with EXACT integer results (the reference's f32
sums round above 2^24; dim=960 u8 dot products reach 6.2e7).  uint8 values
don't fit int8, so rows are centered by 128 — exactly representable — and
the cross term is reconstructed from per-row sums:

    a = a8 + 128,  b = b8 + 128          (a8, b8 in [-128, 127])
    dot(a, b) = a8.b8 + 128*(sum(a8) + sum(b8)) + dim*128^2

l2sqr(a, b) = ip_a + ip_b - 2 dot(a, b) is then exact int32 (max 960*255^2
~ 6.2e7 < 2^31); cosine divides the exact dot by f32 norms.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import distance as D


def u8_channels(x_u8: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Decompose (N, dim) uint8 rows into GEMM-ready channels.

    Returns (x8 (N, dim) int8 centered by 128,
             ip (N,) int32 exact dot(x, x),
             s8 (N,) int32 exact sum(x8))."""
    xi = x_u8.astype(jnp.int32)
    x8 = (xi - 128).astype(jnp.int8)
    ip = jnp.sum(xi * xi, axis=-1, dtype=jnp.int32)
    s8 = jnp.sum(xi - 128, axis=-1, dtype=jnp.int32)
    return x8, ip, s8


def dots_u8(a8, s8a, b8, s8b) -> jax.Array:
    """Exact (A, B) int32 dot products of the original u8 rows from centered
    int8 channels — one int8 GEMM plus rank-1 corrections."""
    dim = a8.shape[-1]
    cross = jnp.einsum(
        "ad,bd->ab", a8, b8, preferred_element_type=jnp.int32
    )
    return cross + 128 * (s8a[:, None] + s8b[None, :]) + jnp.int32(dim * 128 * 128)


def pairwise_u8_i32(a_u8: jax.Array, b_u8: jax.Array) -> jax.Array:
    """Exact (A, B) int32 squared-L2 distances between uint8 rows."""
    a8, ipa, s8a = u8_channels(a_u8)
    b8, ipb, s8b = u8_channels(b_u8)
    dot = dots_u8(a8, s8a, b8, s8b)
    return ipa[:, None] + ipb[None, :] - 2 * dot


@partial(jax.jit, static_argnames=("dist",))
def pairwise_u8(a_u8: jax.Array, b_u8: jax.Array, dist: str) -> jax.Array:
    """(A, B) f32 distances between uint8 rows (values exact in int32 for
    l2sqr; cosine is exact-dot / f32 norms).  Mirrors the reference's u8
    DistanceScalar semantics (src/distance/mod.rs:79-95)."""
    D.check_dist(dist)
    if dist == "l2sqr":
        return pairwise_u8_i32(a_u8, b_u8).astype(jnp.float32)
    a8, ipa, s8a = u8_channels(a_u8)
    b8, ipb, s8b = u8_channels(b_u8)
    dot = dots_u8(a8, s8a, b8, s8b).astype(jnp.float32)
    na = jnp.sqrt(ipa.astype(jnp.float32))
    nb = jnp.sqrt(ipb.astype(jnp.float32))
    return 1.0 - dot / jnp.maximum(na[:, None] * nb[None, :], 1e-10)


@partial(jax.jit, static_argnames=("k", "dist", "block"))
def knn_scan_u8(
    queries_u8: jax.Array,
    base8: jax.Array,      # (cap, dim) int8 centered base
    base_ip: jax.Array,    # (cap,) int32
    base_s8: jax.Array,    # (cap,) int32
    n_valid: jax.Array,
    k: int,
    dist: str,
    block: int = 131072,
) -> tuple[jax.Array, jax.Array]:
    """Exact brute-force u8 kNN: blocked int8 GEMM GEMM + running top-k.

    The u8 form of the Flat hot loop (reference flat_index.rs:48-57 over
    VecSet<u8>).  Returns ((B, k) f32 dists ascending, (B, k) int32 ids)."""
    from . import topk as T

    B = queries_u8.shape[0]
    cap, dim = base8.shape
    q8, qip, qs8 = u8_channels(queries_u8)
    block = min(block, cap)
    n_blocks = -(-cap // block)
    pad = n_blocks * block - cap
    if pad:
        base8 = jnp.pad(base8, ((0, pad), (0, 0)))
        base_ip = jnp.pad(base_ip, (0, pad))
        base_s8 = jnp.pad(base_s8, (0, pad))

    def body(carry, blk):
        best_d, best_i = carry
        start = blk * block
        tile8 = jax.lax.dynamic_slice(base8, (start, 0), (block, dim))
        tip = jax.lax.dynamic_slice(base_ip, (start,), (block,))
        ts8 = jax.lax.dynamic_slice(base_s8, (start,), (block,))
        cross = jnp.einsum("bd,nd->bn", q8, tile8, preferred_element_type=jnp.int32)
        dot = cross + 128 * (qs8[:, None] + ts8[None, :]) + jnp.int32(dim * 128 * 128)
        if dist == "l2sqr":
            d = (qip[:, None] + tip[None, :] - 2 * dot).astype(jnp.float32)
        else:
            nq = jnp.sqrt(qip.astype(jnp.float32))
            nt = jnp.sqrt(tip.astype(jnp.float32))
            d = 1.0 - dot.astype(jnp.float32) / jnp.maximum(
                nq[:, None] * nt[None, :], 1e-10
            )
        ids = start + jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
        d = jnp.where(ids < n_valid, d, jnp.inf)
        nd, ni = T.topk_smallest(d, ids, min(k, block))
        if k > block:
            nd = jnp.pad(nd, ((0, 0), (0, k - block)), constant_values=jnp.inf)
            ni = jnp.pad(ni, ((0, 0), (0, k - block)), constant_values=-1)
        return T.merge_topk(best_d, best_i, nd, ni, k), None

    best0 = (
        jnp.full((B, k), jnp.inf, jnp.float32),
        jnp.full((B, k), -1, jnp.int32),
    )
    (best_d, best_i), _ = jax.lax.scan(body, best0, jnp.arange(n_blocks))
    return best_d, jnp.where(jnp.isfinite(best_d), best_i, -1)


@partial(jax.jit, static_argnames=("k", "max_iter", "dist"))
def kmeans_fit_u8(
    key: jax.Array,
    data_u8: jax.Array,
    n_valid: jax.Array,
    k: int,
    max_iter: int,
    tol: float,
    dist: str,
) -> jax.Array:
    """Fit k u8 centroids; returns (k, dim) uint8.

    Mirrors the reference's u8 KMeans (k_means.rs:95-162) including its
    overflow discipline: per-cluster sums accumulate in f32 (u8 sums would
    wrap — guard test k_means.rs:222-240), means are cast back to u8 with
    round-toward-zero (`cast_from_f32`, scalar.rs:32-34), and the tol stop
    compares the QUANTIZED centroids, so the fixed point is a true u8 one.
    Assignment distances run exact on the int8 GEMM (see module docstring).
    """
    n_pad, dim = data_u8.shape
    valid = jnp.arange(n_pad) < n_valid
    d8, dip, ds8 = u8_channels(data_u8)
    data_f = data_u8.astype(jnp.float32)

    def dist_to(c_u8):
        """(N_pad, k) f32 distances data -> current u8 centroids."""
        c8, cip, cs8 = u8_channels(c_u8)
        dot = dots_u8(d8, ds8, c8, cs8)
        if dist == "l2sqr":
            return (dip[:, None] + cip[None, :] - 2 * dot).astype(jnp.float32)
        nd_ = jnp.sqrt(dip.astype(jnp.float32))
        nc = jnp.sqrt(cip.astype(jnp.float32))
        return 1.0 - dot.astype(jnp.float32) / jnp.maximum(
            nd_[:, None] * nc[None, :], 1e-10
        )

    # ---- k-means++ init (k_means.rs:61-87), data points are u8 so the
    # centroid picks stay exactly representable ----
    from .kmeans import _weighted_choice

    key, k0 = jax.random.split(key)
    first = jax.random.randint(k0, (), 0, jnp.maximum(n_valid, 1))
    centroids0 = jnp.zeros((k, dim), jnp.uint8).at[0].set(data_u8[first])

    def init_body(i, carry):
        centroids, weight, key = carry
        dlast = dist_to(centroids)[:, i - 1]
        weight = jnp.minimum(weight, dlast)
        key, sub = jax.random.split(key)
        c = _weighted_choice(sub, weight, valid)
        return centroids.at[i].set(data_u8[c]), weight, key

    weight0 = jnp.full((n_pad,), jnp.inf, jnp.float32)
    centroids, _, _ = jax.lax.fori_loop(1, k, init_body, (centroids0, weight0, key))

    # ---- Lloyd with f32 sums + per-round u8 re-quantization ----
    def body(carry):
        centroids, i, _ = carry
        a = jnp.argmin(dist_to(centroids), axis=1)
        w = jnp.where(valid, 1.0, 0.0)
        counts = jnp.zeros((k,), jnp.float32).at[a].add(w)
        sums = (
            jnp.zeros((k, dim), jnp.float32)
            .at[a]
            .add(jnp.where(valid[:, None], data_f, 0.0))
        )
        mean = sums / jnp.maximum(counts[:, None], 1.0)
        # round toward zero + saturate = the reference's `as u8` cast
        new_u8 = jnp.clip(jnp.trunc(mean), 0.0, 255.0).astype(jnp.uint8)
        new_c = jnp.where(counts[:, None] > 0, new_u8, centroids)
        # tol on the QUANTIZED centroids (k_means.rs:150-159 compares
        # new_centroid_sums.to_type::<T>() against the previous centroids)
        diff = jnp.max(
            jnp.sum(
                (new_c.astype(jnp.float32) - centroids.astype(jnp.float32)) ** 2,
                axis=1,
            )
        )
        return new_c, i + 1, diff

    def cond(carry):
        _, i, diff = carry
        return (i < max_iter) & (diff >= tol)

    centroids, _, _ = jax.lax.while_loop(
        cond, body, (centroids, jnp.int32(0), jnp.float32(jnp.inf))
    )
    return centroids


@partial(jax.jit, static_argnames=("dist",))
def find_nearest_u8(vectors_u8: jax.Array, centroids_u8: jax.Array, dist: str) -> jax.Array:
    """Nearest-u8-centroid ids (lowest-index tie break, k_means.rs:40-57)."""
    d = pairwise_u8(vectors_u8, centroids_u8, dist)
    return jnp.argmin(d, axis=1).astype(jnp.int32)
