"""Batched k-means as GEMMs.

Batched reformulation of the reference's rayon-parallel k-means
(src/distance/k_means.rs):
- k-means++ init with distance-weighted sampling (k_means.rs:61-87) using
  `jax.random.categorical` over masked log-weights; all-zero weights fall
  back to uniform like the reference (k_means.rs:80-82).
- Lloyd iterations (k_means.rs:114-160): assignment is a (N, k) distance
  GEMM + argmin; the centroid update is a scatter-add (segment sum) in f32
  accumulators; empty clusters keep their previous centroid
  (k_means.rs:131-137); tol-based early stop on max centroid movement
  (k_means.rs:150-159).
- The reference's `selected` dim-range (k_means.rs:30,105-109) is handled by
  the caller slicing the dim axis before the call (PQ subspaces vmap this
  function over groups).

All functions are jittable and vmappable; everything is fixed-shape with
validity masks so XLA tiles the GEMMs onto GEMMs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import distance as D


def _weighted_choice(key: jax.Array, weights: jax.Array, valid: jax.Array) -> jax.Array:
    """Sample an index proportionally to `weights` over `valid` slots.

    Falls back to uniform over valid slots when all weights are zero or
    non-finite (reference: k_means.rs:80-82).
    """
    w = jnp.where(valid, weights, 0.0)
    w = jnp.where(jnp.isfinite(w), w, 0.0)
    total = jnp.sum(w)
    logits = jnp.where(
        (total > 0.0) & valid,
        jnp.log(jnp.maximum(w, 1e-38)),
        jnp.where(valid, 0.0, -jnp.inf),
    )
    # When total > 0, invalid/zero-weight slots must be excluded entirely.
    logits = jnp.where((total > 0.0) & (w <= 0.0), -jnp.inf, logits)
    return jax.random.categorical(key, logits)


@partial(jax.jit, static_argnames=("k", "max_iter", "dist"))
def kmeans_fit(
    key: jax.Array,
    data: jax.Array,
    n_valid: jax.Array,
    k: int,
    max_iter: int,
    tol: float,
    dist: str,
) -> jax.Array:
    """Fit k centroids; returns (k, dim) float32.

    data: (N_pad, dim) with rows >= n_valid zero-padded.
    """
    n_pad, dim = data.shape
    data = data.astype(jnp.float32)
    valid = jnp.arange(n_pad) < n_valid

    # ---- k-means++ init (k_means.rs:61-87) ----
    key, k0 = jax.random.split(key)
    first = jax.random.randint(k0, (), 0, jnp.maximum(n_valid, 1))
    centroids0 = jnp.zeros((k, dim), jnp.float32).at[0].set(data[first])

    def init_body(i, carry):
        centroids, weight, key = carry
        # update weights with distance to the most recently added centroid
        last = centroids[i - 1]
        d = D.pointwise(data, last[None, :], dist)
        weight = jnp.minimum(weight, d)
        key, sub = jax.random.split(key)
        c = _weighted_choice(sub, weight, valid)
        centroids = centroids.at[i].set(data[c])
        return centroids, weight, key

    weight0 = jnp.full((n_pad,), jnp.inf, jnp.float32)
    centroids, _, _ = jax.lax.fori_loop(1, k, init_body, (centroids0, weight0, key))

    # ---- Lloyd iterations (k_means.rs:114-160) ----
    # The update is a BLOCKED one-hot matmul, not a scatter-add: assignment
    # + accumulation stream the data in row blocks, so the per-iteration
    # temps are (blk, k) one-hots and (blk, dim) slices.  A scatter-add
    # formulation (`.at[a].add(masked_data)`) materializes an (N_pad, dim)
    # masked copy, which for PQ's vmapped subspace k-means (dim = dsub ~ 3,
    # m=320 groups) is a large temporary once the layout pads the tiny
    # minor dim.  The matmul form also avoids materializing the full
    # (N_pad, k) distance matrix.
    valid_f = jnp.where(valid, 1.0, 0.0)
    blk = int(min(n_pad, 8192))
    n_blocks = -(-n_pad // blk)
    if n_blocks * blk != n_pad:
        data_b = jnp.pad(data, ((0, n_blocks * blk - n_pad), (0, 0)))
        valid_b = jnp.pad(valid_f, (0, n_blocks * blk - n_pad))
    else:
        data_b, valid_b = data, valid_f

    def update(centroids):
        def body(carry, i):
            counts, sums = carry
            db = jax.lax.dynamic_slice(data_b, (i * blk, 0), (blk, dim))
            vb = jax.lax.dynamic_slice(valid_b, (i * blk,), (blk,))
            d = D.pairwise(db, centroids, dist)  # (blk, k)
            a = jnp.argmin(d, axis=1)
            oh = (a[:, None] == jnp.arange(k)[None, :]) * vb[:, None]  # (blk, k)
            counts = counts + jnp.sum(oh, axis=0)
            sums = sums + jax.lax.dot_general(
                oh, db, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            return (counts, sums), None

        (counts, sums), _ = jax.lax.scan(
            body,
            (jnp.zeros((k,), jnp.float32), jnp.zeros((k, dim), jnp.float32)),
            jnp.arange(n_blocks, dtype=jnp.int32),
        )
        new_c = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0), centroids)
        return new_c

    def cond(carry):
        _, i, diff = carry
        return (i < max_iter) & (diff >= tol)

    def body(carry):
        centroids, i, _ = carry
        new_c = update(centroids)
        diff = jnp.max(jnp.sum((new_c - centroids) ** 2, axis=1))
        return new_c, i + 1, diff

    centroids, _, _ = jax.lax.while_loop(
        cond, body, (centroids, jnp.int32(0), jnp.float32(jnp.inf))
    )
    return centroids


@partial(jax.jit, static_argnames=("dist",))
def find_nearest(vectors: jax.Array, centroids: jax.Array, dist: str) -> jax.Array:
    """Nearest-centroid ids (argmin over a distance GEMM).

    Mirrors `find_nearest_base` including the lowest-index tie break
    (reference: k_means.rs:40-57).  vectors: (N, dim) -> (N,) int32.
    """
    d = D.pairwise(vectors, centroids, dist)
    return jnp.argmin(d, axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_probes", "dist"))
def find_n_nearest(vectors: jax.Array, centroids: jax.Array, n_probes: int, dist: str):
    """Top-n_probes nearest centroids per vector, ascending by distance.

    Mirrors `KMeans::find_n_nearest` (reference: k_means.rs:174-191).
    Returns ((N, n_probes) dists, (N, n_probes) int32 ids).
    """
    from . import topk as T

    d = D.pairwise(vectors, centroids, dist)
    ids = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
    return T.topk_smallest(d, ids, min(n_probes, centroids.shape[0]))
