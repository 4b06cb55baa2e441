"""Distance kernels as batched GEMMs.

The reference computes distances with scalar loops over `&[T]`
(src/distance/mod.rs:71-95) and a cached-distance identity
`(a-b)^2 = a^2 + b^2 - 2ab` (src/distance/mod.rs:54-57).  On a device that
identity *is* the kernel decomposition: the `ab` term is a `(B, dim) x
(dim, N)` matmul, and the row norms are precomputed caches —
exactly the reference's `dist_cache` (src/distance/mod.rs:31-36), stored
per index as a device array.

Supported algorithms (parity with DistanceAlgorithm, src/distance/mod.rs:18-28):
- "l2sqr":  squared Euclidean, range [0, inf)
- "cosine": 1 - cos_sim, range [0, 2]
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

DISTANCES = ("l2sqr", "cosine")

# Matmul precision of every f32 distance GEMM that returned distances or
# an oracle depend on: full f32.  JAX's default lets a GPU run f32 matmuls
# in TF32 (~3 decimal digits), which flips near-tie neighbor orderings
# against the f32 reference.
PRECISION = jax.lax.Precision.HIGHEST


def check_dist(dist: str) -> str:
    if dist not in DISTANCES:
        raise ValueError("Invalid distance function")
    return dist


def dist_cache(x: jax.Array, dist: str) -> jax.Array:
    """Per-row cache: dot(a,a) for l2sqr, norm(a) for cosine.

    Mirrors `DistanceAlgorithm::dist_cache` (src/distance/mod.rs:31-36).
    `x` is (..., dim); returns (...,) float32.
    """
    sq = jnp.sum(x.astype(jnp.float32) * x.astype(jnp.float32), axis=-1)
    if dist == "l2sqr":
        return sq
    return jnp.sqrt(sq)


def pairwise(
    queries: jax.Array,
    base: jax.Array,
    dist: str,
    q_cache: jax.Array | None = None,
    base_cache: jax.Array | None = None,
) -> jax.Array:
    """All-pairs distances (B, N) between queries (B, dim) and base (N, dim).

    One GEMM + rank-1 corrections; float32 accumulation.
    """
    check_dist(dist)
    q = queries.astype(jnp.float32)
    b = base.astype(jnp.float32)
    dots = jax.lax.dot_general(
        q, b, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32, precision=PRECISION,
    )  # (B, N)
    if q_cache is None:
        q_cache = dist_cache(q, dist)
    if base_cache is None:
        base_cache = dist_cache(b, dist)
    if dist == "l2sqr":
        d = q_cache[:, None] + base_cache[None, :] - 2.0 * dots
        return jnp.maximum(d, 0.0)
    denom = jnp.maximum(q_cache[:, None] * base_cache[None, :], 1e-10)
    return 1.0 - dots / denom


def pointwise(a: jax.Array, b: jax.Array, dist: str) -> jax.Array:
    """Row-wise distances between a (..., dim) and b (..., dim) -> (...,).

    Used for small candidate sets (gathered neighbor blocks); elementwise.
    l2sqr is computed directly (no cancellation), matching the
    reference's uncached path (src/distance/mod.rs:75-77).
    """
    check_dist(dist)
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    if dist == "l2sqr":
        diff = a - b
        return jnp.sum(diff * diff, axis=-1)
    dots = jnp.sum(a * b, axis=-1)
    na = jnp.sqrt(jnp.sum(a * a, axis=-1))
    nb = jnp.sqrt(jnp.sum(b * b, axis=-1))
    return 1.0 - dots / jnp.maximum(na * nb, 1e-10)


def calc_dist_host(a, b, dist: str = "cosine") -> float:
    """Host scalar helper backing the public `calc_dist`
    (reference: src/pyo3/mod.rs:43-48). Raises ValueError on a bad name or
    mismatched dims."""
    check_dist(dist)
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError("calc_dist expects two 1-D vectors of equal length")
    if dist == "l2sqr":
        d = a - b
        return float(np.dot(d, d))
    denom = max(float(np.linalg.norm(a) * np.linalg.norm(b)), 1e-10)
    return float(1.0 - np.dot(a, b) / denom)
