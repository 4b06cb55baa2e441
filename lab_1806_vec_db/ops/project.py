"""PCA projection for reduced-dimension stage-1 candidate scans.

Rationale: the exact scan's cost is linear in `dim`; most of the 960
GIST dimensions carry little of the distance signal between near neighbors.
Projecting the base set onto its top `d_red` principal directions (one
(dim, dim) covariance GEMM on the device + a host `eigh` of the tiny matrix)
gives a stage-1 scan that reads and multiplies 1/4 the data at nearly the
same candidate ordering quality; the exact f32 rerank stage then restores
exactness for the returned top-k, the same two-stage contract as the int8
scan (models/flat.py).

This accelerator has no reference counterpart: the
reference's scalar CPU scan (src/index_algorithm/flat_index.rs:48-57) has no
analogous bandwidth cliff to exploit.  Correctness is unaffected — the
projection only orders candidates; distances returned to users always come
from the exact rerank.

For `l2sqr` the data is centered first (the mean cancels in differences, so
|P(x-mu) - P(q-mu)|^2 is the best rank-d_red approximation of |x-q|^2 in
expectation).  For `cosine` the raw second moment is used and vectors are
projected uncentered, preserving angles of the dominant subspace.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("center",))
def _moments(vecs: jax.Array, n_valid: jax.Array, center: bool):
    """((dim, dim) second-moment/covariance f32, (dim,) mean) over the first
    `n_valid` rows; padded rows are zero and fall out of both sums."""
    x = vecs.astype(jnp.float32)
    n = jnp.maximum(n_valid.astype(jnp.float32), 1.0)
    c = jax.lax.dot_general(x, x, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32)
    mu = jnp.sum(x, axis=0) / n
    if center:
        c = c - n * jnp.outer(mu, mu)
    else:
        mu = jnp.zeros_like(mu)
    return c, mu


def pca_fit(vecs: jax.Array, n_valid, d_red: int, dist: str) -> tuple[np.ndarray, np.ndarray]:
    """Fit the top-`d_red` principal directions of the device-resident
    `(cap, dim)` array (rows >= n_valid must be zero).

    Returns ((dim, d_red) f32 projection, (dim,) f32 mean to subtract before
    projecting — zeros for cosine).  The eigendecomposition runs on the host:
    the covariance is only (dim, dim).
    """
    center = dist == "l2sqr"
    c, mu = _moments(vecs, jnp.int32(n_valid), center)
    c_host = np.asarray(c, dtype=np.float64)
    # eigh returns ascending eigenvalues; take the trailing d_red columns
    _, eigvecs = np.linalg.eigh((c_host + c_host.T) / 2.0)
    proj = eigvecs[:, -d_red:][:, ::-1].astype(np.float32)
    return np.ascontiguousarray(proj), np.asarray(mu, dtype=np.float32)


@jax.jit
def project(x: jax.Array, proj: jax.Array, mu: jax.Array) -> jax.Array:
    """(B, dim) f32 -> (B, d_red) f32 projected (and centered) rows."""
    return jnp.dot(
        x.astype(jnp.float32) - mu[None, :], proj, preferred_element_type=jnp.float32
    )


@partial(jax.jit, static_argnames=("dist",))
def project_quantize(
    x: jax.Array, proj: jax.Array, mu: jax.Array, dist: str
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Project rows and quantize to the stage-1 int8 mirror format.

    Returns ((rows, d_red) int8, (rows,) f32 cross-factors, (rows,) f32
    additive terms) in the unified scan-channel convention.  Zero (padded)
    rows project to -mu@P and come back with real-looking channels: the
    CALLER must overwrite invalid rows' cache with the +BIG losing sentinel
    (the chunk-min scans have no positional masking — see
    models/store.py device_proj_int8 / _sync_rows_jit).
    """
    from . import distance as D
    from .topk import quantize_rows_int8

    xp = project(x, proj, mu)
    q8, scale = quantize_rows_int8(xp)
    cache = D.dist_cache(xp, dist)
    if dist == "cosine":
        # unified scan channels (topk.query_channels):
        # fold the norm into the cross factor, cache becomes additive 0
        scale = scale / jnp.maximum(cache, 1e-20)
        cache = jnp.zeros_like(cache)
    return q8, scale, cache
