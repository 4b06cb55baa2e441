"""Batched graph link-selection kernels for HNSW construction.

The reference selects neighbors with a sequential heuristic: walk candidates
in ascending distance order and keep one only if no already-kept neighbor is
closer to it than it is to the query node
(`ResultSet::heuristic`, src/index_algorithm/candidate_pair.rs:85-99).
Reverse-link re-arrangement appends and, on overflow, re-prunes with the same
heuristic (`arrange_links`/`connect_new_links`, hnsw_index.rs:204-239).

On a device both become *batched* kernels: the candidate-pair distance matrices
are computed as batched GEMMs, and the heuristic's sequential dependence is
only over the candidate axis (C ~ 64), so it runs as a C-step masked scan
vectorized over all nodes in a chunk.  No pointer chasing, no host loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("limit",))
def heuristic_select(
    cand_ids: jax.Array,  # (B, C) int32 sorted ascending by distance, -1 padded
    cand_d: jax.Array,  # (B, C) f32 distance to the pivot node
    pair_d: jax.Array,  # (B, C, C) f32 distance between candidates
    limit: int,
) -> tuple[jax.Array, jax.Array]:
    """Batched HNSW neighbor-selection heuristic.

    Returns (sel_ids (B, limit) int32 -1 padded, keep_mask (B, C)).
    Semantics match candidate_pair.rs:85-99: iterate candidates in ascending
    order, keep while kept < limit and min_{kept q} pair_d[c, q] >= cand_d[c].
    """
    B, C = cand_ids.shape

    def body(j, state):
        keep, count = state
        valid = cand_ids[:, j] >= 0
        # min distance from candidate j to already-kept candidates
        dj = jnp.where(keep, pair_d[:, j, :], jnp.inf)
        min_pair = jnp.min(dj, axis=1)
        take = valid & (count < limit) & (min_pair >= cand_d[:, j])
        keep = keep.at[:, j].set(take)
        return keep, count + take.astype(jnp.int32)

    keep0 = jnp.zeros((B, C), bool)
    keep, _ = jax.lax.fori_loop(0, C, body, (keep0, jnp.zeros((B,), jnp.int32)))

    #

    # Compact kept candidates to the front, preserving ascending order.
    order = jnp.where(keep, jnp.arange(C, dtype=jnp.int32)[None, :], jnp.int32(C + 1))
    _, pos = jax.lax.top_k(-order, min(limit, C))  # positions of kept, in order
    sel = jnp.take_along_axis(jnp.where(keep, cand_ids, -1), pos, axis=1)
    sel_valid = jnp.take_along_axis(keep, pos, axis=1)
    sel = jnp.where(sel_valid, sel, -1)
    if limit > C:
        sel = jnp.pad(sel, ((0, 0), (0, limit - C)), constant_values=-1)
    return sel, keep


def sort_candidates(
    ids: jax.Array, d: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Sort candidate lists ascending by distance; invalid (-1) ids last."""
    d = jnp.where(ids >= 0, d, jnp.inf)
    C = ids.shape[-1]
    neg, pos = jax.lax.top_k(-d, C)
    return jnp.take_along_axis(ids, pos, axis=-1), -neg


@partial(jax.jit, static_argnames=("dist",))
def pairwise_among(
    vectors: jax.Array,  # (N_cap, dim)
    ids: jax.Array,  # (B, C) int32, -1 padded
    dist: str,
) -> jax.Array:
    """Batched (B, C, C) distance matrices among gathered candidate vectors."""
    from . import distance as D

    safe = jnp.maximum(ids, 0)
    v = vectors[safe].astype(jnp.float32)  # (B, C, dim)
    dots = jnp.einsum("bcd,bed->bce", v, v, preferred_element_type=jnp.float32, precision=D.PRECISION)
    if dist == "l2sqr":
        sq = jnp.sum(v * v, axis=-1)
        out = jnp.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * dots, 0.0)
    else:
        n = jnp.sqrt(jnp.sum(v * v, axis=-1))
        out = 1.0 - dots / jnp.maximum(n[:, :, None] * n[:, None, :], 1e-10)
    invalid = (ids < 0)[:, :, None] | (ids < 0)[:, None, :]
    return jnp.where(invalid, jnp.inf, out)


def _arrange_core(
    vectors: jax.Array,  # (N_cap, dim)
    links_rows: jax.Array,  # (P, L) int32 current links of each pivot, -1 padded
    pivot_ids: jax.Array,  # (P,) int32
    new_ids: jax.Array,  # (P, A) int32 new candidates to add, -1 padded
    dist: str,
    link_width: int,
) -> jax.Array:
    """Batched reverse-link arrangement (hnsw_index.rs:204-224).

    For each pivot p: candidates = current links + new ids (deduped).  If the
    total fits in `link_width`, keep all (existing first, preserving order);
    otherwise sort by distance to p and heuristic-prune to `link_width`.
    Returns the new (P, link_width) link rows.
    """
    from . import distance as D

    P, L = links_rows.shape
    A = new_ids.shape[1]
    C = L + A
    cand = jnp.concatenate([links_rows, new_ids], axis=1)  # (P, C)

    # Dedup: drop later duplicates (a new id may already be linked).
    eq = cand[:, :, None] == cand[:, None, :]
    tri = jnp.tril(jnp.ones((C, C), bool), k=-1)
    dup = jnp.any(eq & tri[None], axis=2) & (cand >= 0)
    cand = jnp.where(dup, -1, cand)

    valid = cand >= 0
    count = jnp.sum(valid, axis=1)

    # Distances pivot -> candidates.
    pv = vectors[pivot_ids].astype(jnp.float32)  # (P, dim)
    cv = vectors[jnp.maximum(cand, 0)].astype(jnp.float32)  # (P, C, dim)
    dots = jnp.einsum("pd,pcd->pc", pv, cv, preferred_element_type=jnp.float32, precision=D.PRECISION)
    if dist == "l2sqr":
        p_sq = jnp.sum(pv * pv, axis=-1, keepdims=True)
        c_sq = jnp.sum(cv * cv, axis=-1)
        cd = jnp.maximum(p_sq + c_sq - 2.0 * dots, 0.0)
    else:
        p_n = jnp.sqrt(jnp.sum(pv * pv, axis=-1, keepdims=True))
        c_n = jnp.sqrt(jnp.sum(cv * cv, axis=-1))
        cd = 1.0 - dots / jnp.maximum(p_n * c_n, 1e-10)
    cd = jnp.where(valid, cd, jnp.inf)

    # Sorted-by-distance view + heuristic prune (used only on overflow).
    sorted_ids, sorted_d = sort_candidates(cand, cd)
    pair = pairwise_among(vectors, sorted_ids, dist)
    pruned, _ = heuristic_select(sorted_ids, sorted_d, pair, link_width)

    # Non-overflow: keep candidates in their existing order, compacted.
    order = jnp.where(valid, jnp.arange(C, dtype=jnp.int32)[None, :], jnp.int32(C + 1))
    _, pos = jax.lax.top_k(-order, min(link_width, C))
    appended = jnp.take_along_axis(cand, pos, axis=1)
    appended = jnp.where(jnp.take_along_axis(valid, pos, axis=1), appended, -1)
    if link_width > C:
        appended = jnp.pad(appended, ((0, 0), (0, link_width - C)), constant_values=-1)

    overflow = (count > link_width)[:, None]
    return jnp.where(overflow, pruned, appended)


@partial(jax.jit, static_argnames=("dist", "link_width"))
def arrange_links_batch(
    vectors: jax.Array,  # (N_cap, dim)
    links_rows: jax.Array,  # (P, L) int32 current links of each pivot, -1 padded
    pivot_ids: jax.Array,  # (P,) int32
    new_ids: jax.Array,  # (P, A) int32 new candidates to add, -1 padded
    dist: str,
    link_width: int,
) -> jax.Array:
    """Host-facing arrange: takes explicit rows, returns new rows (see
    `_arrange_core`)."""
    return _arrange_core(vectors, links_rows, pivot_ids, new_ids, dist, link_width)


@partial(jax.jit, static_argnames=("dist", "link_width"), donate_argnums=(1,))
def arrange_links_inplace(
    vectors: jax.Array,  # (N_cap, dim)
    links_dev: jax.Array,  # (cap, link_width) int32 — DEVICE-CANONICAL links
    piv_new: jax.Array,  # (P, 1 + A) int32: column 0 = pivot id, rest = new
    # candidate ids (-1 padded).  Pivot entries >= cap are dummies (dropped).
    dist: str,
    link_width: int,
) -> jax.Array:
    """Device-resident arrange: gather pivot rows from `links_dev`, run the
    arrange core, scatter the new rows back, return the updated (donated)
    matrix.  No link data crosses the host boundary — the transport-bound
    upload/download of pivot rows disappears.  Pivot ids and add-lists ride ONE packed
    upload (column 0) to halve per-round transport round trips.

    Dummy pivot entries use an out-of-range id (>= cap): the gather clips
    (the read row is irrelevant) and the scatter drops them (`mode="drop"`),
    so padding can never corrupt a real row — scattering a duplicated REAL
    pivot id would race with that pivot's own update.
    """
    pivot_ids = piv_new[:, 0]
    new_ids = piv_new[:, 1:]
    rows = links_dev[jnp.minimum(pivot_ids, links_dev.shape[0] - 1)]
    new_rows = _arrange_core(vectors, rows, pivot_ids, new_ids, dist, link_width)
    return links_dev.at[pivot_ids].set(new_rows, mode="drop")
