"""On-device query binning for the batched IVF scan.

Problem shape: a batch of B queries each probes `p` posting lists
(ivf_index.rs:143-154 scans lists per query serially).  On a device the efficient
formulation inverts the loop: scan each LIST once against the block of
queries that probe it — a segmented dense GEMM.  That needs the inverse
mapping list -> (queries probing it), built here entirely on device with
static shapes (a host round-trip per batch would serialize the dispatch pipeline).

Construction: sort the (B*p) flat probe pairs by list id; the rank of a pair
within its list run (position - start offset of the run, offsets from a
histogram cumsum) is its slot in that list's fixed-width query bin.  Pairs
whose rank overflows QB are dropped (slot -1); callers size QB so overflow
is negligible and can count drops from the returned slots.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("nlist", "qb"))
def bin_queries(
    probe: jax.Array,  # (B, p) int32 list ids in [0, nlist)
    nlist: int,
    qb: int,
) -> tuple[jax.Array, jax.Array]:
    """Invert the query->lists probe map into fixed-width per-list bins.

    Returns:
      bins  (nlist, qb) int32 — query ids probing each list, -1 padded
      slots (B, p)     int32 — the bin slot of each probe pair, -1 if
                                dropped (bin overflow)
    """
    B, p = probe.shape
    m = B * p
    # probe-rank-major flattening: within each list's run, rank-0 (primary)
    # probes sort first, so bin overflow drops the LEAST important pairs
    flat = probe.T.reshape(m).astype(jnp.int32)  # element j*B + b
    order = jnp.argsort(flat, stable=True)  # (m,) pair indices by list id
    sorted_lists = flat[order]
    counts = jnp.zeros((nlist,), jnp.int32).at[flat].add(1)
    start = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)]
    )
    rank = jnp.arange(m, dtype=jnp.int32) - start[sorted_lists]
    qid_sorted = (order % B).astype(jnp.int32)

    # overflow ranks land in a sacrificial extra column, dropped afterwards
    col = jnp.minimum(rank, qb)
    bins = jnp.full((nlist, qb + 1), -1, jnp.int32)
    bins = bins.at[sorted_lists, col].set(qid_sorted)[:, :qb]

    slot_flat = jnp.where(rank < qb, rank, -1)
    slots = jnp.zeros((m,), jnp.int32).at[order].set(slot_flat).reshape(p, B).T
    return bins, slots
