"""Batched lock-step beam search over a neighbor graph.

The reference's HNSW search is a sequential best-first loop per query with a
HashSet visited set and BTreeSet frontier (src/index_algorithm/hnsw_index.rs:258-291).
That shape cannot use a wide device.  Here the traversal is reformulated as a
*batched beam search*: a whole batch of queries advances in lock step; per
step each query expands its best unexpanded beam entries, gathers their
neighbor id blocks, computes all neighbor distances as one batched
gather+GEMM, and merges into a sorted (ef)-wide beam with `lax.top_k`.

Visited-set semantics: the beam itself deduplicates (membership test by
broadcast compare), plus a small ring buffer of recently expanded nodes
catches re-discovery of evicted nodes.  A node that escapes both is merely
re-scored — correctness is unaffected, only a little extra work, the same
correctness-by-construction argument the reference uses for its batch-insert
race tolerance (hnsw_index.rs:430-437).

Termination matches the reference's `check_candidate` rule
(candidate_pair.rs:55-57): the loop stops when no beam entry is left
unexpanded — any candidate outside the ef-best has been evicted, which is
exactly when the sequential loop would `break`.

The distance function is a closure so the same traversal serves exact
vector distance (HNSW search/build) and PQ ADC distance (knn_pq,
hnsw_index.rs:672-697).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

Array = jax.Array

# node_dist_fn: (B, C) int32 ids -> (B, C) f32 distances.  Ids may be -1
# (invalid): the fn may return ANY value there (callers mask), but must not
# fault.
NodeDistFn = Callable[[Array], Array]
# links_fn: (B, E) int32 ids -> (B, E, L) int32 neighbor ids (-1 padded)
LinksFn = Callable[[Array], Array]


def _sorted_merge(beam_d, beam_i, beam_e, nd, nids, ef: int):
    """Merge a candidate tile into the sorted beam: top_k over the
    concatenation, carrying ids and expansion flags by position gather.

    `lax.top_k` is stable by position, so ties break toward the existing
    beam (it sits first in the concatenation) — the same tie order the
    reference's (distance, index) BTreeSet maintains for already-present
    entries.
    """
    all_d = jnp.concatenate([beam_d, nd], axis=1)
    all_i = jnp.concatenate([beam_i, nids], axis=1)
    all_e = jnp.concatenate([beam_e, jnp.zeros_like(nd, dtype=bool)], axis=1)
    neg, pos = jax.lax.top_k(-all_d, ef)
    return (
        -neg,
        jnp.take_along_axis(all_i, pos, axis=1),
        jnp.take_along_axis(all_e, pos, axis=1),
    )


def beam_search(
    entry: Array,
    node_dist_fn: NodeDistFn,
    links_fn: LinksFn,
    ef: int,
    max_iters: int,
    expand: int = 1,
    ring_size: int = 64,
    with_stats: bool = False,
) -> tuple[Array, ...]:
    """Run lock-step beam search from per-query entry points.

    entry: (B,) int32 node ids.
    Returns (beam_dists, beam_ids): (B, ef) sorted ascending, -1 padded;
    with_stats additionally returns (B,) int32 NOVEL rows scored per query
    (the beam's work measure).
    """
    B = entry.shape[0]
    E = expand
    R = ring_size

    entry_d = node_dist_fn(entry[:, None])[:, 0]  # (B,)
    beam_d = jnp.full((B, ef), jnp.inf, jnp.float32).at[:, 0].set(entry_d)
    beam_i = jnp.full((B, ef), -1, jnp.int32).at[:, 0].set(entry)
    expanded = jnp.zeros((B, ef), bool)
    ring = jnp.full((B, R), -1, jnp.int32)
    ring_pos = jnp.zeros((B,), jnp.int32)
    rows = jnp.ones((B,), jnp.int32)  # entry row is scored up front

    def cond(state):
        beam_d, beam_i, expanded, ring, ring_pos, rows, it = state
        unexp = (~expanded) & (beam_i >= 0)
        return (it < max_iters) & jnp.any(unexp)

    def body(state):
        beam_d, beam_i, expanded, ring, ring_pos, rows, it = state
        unexp = (~expanded) & (beam_i >= 0)
        active = jnp.any(unexp, axis=1)  # (B,)

        # Select the E best (lowest-slot) unexpanded entries per query.
        # Beam is sorted ascending, so slot order == best-first order and
        # "the E best unexpanded" = "unexpanded with running count <= E" —
        # a cumsum + compare + tiny one-hot contraction, NOT a per-iteration
        # (B, ef) top_k sort.
        rank = jnp.cumsum(unexp.astype(jnp.int32), axis=1)  # (B, ef) 1-based
        sel_mask = unexp & (rank <= E)  # (B, ef)
        onehot = (
            sel_mask[:, :, None]
            & (rank[:, :, None] == jnp.arange(1, E + 1, dtype=jnp.int32)[None, None, :])
        )  # (B, ef, E): slot j feeds expansion lane rank-1
        sel_valid = jnp.any(onehot, axis=1)  # (B, E)
        cand = jnp.max(
            jnp.where(onehot, beam_i[:, :, None], jnp.int32(-1)), axis=1
        )  # (B, E), -1 where no such slot
        cand_safe = jnp.maximum(cand, 0)
        exp_new = expanded | sel_mask

        # Gather neighbor blocks and flatten the expansion axis.
        nbrs = links_fn(cand_safe)  # (B, E, L)
        L = nbrs.shape[-1]
        nbrs = jnp.where(sel_valid[:, :, None], nbrs, -1).reshape(B, E * L)

        valid = nbrs >= 0
        # Dedup against current beam membership.
        in_beam = jnp.any(nbrs[:, :, None] == beam_i[:, None, :], axis=2)
        # Dedup against the recently-expanded ring buffer.
        in_ring = jnp.any(nbrs[:, :, None] == ring[:, None, :], axis=2)
        # Dedup within the tile (earlier occurrence wins).
        if E * L > 1:
            eq = nbrs[:, :, None] == nbrs[:, None, :]
            tri = jnp.tril(jnp.ones((E * L, E * L), bool), k=-1)
            dup = jnp.any(eq & tri[None, :, :], axis=2)
        else:
            dup = jnp.zeros_like(valid)
        fresh = valid & ~in_beam & ~in_ring & ~dup

        # Novel-first compaction (scatter-free, same one-hot trick as the
        # expansion select): fresh ids move to the FRONT of the tile, stale
        # slots become a -1 tail; the prefix count is the novel-row stat.
        # Order within the tile is irrelevant to the merge.
        EL = E * L
        crank = jnp.cumsum(fresh.astype(jnp.int32), axis=1)  # 1-based
        hit = fresh[:, :, None] & (
            crank[:, :, None] == (1 + jnp.arange(EL, dtype=jnp.int32))[None, None, :]
        )  # (B, EL src, EL dst)
        comp = jnp.max(jnp.where(hit, nbrs[:, :, None], jnp.int32(-1)), axis=1)

        nd = node_dist_fn(comp)
        nd = jnp.where(comp >= 0, nd, jnp.inf)
        nids = comp

        # Merge into the sorted beam, carrying expansion flags through.
        beam_d, beam_i, expanded2 = _sorted_merge(beam_d, beam_i, exp_new, nd, nids, ef)
        beam_i = jnp.where(jnp.isfinite(beam_d), beam_i, -1)
        expanded2 = jnp.where(beam_i >= 0, expanded2, False)

        # Push expanded nodes into the ring buffer.  Same de-scatter
        # treatment: the E slots written this step are distinct (consecutive
        # mod R, E <= R), so a one-hot max-select over the E axis replaces
        # the scatter exactly.
        ring_slots = (ring_pos[:, None] + jnp.arange(E, dtype=jnp.int32)[None, :]) % R
        write = sel_valid & active[:, None]  # (B, E)
        slot_hit = (
            ring_slots[:, :, None] == jnp.arange(R, dtype=jnp.int32)[None, None, :]
        ) & write[:, :, None]  # (B, E, R)
        upd = jnp.max(jnp.where(slot_hit, cand[:, :, None], jnp.int32(-1)), axis=1)
        ring = jnp.where(jnp.any(slot_hit, axis=1), upd, ring)
        ring_pos = ring_pos + jnp.sum(sel_valid, axis=1).astype(jnp.int32)
        rows = rows + jnp.where(active, crank[:, -1], 0)

        return beam_d, beam_i, expanded2, ring, ring_pos, rows, it + 1

    beam_d, beam_i, expanded, ring, ring_pos, rows, _ = jax.lax.while_loop(
        cond, body, (beam_d, beam_i, expanded, ring, ring_pos, rows,
                     jnp.int32(0))
    )
    if with_stats:
        return beam_d, beam_i, rows
    return beam_d, beam_i


def greedy_descent(
    entry: Array,
    node_dist_fn: NodeDistFn,
    links_fn: LinksFn,
    max_iters: int,
) -> Array:
    """Batched greedy descent on one level: hill-climb to a local minimum.

    The batched reformulation of `greedy_search_on_level_fn`
    (reference: hnsw_index.rs:306-330).  entry: (B,) -> (B,) improved ids.
    """
    B = entry.shape[0]
    cur_d = node_dist_fn(entry[:, None])[:, 0]

    def cond(state):
        cur, cur_d, moved, it = state
        return (it < max_iters) & jnp.any(moved)

    def body(state):
        cur, cur_d, moved, it = state
        nbrs = links_fn(cur[:, None])[:, 0, :]  # (B, L)
        # a query that did not move last step cannot improve (same node,
        # same neighbors): blank its ids
        nbrs = jnp.where(moved[:, None], nbrs, -1)
        valid = nbrs >= 0
        nd = node_dist_fn(nbrs)
        nd = jnp.where(valid, nd, jnp.inf)
        best_pos = jnp.argmin(nd, axis=1)
        best_d = jnp.take_along_axis(nd, best_pos[:, None], axis=1)[:, 0]
        best_i = jnp.take_along_axis(nbrs, best_pos[:, None], axis=1)[:, 0]
        improve = best_d < cur_d
        cur = jnp.where(improve, best_i, cur)
        cur_d = jnp.where(improve, best_d, cur_d)
        return cur, cur_d, improve, it + 1

    cur, _, _, _ = jax.lax.while_loop(
        cond, body, (entry, cur_d, jnp.ones((B,), bool), jnp.int32(0))
    )
    return cur
