"""HNSW index: batched beam-search traversal + freeze-and-patch bulk build.

Parity target: `HNSWIndex` (reference: src/index_algorithm/hnsw_index.rs).

Device re-design:
- Graph storage is already dense in the reference (flat u32 link arrays,
  hnsw_index.rs:112-124); here level-0 links are a device-resident
  `(cap, max_m0)` int32 matrix (-1 padded) and each upper level is a compact
  `(n_l_cap, M)` matrix plus a `(cap,)` id->row map, so neighbor expansion is
  a single gather.
- Search: the sequential best-first loop (hnsw_index.rs:258-291) becomes
  batched lock-step beam search (`ops/beam.py`); greedy descent through the
  upper levels (hnsw_index.rs:306-350) is a batched hill-climb.
- Build: keeps the reference's freeze-and-patch chunk scheme
  (`add_parallel`, hnsw_index.rs:399-457): a chunk of new nodes searches the
  frozen pre-chunk graph (on device, all nodes at once), is patched with
  intra-chunk brute-force distances (one GEMM), then links are committed with
  the batched heuristic kernels (`ops/graph.py`) — the reference's serial
  link commit (hnsw_index.rs:443-447) becomes two batched scatter updates.
- Config derivation matches hnsw_index.rs:495-537: max_m0 = 2*M,
  ef_construction >= max_m0, default_ef = ef_construction/2,
  level ~ floor(-ln(U) * 1/ln(M)) (hnsw_index.rs:144-147).

Known divergence (documented): the candidate list fed to the neighbor
heuristic is truncated to the top `HEURISTIC_CAND` (default 64) of the
ef_construction beam; the reference walks the full list
(candidate_pair.rs:85-99) but with M=16 selection virtually never reaches
past the first few dozen sorted candidates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .store import VecStore, _round_cap
from .pq_table import PQTable
from ..ops import backend
from ..ops import distance as D
from ..ops import beam as BM
from ..ops import graph as G
from ..ops import topk as T
from ..utils.config import HNSWConfig
from ..utils import serde
from ..utils.candidates import CandidatePair, pairs_from_arrays

HEURISTIC_CAND = 64
BEAM_EXPAND = 4  # beam entries expanded per lock-step iteration (search)

# Quantized-search planner crossover: the literal ADC routes (full ADC
# scan + exact rerank, cost ~linear in N; ADC graph traversal, cost ~flat in
# N) trade places somewhere in the millions of rows.  The planner only
# takes them where no int8 mirror is resident (see plan_pq_route); the
# crossover value awaits measurement on the card.
PQ_SCAN_CROSSOVER = 5_000_000


def plan_pq_route(accelerated: bool, scannable: bool, n: int) -> str:
    """The knn_pq physical-plan choice (see knn_pq_batch's docstring).

    mirror: the store's resident int8 scan mirror + exact rerank — a
    strictly better quantized representation than 4-bit ADC wherever it
    is resident; scan: full ADC scan + exact rerank; graph: the literal
    ADC beam traversal (hnsw_index.rs:672-697).  Without an accelerator
    the planner always takes graph, so the oracle tests exercise the
    reference algorithm."""
    if not accelerated:
        return "graph"
    if scannable:
        return "mirror"
    return "graph" if n > PQ_SCAN_CROSSOVER else "scan"

# set to a utils.profiling.Spans to instrument bulk build (adds device syncs)
BUILD_SPANS = None
CHUNK_LADDER = (1, 4, 16, 64, 256, 1024, 4096)
BULK_LINKS_MIN = 4096  # batch size from which level-0 links go device-canonical
START_BATCH_SINCE = 1000  # hnsw_index.rs:506


def _pad_ladder(n: int) -> int:
    for c in CHUNK_LADDER:
        if n <= c:
            return c
    return CHUNK_LADDER[-1]


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# --------------------------------------------------------------------------
# jitted kernels
# --------------------------------------------------------------------------


def _make_node_dist(q, q_cache, vecs, vcache, dist):
    # Traversal distances may run on a bf16 vector copy (gather-bound:
    # half-width rows halve the bytes moved); the f32 norm caches and
    # f32 accumulation keep the error ~1e-2 relative, fine for ordering.
    # Final results are reranked exactly by the callers.
    qt = q.astype(vecs.dtype)

    def nd(ids):  # (B, C) -> (B, C)
        v = vecs[ids]
        dots = jnp.einsum("bd,bcd->bc", qt, v, preferred_element_type=jnp.float32, precision=D.PRECISION)
        vc = vcache[ids]
        if dist == "l2sqr":
            return jnp.maximum(q_cache[:, None] + vc - 2.0 * dots, 0.0)
        return 1.0 - dots / jnp.maximum(q_cache[:, None] * vc, 1e-10)

    return nd


@partial(jax.jit, static_argnames=("ef", "iters", "expand", "ring", "dist",
                                   "with_stats"))
def _beam0(q, q_cache, vecs, vcache, links0, entry, ef, iters, expand, ring,
           dist, with_stats=False):
    nd = _make_node_dist(q, q_cache, vecs, vcache, dist)
    lf = lambda ids: links0[ids]
    return BM.beam_search(entry, nd, lf, ef, iters, expand, ring,
                          with_stats=with_stats)


@partial(jax.jit, static_argnames=("iters", "dist"))
def _greedy_upper(q, q_cache, vecs, vcache, links_l, pos_l, entry, iters, dist):
    nd = _make_node_dist(q, q_cache, vecs, vcache, dist)

    def lf(ids):
        rows = pos_l[ids]
        out = links_l[jnp.maximum(rows, 0)]
        return jnp.where((rows >= 0)[..., None], out, -1)

    return BM.greedy_descent(entry, nd, lf, iters)


def _make_adc_node_dist(lookup, q_norms, codes, cb_sq, dist, m, m_codes):
    """ADC node-distance closure for the PQ traversal: gather the
    candidates' code rows, unpack nibbles, accumulate LUT entries."""
    from ..ops import pq as P

    def nd(ids):
        c = codes[jnp.maximum(ids, 0)]
        if m_codes is not None:  # nibble-packed device codes
            c = P.unpack_codes_4bit_dev(c, m_codes)
        d = P.adc_lookup_codes(c, lookup, cb_sq, dist, q_norms)
        return jnp.where(ids >= 0, d, jnp.inf)

    return nd


@partial(jax.jit, static_argnames=("ef", "iters", "expand", "dist", "m", "m_codes"))
def _beam0_pq(lookup, q_norms, codes, cb_sq, links0, entry, ef, iters, expand, dist, m, m_codes=None):
    nd = _make_adc_node_dist(lookup, q_norms, codes, cb_sq, dist, m, m_codes)
    lf = lambda ids: links0[ids]
    return BM.beam_search(entry, nd, lf, ef, iters, expand)


@partial(jax.jit, static_argnames=("iters", "dist", "m", "m_codes"))
def _greedy_upper_pq(lookup, q_norms, codes, cb_sq, links_l, pos_l, entry, iters, dist, m, m_codes=None):
    nd = _make_adc_node_dist(lookup, q_norms, codes, cb_sq, dist, m, m_codes)

    def lf(ids):
        rows = pos_l[ids]
        out = links_l[jnp.maximum(rows, 0)]
        return jnp.where((rows >= 0)[..., None], out, -1)

    return BM.greedy_descent(entry, nd, lf, iters)


@partial(jax.jit, static_argnames=("limit", "dist", "n_cand"))
def _select_links(
    vecs,
    vcache,  # (cap,) f32 per-row dist cache
    chunk_vec,  # (c, dim) chunk vectors (f32)
    chunk_cache,  # (c,)
    beam_d,  # (c, ef) — candidate-pool scores (scan or beam)
    beam_i,  # (c, ef)
    pids,  # (c,) chunk member ids
    plevels,  # (c,) chunk member levels (-1 for padding rows)
    level,  # () traced level being linked
    peer_d,  # (c, c) chunk pairwise distances
    limit: int,
    dist: str,
    n_cand: int,
):
    """Merge frozen-graph candidates with intra-chunk peers, sort, and
    run the neighbor-selection heuristic.  Returns (c, limit) selected ids.

    This is the patch step of add_parallel (hnsw_index.rs:427-438) fused with
    connect_new_links's forward selection (hnsw_index.rs:226-235).

    The pool distances may be approximate (bf16/int8 selection); distances
    inside the pool are recomputed exactly in f32 before the selection
    heuristic, so link quality does not depend on selection precision.
    """
    c = pids.shape[0]
    # peer mask on device: j earlier than i in chunk order, level_j >= level
    order = jax.lax.broadcasted_iota(jnp.int32, (c, c), 1)
    earlier = order < jax.lax.broadcasted_iota(jnp.int32, (c, c), 0)
    need = plevels >= level
    peer_mask = earlier & (plevels[None, :] >= level) & need[:, None]
    peer_ids = jnp.broadcast_to(pids[None, :], (c, c))
    pd = jnp.where(peer_mask, peer_d, jnp.inf)
    pi = jnp.where(peer_mask, peer_ids, -1)
    all_d = jnp.concatenate([beam_d, pd], axis=1)
    all_i = jnp.concatenate([beam_i, pi], axis=1)
    # dedup (a peer may also appear in the beam since the chunk is pushed
    # into the graph arrays before searching; keep the earliest copy)
    Ctot = all_i.shape[1]
    eq = all_i[:, :, None] == all_i[:, None, :]
    tri = jnp.tril(jnp.ones((Ctot, Ctot), bool), k=-1)
    dup = jnp.any(eq & tri[None], axis=2) & (all_i >= 0)
    all_d = jnp.where(dup, jnp.inf, all_d)
    all_i = jnp.where(dup, -1, all_i)

    sd, pos = jax.lax.top_k(-all_d, n_cand)
    cand_i = jnp.take_along_axis(all_i, pos, axis=1)
    cand_i = jnp.where(jnp.isfinite(-sd), cand_i, -1)

    # exact f32 node->candidate distances, then re-sort ascending
    safe = jnp.maximum(cand_i, 0)
    v = vecs[safe].astype(jnp.float32)  # (c, n_cand, dim)
    dots = jnp.einsum(
        "bd,bcd->bc", chunk_vec.astype(jnp.float32), v,
        preferred_element_type=jnp.float32, precision=D.PRECISION,
    )
    vc = vcache[safe]
    if dist == "l2sqr":
        cand_d = jnp.maximum(chunk_cache[:, None] + vc - 2.0 * dots, 0.0)
    else:
        cand_d = 1.0 - dots / jnp.maximum(chunk_cache[:, None] * vc, 1e-10)
    cand_d = jnp.where(cand_i >= 0, cand_d, jnp.inf)
    cand_i, cand_d = G.sort_candidates(cand_i, cand_d)

    pair = G.pairwise_among(vecs, cand_i, dist)
    sel, _ = G.heuristic_select(cand_i, cand_d, pair, limit)
    return sel


@partial(jax.jit, static_argnames=("k", "dist"))
def _member_knn(q, q_cache, vecs, vcache, mem_ids, n_mem, k, dist):
    """Exact kNN of the chunk against an upper level's member subset.

    mem_ids: (n_pad,) int32 member node ids (-1 padded); n_mem: () traced
    count.  Returns ((c, k) f32 dists ascending, (c, k) int32 node ids).
    Upper levels hold ~n/M^l nodes, so gather + one GEMM beats any graph
    traversal on this hardware.
    """
    mv = vecs[jnp.maximum(mem_ids, 0)].astype(jnp.float32)  # (n_pad, dim)
    mc = vcache[jnp.maximum(mem_ids, 0)]
    dots = jnp.einsum(
        "bd,nd->bn", q.astype(jnp.float32), mv,
        preferred_element_type=jnp.float32, precision=D.PRECISION,
    )
    if dist == "l2sqr":
        d = jnp.maximum(q_cache[:, None] + mc[None, :] - 2.0 * dots, 0.0)
    else:
        d = 1.0 - dots / jnp.maximum(q_cache[:, None] * mc[None, :], 1e-10)
    col = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
    d = jnp.where((col < n_mem) & (mem_ids[None, :] >= 0), d, jnp.inf)
    kk = min(k, d.shape[1])
    nd, pos = jax.lax.top_k(-d, kk)
    bi = mem_ids[pos]  # (c, kk) gather of node ids by column position
    bd = -nd
    if kk < k:
        bd = jnp.pad(bd, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
        bi = jnp.pad(bi, ((0, 0), (0, k - kk)), constant_values=-1)
    return bd, jnp.where(jnp.isfinite(bd), bi, -1)


# --------------------------------------------------------------------------


class _UpperLevel:
    """Compact link storage for one level >= 1."""

    def __init__(self, m: int, cap_total: int, init_cap: int = 16):
        self.m = m
        self.n = 0
        self.cap = max(16, _pow2(init_cap))
        self.ids = np.full(self.cap, -1, np.int32)
        self.links = np.full((self.cap, m), -1, np.int32)
        self.pos = np.full(cap_total, -1, np.int32)
        self._dev_links = None
        self._dev_pos = None
        self.dirty = True

    def ensure_member(self, node: int) -> int:
        if self.pos[node] >= 0:
            return int(self.pos[node])
        if self.n == self.cap:
            self.cap *= 2
            new_ids = np.full(self.cap, -1, np.int32)
            new_ids[: self.n] = self.ids[: self.n]
            self.ids = new_ids
            new_links = np.full((self.cap, self.m), -1, np.int32)
            new_links[: self.n] = self.links[: self.n]
            self.links = new_links
        row = self.n
        self.ids[row] = node
        self.pos[node] = row
        self.n += 1
        self.dirty = True
        return row

    def grow_total(self, cap_total: int) -> None:
        if cap_total > len(self.pos):
            new_pos = np.full(cap_total, -1, np.int32)
            new_pos[: len(self.pos)] = self.pos
            self.pos = new_pos
            self.dirty = True

    def device(self):
        if self.dirty or self._dev_links is None:
            self._dev_links = jnp.asarray(self.links)
            self._dev_pos = jnp.asarray(self.pos)
            self.dirty = False
        return self._dev_links, self._dev_pos


@dataclass
class _InnerConfig:
    """Computed config (hnsw_index.rs:74-96)."""

    dim: int
    dist: str
    m: int
    max_m0: int
    ef_construction: int
    default_ef: int
    inv_log_m: float


class HNSWIndex:
    algorithm = "HNSW"

    def __init__(self, dim: int, dist: str, config: HNSWConfig | None = None, seed: int | None = None):
        config = config or HNSWConfig()
        m = min(config.M, 10_000)
        max_m0 = m * 2
        efc = max(config.ef_construction, max_m0)
        self.config = _InnerConfig(
            dim=dim,
            dist=dist,
            m=m,
            max_m0=max_m0,
            ef_construction=efc,
            default_ef=efc // 2,
            inv_log_m=1.0 / math.log(m),
        )
        self.store = VecStore(dim, dist, capacity=max(config.max_elements, 8))
        cap = self.store.capacity
        self.levels = np.zeros(cap, np.int32)
        self.links0 = np.full((cap, max_m0), -1, np.int32)
        self.upper: list[_UpperLevel] = []  # index l-1 => level l
        self.entry_point: int | None = None
        self.enter_level: int | None = None
        self.rng = np.random.default_rng(seed)
        self._dev_links0: jax.Array | None = None
        self._links0_dirty_rows: set[int] = set()
        self._links0_full_dirty = True
        # bulk-build mode: the DEVICE links matrix is canonical and the host
        # copy is stale until _exit_links_bulk downloads it once (see
        # _apply_reverse — per-round host round-trips of link rows are
        # avoided)
        self._links0_canonical_dev = False

    # ---- basic accessors ----
    @property
    def dim(self) -> int:
        return self.config.dim

    @property
    def dist(self) -> str:
        return self.config.dist

    def __len__(self) -> int:
        return len(self.store)

    def set_default_ef(self, ef: int) -> None:
        assert ef > 0
        self.config.default_ef = ef

    # ---- capacity management ----
    def _grow(self, n_needed: int) -> None:
        if self._links0_canonical_dev and n_needed > self.store.capacity:
            # capacity change reallocates the links matrix: fold the
            # device-canonical copy back first (rare — bulk builds pre-size)
            self._exit_links_bulk()
            self._grow(n_needed)
            self._enter_links_bulk()
            return
        self.store._grow_to(n_needed)
        cap = self.store.capacity
        if cap > len(self.levels):
            new_levels = np.zeros(cap, np.int32)
            new_levels[: len(self.levels)] = self.levels
            self.levels = new_levels
            new_links = np.full((cap, self.config.max_m0), -1, np.int32)
            new_links[: self.links0.shape[0]] = self.links0
            self.links0 = new_links
            for ul in self.upper:
                ul.grow_total(cap)
            self._dev_links0 = None
            self._links0_full_dirty = True
            self._links0_dirty_rows.clear()

    def index_bytes(self) -> int:
        """Device-memory footprint: store arrays + graph topology (links0 +
        upper levels) — the sweep rows' "index memory" record."""
        total = self.store.device_bytes()
        if self._dev_links0 is not None:
            total += int(self._dev_links0.nbytes)
        for ul in self.upper:
            for a in (ul._dev_links, ul._dev_pos):
                if a is not None:
                    total += int(a.nbytes)
        return total

    def _enter_links_bulk(self) -> None:
        """Make the device links matrix canonical for a bulk insert."""
        if self._links0_canonical_dev:
            return
        self._links0_device()  # sync any host dirt into the device copy
        self._links0_canonical_dev = True

    def _exit_links_bulk(self) -> None:
        """Download the device-canonical links back to the host (once)."""
        if not self._links0_canonical_dev:
            return
        self.links0 = np.asarray(self._dev_links0)
        self._links0_canonical_dev = False
        self._links0_full_dirty = False
        self._links0_dirty_rows.clear()

    def _links0_device(self) -> jax.Array:
        if self._links0_canonical_dev:
            return self._dev_links0
        if self._dev_links0 is None or self._links0_full_dirty:
            self._dev_links0 = jnp.asarray(self.links0)
            self._links0_full_dirty = False
            self._links0_dirty_rows.clear()
        elif self._links0_dirty_rows:
            rows = np.fromiter(self._links0_dirty_rows, dtype=np.int64)
            self._dev_links0 = self._dev_links0.at[jnp.asarray(rows)].set(
                jnp.asarray(self.links0[rows])
            )
            self._links0_dirty_rows.clear()
        return self._dev_links0

    def _write_links0(self, rows: np.ndarray, values: np.ndarray) -> None:
        if self._links0_canonical_dev:
            # device is canonical: scatter there, leave the host copy stale
            self._dev_links0 = self._dev_links0.at[jnp.asarray(rows)].set(
                jnp.asarray(values)
            )
            return
        self.links0[rows] = values
        if self._links0_full_dirty:
            return
        self._links0_dirty_rows.update(int(r) for r in rows)
        if len(self._links0_dirty_rows) > max(2048, self.links0.shape[0] // 8):
            self._links0_full_dirty = True
            self._links0_dirty_rows.clear()

    def _rand_level(self) -> int:
        u = self.rng.random()
        u = max(u, 1e-12)
        return int(math.floor(-math.log(u) * self.config.inv_log_m))

    # ---- build ----
    def add(self, vec) -> int:
        return self.batch_add(np.asarray(vec, dtype=np.float32)[None, :])[0]

    def batch_add(self, vecs, progress=None) -> list[int]:
        """Chunked freeze-and-patch insert (hnsw_index.rs:459-475).

        Chunk size follows the reference's rule `min(batch, n/M)`
        (hnsw_index.rs:391-397) with the device batch ladder replacing
        `4*num_threads`.
        """
        vecs = np.atleast_2d(np.asarray(vecs, dtype=np.float32))
        n_new = len(vecs)
        out: list[int] = []
        cur = 0
        # bulk inserts flip the level-0 links matrix to device-canonical:
        # reverse-arrange rounds then gather/scatter link rows entirely on
        # device instead of round-tripping them through the host per round
        bulk = n_new >= BULK_LINKS_MIN
        if bulk:
            self._grow(len(self.store) + n_new)  # pre-size: no mid-bulk realloc
            self._enter_links_bulk()
        try:
            while cur < n_new:
                n_now = len(self.store)
                # Chunk growth: floor 256, matched to graph size, capped at
                # the device batch ladder.  The reference grows chunks as n/M
                # to protect insertion quality (hnsw_index.rs:391-397), but
                # here the intra-chunk patch uses *exact* pairwise distances
                # (_select_links), so a chunk as large as the current graph
                # still selects near-exact links — and for
                # n <= ef_construction the frozen-graph beam is exhaustive
                # anyway.  The floor removes the ~hundred tiny warmup chunks
                # whose per-dispatch overhead dominated bulk build.
                size = min(max(n_now, 256), CHUNK_LADDER[-1])
                size = min(size, n_new - cur)
                self._insert_chunk(vecs[cur : cur + size])
                cur += size
                out.extend(range(n_now, n_now + size))
                if progress is not None:
                    progress(cur, n_new)
        finally:
            if bulk:
                self._exit_links_bulk()
        return out

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        dist: str,
        config: HNSWConfig | None = None,
        seed: int | None = None,
        progress=None,
    ) -> "HNSWIndex":
        """Bulk build (hnsw_index.rs:595-611)."""
        config = config or HNSWConfig()
        if config.max_elements == 0:
            config = HNSWConfig(
                max_elements=len(vectors), ef_construction=config.ef_construction, M=config.M
            )
        index = cls(vectors.shape[1], dist, config, seed)
        index.batch_add(vectors, progress=progress)
        return index

    @classmethod
    def build_from_store(
        cls,
        store: VecStore,
        config: HNSWConfig | None = None,
        seed: int | None = None,
        progress=None,
    ) -> "HNSWIndex":
        """Bulk build over a pre-filled store (e.g. `VecStore.from_device`):
        ZERO vector bytes cross the host boundary.

        The insert machinery is already prefix-bounded (candidate scans and
        id decoding cut at `n_prev = ids.min()`, `_insert_ids`), so graph
        construction over rows that are all resident up front is the same
        algorithm as `build` minus the host push: rows [0, n) join the graph
        in the usual chunk ladder, each chunk searching only the frozen
        prefix below it.  With device-born data (bench.make_dataset_device)
        this makes the entire 1M build run without uploading or downloading
        the base — the device-resident form of build_on_vec_set
        (hnsw_index.rs:595-611)."""
        n = len(store)
        config = config or HNSWConfig()
        index = cls(store.dim, store.dist, config, seed)
        index.store = store
        cap = store.capacity
        index.levels = np.zeros(cap, np.int32)
        index.links0 = np.full((cap, index.config.max_m0), -1, np.int32)
        index._dev_links0 = None
        index._links0_full_dirty = True
        if n == 0:
            return index
        bulk = n >= BULK_LINKS_MIN
        if bulk:
            index._enter_links_bulk()
        try:
            cur = 0
            while cur < n:
                size = min(max(cur, 256), CHUNK_LADDER[-1], n - cur)
                index._insert_prefilled(cur, cur + size)
                cur += size
                if progress is not None:
                    progress(cur, n)
        finally:
            if bulk:
                index._exit_links_bulk()
        return index

    def _insert_prefilled(self, lo: int, hi: int) -> None:
        """Insert rows [lo, hi) that are ALREADY in the store (no push)."""
        ids = np.arange(lo, hi, dtype=np.int32)
        levels = np.array([self._rand_level() for _ in ids], dtype=np.int32)
        self.levels[ids] = levels
        for i, lv in zip(ids, levels):
            for l in range(1, lv + 1):
                self._upper(l).ensure_member(int(i))
        if self.entry_point is None:
            self.entry_point = int(ids[0])
            self.enter_level = int(levels[0])
            if len(ids) == 1:
                return
            self._insert_ids(ids[1:], levels[1:])
            return
        self._insert_ids(ids, levels)

    def _insert_chunk(self, vecs: np.ndarray) -> None:
        c = len(vecs)
        cfg = self.config
        n_before = len(self.store)
        self._grow(n_before + c)
        ids = np.array(self.store.batch_push(vecs), dtype=np.int32)
        levels = np.array([self._rand_level() for _ in range(c)], dtype=np.int32)
        self.levels[ids] = levels
        for i, lv in zip(ids, levels):
            for l in range(1, lv + 1):
                self._upper(l).ensure_member(int(i))

        if self.entry_point is None:
            # first vector initializes the entry point (hnsw_index.rs:542-551)
            self.entry_point = int(ids[0])
            self.enter_level = int(levels[0])
            if c == 1:
                return
            # insert the rest normally against the 1-node graph
            rest = np.arange(1, c)
            self._insert_ids(ids[rest], levels[rest])
            return
        self._insert_ids(ids, levels)

    def _upper(self, level: int) -> _UpperLevel:
        while len(self.upper) < level:
            # pre-size to ~2x the expected occupancy E[n at level l] = n/M^l
            # so device link arrays compile once instead of riding a growth
            # ladder of shapes during bulk build
            lvl = len(self.upper) + 1
            expect = self.store.capacity // max(self.config.m**lvl, 1)
            ul = _UpperLevel(self.config.m, self.store.capacity, init_cap=2 * expect)
            self.upper.append(ul)
        return self.upper[level - 1]

    def _insert_ids(self, ids: np.ndarray, levels: np.ndarray) -> None:
        """Scan-based chunk insert.

        The reference finds insertion candidates by beam-searching the frozen
        graph (add_parallel, hnsw_index.rs:399-457) because CPU brute force
        is unaffordable.  On a device the inversion holds: an exact
        two-stage GEMM scan of the frozen prefix produces *exact* ef_construction-NN
        candidate pools faster than any traversal (and with better link
        quality), so bulk build never touches the graph it is building —
        level 0 candidates come from the int8/bf16 candidate scan + exact
        rerank, upper-level candidates from an exact member-subset GEMM.
        All intermediates stay on device; only the selected links (c x m
        int32) ever cross the host boundary.
        """
        c = len(ids)
        c_pad = _pad_ladder(c)
        entry_point = self.entry_point
        n_prev = int(ids.min())  # ids are appended: rows [0, n_prev) are the
        # frozen prefix the chunk searches against

        # keep the in-flight chunk OUT of the int8 scan mirror: otherwise
        # same-chunk rows (nearest of all for cluster-sorted ingests) win
        # survivor groups and dilute the frozen-prefix candidate pool before
        # the decode_perm(n_prev) filter can act
        self.store.set_scan_bound(n_prev)
        try:
            self._insert_ids_inner(ids, levels, n_prev, c, c_pad, entry_point)
        finally:
            # values were synced by the push's own dirty marks (or are
            # device-born); validity is bound-dynamic — nothing to re-mark
            self.store.set_scan_bound(None)

    def _insert_ids_inner(self, ids, levels, n_prev, c, c_pad, entry_point):
        import contextlib
        import jax

        cfg = self.config
        spans = BUILD_SPANS

        def _sync(x):
            if spans is not None:
                jax.block_until_ready(x)
            return x

        def _span(name):
            return spans.span(name) if spans is not None else contextlib.nullcontext()

        vecs, vcache = self.store.device()

        # padded chunk (dummy rows replicate the entry point, results ignored)
        pids = np.full(c_pad, entry_point, np.int32)
        pids[:c] = ids
        plevels = np.full(c_pad, -1, np.int32)
        plevels[:c] = levels
        pids_dev = jnp.asarray(pids)
        plevels_dev = jnp.asarray(plevels)

        q = vecs[pids_dev]
        q_cache = vcache[pids_dev]

        efc = cfg.ef_construction
        _scan_span = _span("scan-pool")
        _scan_span.__enter__()

        # level-0 candidate pool: exact-grade two-stage scan of the prefix
        from ..ops import distance as D

        r = min(efc, self.store.capacity)
        if backend.accelerated() and n_prev > 4 * r and self.store.int8_reliable():
            base_i8, scales, cache8, perm8 = self.store.device_int8()
            # stage-1 int8 scan through the platform's kernel.  Its
            # 1-per-128-row chunk-min survivor cap is harmless here: chunk
            # members are new rows whose prefix neighbors are scattered by
            # the mirror's permutation.
            bd0, bi0 = backend.scan_candidates_int8(
                q, base_i8, scales, cache8, r, cfg.dist
            )
            # decode permuted-mirror ids; keep only the frozen prefix
            # (mirror validity covers [0, n_now) which includes this very
            # chunk — same-chunk hits are handled exactly as peers)
            bi0 = T.decode_perm(bi0, perm8, jnp.int32(n_prev))
            bd0 = jnp.where(bi0 >= 0, bd0, jnp.inf)
            # no exact rerank here: the pool only needs approximate ORDER —
            # _select_links recomputes exact f32 distances for the top
            # HEURISTIC_CAND candidates before the selection heuristic, so
            # link quality is unaffected
        else:
            bd0, bi0 = T.knn_scan(q, vecs, vcache, jnp.int32(n_prev), r, cfg.dist)
        _sync(bd0)
        _scan_span.__exit__(None, None, None)
        cand_by_level: dict[int, tuple[jax.Array, jax.Array]] = {0: (bd0, bi0)}

        # upper-level pools: exact kNN among that level's (frozen) members
        for level in range(1, int(levels.max()) + 1 if c else 1):
            if not (plevels >= level).any():
                continue
            ul = self._upper(level)
            mem = ul.ids[: ul.n]
            mem = mem[(mem >= 0) & (mem < n_prev)]
            if len(mem) == 0:
                continue
            n_pad = _pow2(len(mem))
            mem_p = np.full(n_pad, -1, np.int32)
            mem_p[: len(mem)] = mem
            k_l = min(efc, n_pad)
            bd, bi = _member_knn(
                q, q_cache, vecs, vcache, jnp.asarray(mem_p),
                jnp.int32(len(mem)), k_l, cfg.dist,
            )
            cand_by_level[level] = (bd, bi)

        # intra-chunk patch distances (hnsw_index.rs:430-437)
        chunk_vec = q
        with _span("peer-dist"):
            peer_d = _sync(D.pairwise(chunk_vec, chunk_vec, cfg.dist))

        for level in sorted(cand_by_level.keys(), reverse=True):
            bd, bi = cand_by_level[level]
            need = plevels >= level
            if not need.any():
                continue
            with _span("select-links"):
                sel = _select_links(
                    vecs,
                    vcache,
                    chunk_vec,
                    q_cache,
                    bd,
                    bi,
                    pids_dev,
                    plevels_dev,
                    jnp.int32(level),
                    peer_d,
                    cfg.m,
                    cfg.dist,
                    min(HEURISTIC_CAND, bd.shape[1] + c_pad),
                )
                sel = np.asarray(sel)  # (c_pad, m) — the only per-level download

            limit = cfg.max_m0 if level == 0 else cfg.m
            # forward links (initially limited to m even at level 0,
            # hnsw_index.rs:230-233) — vectorized row compaction + sorted
            # grouping replace the per-row python loop (was ~10% of bulk
            # build wall time at chunk 4096)
            _host_span = _span("host-links")
            _host_span.__enter__()
            rows_idx = np.nonzero(need[:c])[0]
            rev_edges: dict[int, list[int]] = {}
            if len(rows_idx):
                S = sel[rows_idx].astype(np.int32)  # (R, w)
                nodes = ids[rows_idx].astype(np.int32)
                # guard: drop invalid and self (dummy padding could inject it)
                valid = (S >= 0) & (S != nodes[:, None])
                # compact each row: valid entries first, original order kept
                order = np.argsort(~valid, axis=1, kind="stable")
                Sc = np.take_along_axis(S, order, axis=1)
                vc = np.take_along_axis(valid, order, axis=1)
                Sc = np.where(vc, Sc, -1)
                if level == 0:
                    w = Sc.shape[1]
                    padded = np.full((len(rows_idx), cfg.max_m0), -1, np.int32)
                    padded[:, : min(w, cfg.max_m0)] = Sc[:, : cfg.max_m0]
                    self._write_links0(nodes, padded)
                else:
                    ul = self._upper(level)
                    ww = min(Sc.shape[1], cfg.m)
                    for i, node in enumerate(nodes):
                        rrow = ul.ensure_member(int(node))
                        ul.links[rrow] = -1
                        ul.links[rrow, :ww] = Sc[i, :ww]
                    ul.dirty = True
                # reverse edges grouped by pivot: stable sort keeps each
                # pivot's adds in ascending chunk-row order (same lists the
                # old setdefault loop produced)
                pv = S[valid]
                nd = np.repeat(nodes, valid.sum(1))
                o2 = np.argsort(pv, kind="stable")
                pv_s, nd_s = pv[o2], nd[o2]
                if len(pv_s):
                    splits = np.nonzero(np.diff(pv_s))[0] + 1
                    starts = np.concatenate(([0], splits))
                    bounds = np.append(starts, len(pv_s))
                    keys = pv_s[starts]
                    rev_edges = {
                        int(k): nd_s[bounds[i] : bounds[i + 1]].tolist()
                        for i, k in enumerate(keys)
                    }
            _host_span.__exit__(None, None, None)

            # reverse links: batched arrange (hnsw_index.rs:204-239)
            if rev_edges:
                with _span("reverse-arrange"):
                    self._apply_reverse(level, rev_edges, limit)

        # entry point update (hnsw_index.rs:448-455)
        for r in range(c):
            if int(levels[r]) > self.enter_level:
                self.enter_level = int(levels[r])
                self.entry_point = int(ids[r])

    _REV_ADD_CAP = 64  # max new candidates folded into one arrange round
    _REV_PIVOT_CAP = 4096  # max pivots per arrange call (bounds device transients)

    def _apply_reverse(self, level: int, rev_edges: dict[int, list[int]], limit: int) -> None:
        """Batched reverse-link arrangement; large add-lists are split into
        rounds of at most _REV_ADD_CAP to bound compile variants and to stay
        close to the reference's incremental arrange semantics."""
        cfg = self.config
        pending = {p: list(v) for p, v in rev_edges.items()}
        ul = self._upper(level) if level > 0 else None
        vecs, _ = self.store.device()

        if level == 0 and self._links0_canonical_dev:
            # Device-canonical links: each round gathers its pivot rows from
            # the device matrix, arranges, and scatters back — link rows
            # never cross the host boundary, and dependent rounds (a pivot
            # whose add-list overflows _REV_ADD_CAP) chain correctly because
            # every arrange reads the previous arrange's output.  Only the
            # small (piv, new_ids) int32 blocks upload per round.
            links_dev = self._dev_links0
            cap = links_dev.shape[0]
            # rounds slice pivots in ascending add-count order so each
            # round's A_pad stays tight (one 64-add outlier would otherwise
            # widen the whole round's upload 16x)
            order = sorted(pending.keys(), key=lambda p: len(pending[p]))
            while pending:
                round_edges = {}
                for p in order:
                    if p not in pending:
                        continue
                    adds = pending[p]
                    round_edges[p] = adds[: self._REV_ADD_CAP]
                    rest = adds[self._REV_ADD_CAP :]
                    if rest:
                        pending[p] = rest
                    else:
                        del pending[p]
                    if len(round_edges) >= self._REV_PIVOT_CAP:
                        break
                pivots = sorted(round_edges.keys())
                P = len(pivots)
                A = max(len(v) for v in round_edges.values())
                A_pad = _pow2(A)
                P_pad = _pow2(P)
                # ONE packed upload per round: column 0 = pivot id, rest =
                # new candidate ids.  Dummy pivots use an OUT-OF-RANGE id:
                # gather clips, scatter drops — a duplicated real id would
                # race its own update.
                piv_new = np.full((P_pad, 1 + A_pad), -1, np.int32)
                piv_new[:, 0] = cap
                for idx, p in enumerate(pivots):
                    piv_new[idx, 0] = p
                    adds = round_edges[p]
                    piv_new[idx, 1 : 1 + len(adds)] = adds
                links_dev = G.arrange_links_inplace(
                    vecs, links_dev, jnp.asarray(piv_new), cfg.dist, cfg.max_m0,
                )
                # keep the canonical reference current every round: the old
                # buffer was donated and must never be read again
                self._dev_links0 = links_dev
            return

        # Two-phase pipeline: dispatch EVERY round's device arrange first
        # (they are independent — each pivot appears in exactly one round
        # unless its add-list overflows _REV_ADD_CAP, in which case its
        # later round must see the earlier round's output, handled below by
        # flushing between dependent rounds), then download the results, so
        # device compute overlaps the serial downloads.
        rounds = []  # (pivots, device new_rows)
        dispatched: set[int] = set()  # pivots with un-flushed in-flight results

        def flush():
            for pivots, out in rounds:
                new_rows = np.asarray(out)
                if level == 0:
                    self._write_links0(np.array(pivots), new_rows[: len(pivots)])
                else:
                    for idx, p in enumerate(pivots):
                        rrow = ul.ensure_member(p)
                        ul.links[rrow] = new_rows[idx]
                    ul.dirty = True
            rounds.clear()
            dispatched.clear()

        while pending:
            round_edges = {}
            for p in list(pending.keys()):
                adds = pending[p]
                round_edges[p] = adds[: self._REV_ADD_CAP]
                rest = adds[self._REV_ADD_CAP :]
                if rest:
                    pending[p] = rest
                else:
                    del pending[p]
                if len(round_edges) >= self._REV_PIVOT_CAP:
                    # bound the arrange batch: an unbounded pivot set (up to
                    # chunk*M at 1M scale) gathers multi-GB vector blocks and
                    # exhausts device memory next to the live mirrors
                    break

            if any(p in dispatched for p in round_edges):
                # this round re-touches a pivot whose previous round is
                # still in flight: commit outstanding results first so the
                # dependent round reads (and does not overwrite) them
                flush()

            pivots = sorted(round_edges.keys())
            P = len(pivots)
            A = max(len(v) for v in round_edges.values())
            A_pad = _pow2(A)
            P_pad = _pow2(P)

            new_ids = np.full((P_pad, A_pad), -1, np.int32)
            piv = np.zeros(P_pad, np.int32)
            width = cfg.max_m0 if level == 0 else cfg.m
            rows = np.full((P_pad, width), -1, np.int32)
            for idx, p in enumerate(pivots):
                piv[idx] = p
                adds = round_edges[p]
                new_ids[idx, : len(adds)] = adds
                if level == 0:
                    rows[idx] = self.links0[p]
                else:
                    rrow = ul.ensure_member(p)
                    rows[idx] = ul.links[rrow]
            # dummy rows: pivot with no adds keeps its links unchanged
            if P_pad > P:
                piv[P:] = pivots[0]
                rows[P:] = rows[0]

            out = G.arrange_links_batch(
                vecs,
                jnp.asarray(rows),
                jnp.asarray(piv),
                jnp.asarray(new_ids),
                cfg.dist,
                width,
            )
            rounds.append((pivots, out))
            dispatched.update(pivots)
        flush()

    # ---- search ----
    def _descend_to_level0(self, q, q_cache, vecs_t, vcache):
        B = q.shape[0]
        cur = jnp.full((B,), self.entry_point, jnp.int32)
        for level in range(self.enter_level, 0, -1):
            ul = self._upper(level)
            links_l, pos_l = ul.device()
            cur = _greedy_upper(q, q_cache, vecs_t, vcache, links_l, pos_l, cur, 256, self.dist)
        return cur

    def knn_with_ef_batch(
        self,
        queries: np.ndarray,
        k: int,
        ef: int,
        expand: int | None = None,
        iters: int | None = None,
        ring: int | None = None,
        route: str = "auto",
    ):
        """Batched kNN with the reference's contract (hnsw_index.rs:624-633):
        approximate top-k whose recall grows with `ef`, exact returned
        distances.  Two physical plans serve that contract:

        route="graph": the literal traversal — greedy descent to level 0 +
        one lock-step beam search (ops/beam.py) over the bf16 traversal
        copy, then an exact rerank of the beam.  Faithful to the reference
        algorithm.

        route="scan": int8 chunk-min scan keeping the best `ef` stage-1
        survivors, then the exact f32 rerank.  `ef` keeps its meaning
        (candidate-pool width -> recall knob).

        route="auto" (default): scan when an accelerator is present and the
        store supports it (full/lean tier with the randomly-permuted mirror
        layout); the graph everywhere else — CPU oracle tests and the native
        single-query engine always exercise the true traversal."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        B = queries.shape[0]
        if len(self.store) == 0 or self.entry_point is None:
            return (
                np.full((B, k), np.inf, np.float32),
                np.full((B, k), -1, np.int32),
            )
        ef = max(ef, k)
        if route not in ("auto", "graph", "scan"):
            raise ValueError(f"unknown route {route!r} (auto|graph|scan)")
        if route == "auto":
            scannable = getattr(self.store, "_mirror_layout", "scan") == "scan"
            route = "scan" if (backend.accelerated() and scannable) else "graph"
        if route == "scan":
            from .flat import FlatIndex

            fi = FlatIndex.from_store(self.store)
            d, i = fi._knn_device(jnp.asarray(queries), k, rerank_depth=ef)
            if self.store.tier == "lean":
                return self.store.refine_results(queries, d, i)
            return np.asarray(d), np.asarray(i)
        if expand is None:
            expand = BEAM_EXPAND
        if iters is None:
            # natural termination budget: expanding E per step, churn ~2x
            iters = (2 * ef + 64 + expand - 1) // expand + 16
        if ring is None:
            # the visited ring must hold every expansion or evicted-then-
            # re-found nodes get re-expanded (wasted iterations at best,
            # iteration-budget truncation at worst)
            ring = _pow2(min(2 * ef + 64, 4 * ef))
        q = jnp.asarray(queries)
        _, bi = self._graph_beam(q, ef, expand, iters, ring)
        d, i = T.exact_distances_sorted(q, self.store.device_rerank(), bi, self.dist)
        d, i = d[:, :k], i[:, :k]
        if self.store.tier == "lean":
            return self.store.refine_results(queries, d, i)
        return np.asarray(d), np.asarray(i)

    def _graph_beam(self, q, ef, expand, iters, ring, with_stats=False):
        """Upper-level greedy descent + the level-0 lock-step beam over the
        bf16 traversal copy: ((B, ef) approximate dists, ids)[, rows]."""
        vecs_t, vcache = self.store.device_traversal()
        q_cache = D.dist_cache(q, self.dist)
        cur = self._descend_to_level0(q, q_cache, vecs_t, vcache)
        return _beam0(q, q_cache, vecs_t, vcache, self._links0_device(), cur,
                      ef, iters, expand, ring, self.dist, with_stats=with_stats)

    def traversal_stats(self, queries: np.ndarray, k: int, ef: int,
                        expand: int | None = None):
        """Graph-route search that ALSO reports the novel rows scored per
        query (the beam's work measure).  Returns (dists (B,k), ids (B,k),
        rows_scored (B,) int32); the dists are the traversal copy's."""
        if expand is None:
            expand = BEAM_EXPAND
        iters = (2 * ef + 64 + expand - 1) // expand + 16
        ring = _pow2(min(2 * ef + 64, 4 * ef))
        q = jnp.asarray(np.atleast_2d(np.asarray(queries, np.float32)))
        bd, bi, rows = self._graph_beam(q, ef, expand, iters, ring, with_stats=True)
        return np.asarray(bd[:, :k]), np.asarray(bi[:, :k]), np.asarray(rows)

    def knn_batch(self, queries: np.ndarray, k: int):
        return self.knn_with_ef_batch(queries, k, self.config.default_ef)

    def knn(self, query, k: int) -> list[CandidatePair]:
        d, i = self.knn_batch(query, k)
        return pairs_from_arrays(d[0], i[0], k)

    def knn_with_ef(self, query, k: int, ef: int) -> list[CandidatePair]:
        # Single-query fast path through the native serial engine (same
        # dense link arrays; microsecond latency vs ~ms device dispatch).
        from . import native

        if len(self.store) > 0:
            res = native.hnsw_knn_single(self, np.asarray(query, np.float32), k, ef)
            if res is not None:
                ids, dists = res
                return [
                    CandidatePair(int(i_), float(d_)) for i_, d_ in zip(ids, dists)
                ]
        d, i = self.knn_with_ef_batch(queries=np.asarray(query, np.float32), k=k, ef=ef)
        return pairs_from_arrays(d[0], i[0], k)

    def knn_pq_batch(
        self,
        queries: np.ndarray,
        k: int,
        ef: int,
        pq: PQTable,
        expand: int | None = None,
        route: str = "auto",
    ):
        """HNSW traversal with ADC distances + exact rerank
        (hnsw_index.rs:672-697).

        route="graph": graph-guided ADC beam traversal (the reference's
        algorithm); frontier distances gather code rows and accumulate
        LUT entries (ops/pq.py).
        route="scan": full ADC scan + exact rerank (same results contract:
        ADC-ordered ef pool, exact top-k; cost nearly flat in ef, linear in
        N).

        route="mirror": the planner's pick when an accelerator is present —
        serve the quantized search from the store's resident int8 scan
        mirror (stage-1 chunk-min scan keeping ef survivors + exact
        rerank).  Wherever the mirror is resident (full tier: the f32
        canonical already dwarfs it; lean tier: it IS the storage) it is a
        strictly better quantized representation than 4-bit ADC, so "auto"
        uses it there.  The PQ sidecar keeps its reference roles (ADC
        forms, serde, the codes-only memory story); route="scan"/"graph"
        force the literal ADC plans.  "auto" on CPU keeps the
        reference-shaped choice (graph) so oracle tests exercise the true
        algorithm."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        B = queries.shape[0]
        if len(self.store) == 0 or self.entry_point is None:
            return (
                np.full((B, k), np.inf, np.float32),
                np.full((B, k), -1, np.int32),
            )
        ef = max(ef, k)
        q_dev = jnp.asarray(queries)
        accelerated = backend.accelerated()
        if route not in ("auto", "graph", "scan", "mirror"):
            raise ValueError(f"unknown route {route!r} (auto|graph|scan|mirror)")
        scannable = getattr(self.store, "_mirror_layout", "scan") == "scan"
        if route == "auto":
            route = plan_pq_route(accelerated, scannable, len(self.store))
        if route == "mirror":
            from .flat import FlatIndex

            fi = FlatIndex.from_store(self.store)
            d, i = fi._knn_device(q_dev, k, rerank_depth=ef)
            return np.asarray(d), np.asarray(i)
        # graph/scan candidate ordering is ADC — loud fallback check
        pq.warn_if_unreliable(f"HNSWIndex.knn_pq route={route!r}")
        lookup, q_norms = pq.create_lookup(q_dev)
        rows = self.store.device_rerank()
        if route == "scan":
            _, cand = pq.adc_scan(lookup, q_norms, ef)
            d, i = T.exact_distances_sorted(q_dev, rows, cand, self.dist)
            return np.asarray(d[:, :k]), np.asarray(i[:, :k])

        codes, _, cb_sq = pq.device()
        m_codes = pq.config.m if pq.packed else None
        # pad codes to store capacity so gathers stay in-bounds
        cap = self.store.capacity
        if codes.shape[0] < cap:
            codes = jnp.pad(codes, ((0, cap - codes.shape[0]), (0, 0)))
        links0 = self._links0_device()
        if expand is None:
            expand = BEAM_EXPAND if accelerated else 1
        iters = (2 * ef + 64 + expand - 1) // expand + 16
        cur = jnp.full((B,), self.entry_point, jnp.int32)
        for level in range(self.enter_level, 0, -1):
            ul = self._upper(level)
            links_l, pos_l = ul.device()
            cur = _greedy_upper_pq(
                lookup, q_norms, codes, cb_sq, links_l, pos_l, cur, 256, self.dist,
                pq.config.m, m_codes=m_codes,
            )
        bd, bi = _beam0_pq(
            lookup, q_norms, codes, cb_sq, links0, cur, ef, iters, expand, self.dist,
            pq.config.m, m_codes=m_codes,
        )
        # exact rerank of the ef beam (candidate_pair.rs:102-108)
        d, i = T.exact_distances_sorted(q_dev, rows, bi[:, :ef], self.dist)
        return np.asarray(d[:, :k]), np.asarray(i[:, :k])

    def knn_pq(self, query, k: int, ef: int, pq: PQTable) -> list[CandidatePair]:
        d, i = self.knn_pq_batch(query, k, ef, pq)
        return pairs_from_arrays(d[0], i[0], k)

    # ---- serde (hnsw_index.rs:635-670) ----
    def state(self, include_vectors: bool = True) -> tuple[dict, dict]:
        n = len(self.store)
        arrays = self.store.state_arrays(include_vectors)
        arrays["hnsw_levels"] = self.levels[:n].copy()
        arrays["hnsw_links0"] = self.links0[:n].copy()
        for l, ul in enumerate(self.upper, start=1):
            arrays[f"hnsw_upper_ids_{l}"] = ul.ids[: ul.n].copy()
            arrays[f"hnsw_upper_links_{l}"] = ul.links[: ul.n].copy()
        meta = {
            "algorithm": "HNSW",
            "dim": self.dim,
            "dist": self.dist,
            "n": n,
            "hnsw": {
                "M": self.config.m,
                "ef_construction": self.config.ef_construction,
                "default_ef": self.config.default_ef,
                "entry_point": self.entry_point,
                "enter_level": self.enter_level,
                "num_upper_levels": len(self.upper),
            },
        }
        return arrays, meta

    @classmethod
    def from_state(
        cls, arrays: dict, meta: dict, external_vectors=None, external_store=None
    ) -> "HNSWIndex":
        """Rebuild from serialized topology.  Vector source, in priority
        order: arrays["vectors"] (whole-table shape), `external_store` (an
        already-populated VecStore, e.g. device-born — the device-resident
        pairing for save(include_vectors=False)), or `external_vectors`
        (host array, the reference's IndexSerdeExternalVecSet shape,
        mod.rs:143-148)."""
        h = meta["hnsw"]
        cfg = HNSWConfig(
            max_elements=meta["n"], ef_construction=h["ef_construction"], M=h["M"]
        )
        vecs = arrays.get("vectors", external_vectors)
        if vecs is None and external_store is None:
            raise ValueError("HNSWIndex state has no vectors and none were provided")
        if vecs is not None:
            vecs = np.asarray(vecs)
            index = cls(meta["dim"], meta["dist"], cfg)
            index.store.batch_push(vecs)
        else:
            if len(external_store) != meta["n"]:
                raise ValueError(
                    f"external store has {len(external_store)} rows, index "
                    f"topology expects {meta['n']}"
                )
            index = cls(meta["dim"], meta["dist"], cfg)
            index.store = external_store
            cap = external_store.capacity
            index.levels = np.zeros(cap, np.int32)
            index.links0 = np.full((cap, index.config.max_m0), -1, np.int32)
        n = meta["n"]
        index.levels[:n] = arrays["hnsw_levels"]
        index.links0[:n] = arrays["hnsw_links0"]
        index._links0_full_dirty = True
        index.config.default_ef = h["default_ef"]
        index.entry_point = h["entry_point"]
        index.enter_level = h["enter_level"]
        for l in range(1, h["num_upper_levels"] + 1):
            ul = index._upper(l)
            ids = arrays[f"hnsw_upper_ids_{l}"]
            links = arrays[f"hnsw_upper_links_{l}"]
            for row, node in enumerate(ids):
                r = ul.ensure_member(int(node))
                ul.links[r] = links[row]
            ul.dirty = True
        return index

    def save(self, path, include_vectors: bool = True) -> None:
        arrays, meta = self.state(include_vectors)
        serde.save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path, external_vectors=None, external_store=None) -> "HNSWIndex":
        arrays, meta = serde.load_arrays(path)
        return cls.from_state(arrays, meta, external_vectors, external_store)
