"""IVF (inverted file) index.

Parity target: `IVFIndex` (reference: src/index_algorithm/ivf_index.rs).
Device design: the coarse quantizer is `ops/kmeans`; posting lists are a
padded `(k, Lmax)` int32 matrix (-1 padded) instead of `Vec<Vec<usize>>`;
search is a centroid GEMM top-n_probes followed by a gather of the probed
rows and a masked batched scan + top-k (`ops/topk.knn_gathered_blocked`) —
the "segmented matmul" formulation of ivf_index.rs:143-154.

As in the reference, `ef` means the number of probed lists
(ivf_index.rs:137-142) and the default is 4 probes (ivf_index.rs:97).

Large batches on an accelerator take the BINNED path
(`_knn_device_binned`): each probed list is scanned ONCE against the block
of queries probing it — one batched int8 GEMM over (list, query bin, list
rows) on the cluster-sorted int8 mirror, a group min, a per-query regroup
and an exact rerank.  Where it overtakes the exact full scan in N awaits
measurement on the card.
"""

from __future__ import annotations

from functools import partial as _partial

import numpy as np
import jax as _jax
import jax.numpy as jnp

from .store import VecStore
from ..ops import backend
from ..ops import kmeans as KM
from ..ops import topk as T
from ..utils.config import IVFConfig
from ..utils import serde
from ..utils.candidates import CandidatePair, pairs_from_arrays

DEFAULT_N_PROBES = 4
_QB = 128  # queries per list bin in the batched binned scan
_LPAD_MULT = 512  # list rows padded to this multiple
_GS = 4  # rows per survivor group in the binned scan's group min
_LCAP_QUANTILE = 0.9  # lists capped at this length quantile (padded); the
# remainder spills to the always-scanned overflow segment


def _build_posting(assign: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized posting-list build: (k, Lmax) int32 (-1 padded), (k,) lens.

    (The reference pushes row-by-row into Vec<Vec<usize>>,
    ivf_index.rs:88-96; a stable argsort groups 1M rows in ~0.1 s.)
    """
    n = len(assign)
    counts = np.bincount(assign, minlength=k).astype(np.int32)
    l_max = max(int(counts.max()), 1)
    posting = np.full((k, l_max), -1, dtype=np.int32)
    if n:
        order = np.argsort(assign, kind="stable").astype(np.int32)
        start = np.zeros(k, dtype=np.int64)
        start[1:] = np.cumsum(counts)[:-1]
        cols = np.arange(n, dtype=np.int64) - start[assign[order]]
        posting[assign[order], cols] = order
    return posting, counts


def _sorted_layout(
    posting: np.ndarray, posting_len: np.ndarray, k: int,
    cap_quantile: float = _LCAP_QUANTILE,
    pad_mult: int = _LPAD_MULT,
) -> tuple[int, np.ndarray, np.ndarray]:
    """Cluster-sorted mirror layout for the binned scan.

    Returns (lpad, perm_pad, ov_ids): each posting list occupies one
    contiguous `lpad`-row segment (`perm_pad[slot] = original id`, -1 on
    pads); lists are capped at the padded `_LCAP_QUANTILE` length and the
    tails spill into the shared overflow segment `ov_ids` (scanned by every
    query, so spilled rows stay findable regardless of probe choice).
    """
    lens = posting_len
    l_q = int(np.quantile(lens, cap_quantile)) if len(lens) else 1
    lpad = max(pad_mult, ((l_q + pad_mult - 1) // pad_mult) * pad_mult)
    perm_pad = np.full((k * lpad,), -1, dtype=np.int32)
    ov_ids = []
    for l in range(k):
        c = int(lens[l])
        kept = min(c, lpad)
        perm_pad[l * lpad : l * lpad + kept] = posting[l, :kept]
        if c > lpad:
            ov_ids.append(posting[l, lpad:c])
    ov = (
        np.concatenate(ov_ids).astype(np.int32)
        if ov_ids
        else np.zeros((0,), np.int32)
    )
    return lpad, perm_pad, ov


@_partial(
    _jax.jit,
    static_argnames=("nlist", "n_probes", "k", "lpad", "dist", "has_overflow"),
)
def _binned_candidates(
    q_dev, centroids, q8s, scale_s, cache_s, perm_pad,
    q8_ov, scale_ov, cache_ov, perm_ov,
    *, nlist, n_probes, k, lpad, dist, has_overflow,
):
    """Candidate stage of the binned-IVF search: probe selection, query
    binning, one batched int8 GEMM of every list against its query bin, a
    group min, the per-query regroup + top-r, and the overflow scan.
    Returns ((B, C) candidate original ids, dropped pair count)."""
    from ..ops import binning as BN

    B = q_dev.shape[0]
    dim_pad = q8s.shape[1]
    q = q_dev.astype(jnp.float32)
    _, probe_ids = KM.find_n_nearest(q, centroids, n_probes, dist)  # (B, p)
    bins, slots = BN.bin_queries(probe_ids, nlist, _QB)  # (nlist, QB), (B, p)
    q8, qs2, qc = T.int8_queries(q, dim_pad, dist)

    # (nlist, QB, lpad) distances: each list's sorted rows against the
    # queries binned to it (pad slots read query 0 and are never used)
    bc = jnp.maximum(bins, 0)
    dots = jnp.einsum(
        "lqd,lrd->lqr", q8[bc], q8s[: nlist * lpad].reshape(nlist, lpad, dim_pad),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32)
    sc = scale_s[: nlist * lpad].reshape(nlist, 1, lpad)
    ca = cache_s[: nlist * lpad].reshape(nlist, 1, lpad)
    d = (ca + qc[bc][:, :, None]) - dots * (sc * qs2[bc][:, :, None])
    # group min over _GS consecutive sorted rows: list rows of one cluster
    # have close true distances, so the groups are small
    g = d.reshape(nlist, _QB, lpad // _GS, _GS)
    spl = lpad // _GS  # survivors per list
    gmin = jnp.min(g, axis=3).reshape(nlist * _QB, spl)
    garg = jnp.argmin(g, axis=3).astype(jnp.int32).reshape(nlist * _QB, spl)

    # regroup: query b's survivors live in row (probe_ids[b, j], slots[b, j])
    dropped = slots < 0
    rows = (probe_ids * _QB + jnp.maximum(slots, 0)).reshape(-1)
    cand_d = jnp.where(
        jnp.repeat(dropped, spl, axis=1), jnp.inf,
        gmin[rows].reshape(B, n_probes * spl),
    )
    grp = jnp.arange(spl, dtype=jnp.int32) * _GS
    sorted_row = (
        probe_ids[:, :, None] * lpad + grp[None, None, :]
        + garg[rows].reshape(B, n_probes, spl)
    ).reshape(B, n_probes * spl)
    # deeper rerank than the full scan: the pool is ordered by int8
    # distance over in-list rows whose true distances are CLOSE (same
    # cluster), so int8 ordering noise needs more exact-rerank headroom
    r = min(max(8 * k, 64), n_probes * spl)
    nd, srow = T.select_smallest(cand_d, sorted_row, r)
    orig = perm_pad[jnp.clip(srow, 0, perm_pad.shape[0] - 1)]
    orig = jnp.where(nd >= jnp.float32(1.0e38), T.INVALID_ID, orig)

    if has_overflow:
        # spilled rows of over-long lists: every query scans them (they stay
        # findable for any probe set)
        n_ov = q8_ov.shape[0]
        r_ov = min(max(4 * k, 32), n_ov)
        bd_ov, bi_ov = T.scan_candidates_int8(
            q, q8_ov, scale_ov, cache_ov, jnp.int32(n_ov), r_ov, dist
        )
        orig_ov = jnp.where(
            bi_ov >= 0, perm_ov[jnp.clip(bi_ov, 0, n_ov - 1)], T.INVALID_ID
        )
        orig = jnp.concatenate([orig, orig_ov], axis=1)

    # telemetry: (query, list) pairs dropped by bin overflow (> _QB queries
    # probing one list)
    return orig, jnp.sum(dropped.astype(jnp.int32))


class IVFIndex:
    algorithm = "IVF"

    def __init__(
        self,
        store: VecStore,
        config: IVFConfig,
        centroids: np.ndarray,
        posting: np.ndarray,  # (k, Lmax) int32, -1 padded
        posting_len: np.ndarray,  # (k,)
    ):
        self.store = store
        self.config = config
        self.centroids = np.asarray(centroids, dtype=np.float32)
        self.posting = np.asarray(posting, dtype=np.int32)
        self.posting_len = np.asarray(posting_len, dtype=np.int32)
        self.default_n_probes = DEFAULT_N_PROBES
        self._dev_centroids = None
        self._dev_posting = None
        # (q8_sorted, scale_sorted, cache_sorted, perm_pad, lpad) for the
        # batched binned scan; built lazily on first large-batch search
        self._dev_binned = None
        # bin-overflow telemetry (see _note_drops): dropped (query, list)
        # probe pairs of the last binned batch / cumulatively
        self._pending_drop_count = None
        self.last_dropped_pairs = 0
        self.dropped_pairs_total = 0

    @property
    def dim(self) -> int:
        return self.store.dim

    @property
    def dist(self) -> str:
        return self.store.dist

    def index_bytes(self) -> int:
        """Device-memory footprint: store arrays + centroids/posting matrices
        (+ the binned-scan sorted mirror when built)."""
        total = self.store.device_bytes()
        for a in (self._dev_centroids, self._dev_posting):
            if a is not None:
                total += int(a.nbytes)
        if self._dev_binned is not None:
            for a in self._dev_binned:
                if hasattr(a, "nbytes"):
                    total += int(a.nbytes)
        return total

    def __len__(self) -> int:
        return len(self.store)

    # ---- build (ivf_index.rs:64-107) ----
    @classmethod
    def from_numpy(
        cls, vectors: np.ndarray, dist: str, config: IVFConfig, seed: int = 0
    ) -> "IVFIndex":
        import jax

        n = len(vectors)
        rng = np.random.default_rng(seed)
        if config.k_means_size is not None and config.k_means_size < n:
            sel = rng.choice(n, size=config.k_means_size, replace=False)
            train = vectors[sel]
        else:
            train = vectors
        train_dev = jnp.asarray(np.ascontiguousarray(train, dtype=np.float32))
        centroids = KM.kmeans_fit(
            jax.random.PRNGKey(seed),
            train_dev,
            jnp.int32(len(train)),
            config.k,
            config.k_means_max_iter,
            config.k_means_tol,
            dist,
        )
        vec_dev = jnp.asarray(np.ascontiguousarray(vectors, dtype=np.float32))
        assign = np.asarray(jax.device_get(KM.find_nearest(vec_dev, centroids, dist)))
        centroids = np.asarray(jax.device_get(centroids))

        store = VecStore.from_numpy(vectors, dist)
        posting, counts = _build_posting(assign, config.k)
        return cls(store, config, centroids, posting, counts)

    @classmethod
    def from_store(cls, store: VecStore, config: IVFConfig, seed: int = 0) -> "IVFIndex":
        """Build over an existing (possibly device-born) store with the
        k-means + assignment running entirely on device."""
        import jax

        n = len(store)
        vec_dev, _ = store.device()
        if config.k_means_size is not None and config.k_means_size < n:
            train_dev = vec_dev[: config.k_means_size]  # device-born: rows already shuffled
            n_train = config.k_means_size
        else:
            train_dev = vec_dev
            n_train = n
        centroids = KM.kmeans_fit(
            jax.random.PRNGKey(seed),
            train_dev,
            jnp.int32(n_train),
            config.k,
            config.k_means_max_iter,
            config.k_means_tol,
            store.dist,
        )
        assign = np.asarray(KM.find_nearest(vec_dev, centroids, store.dist))[:n]
        posting, counts = _build_posting(assign, config.k)
        return cls(store, config, np.asarray(centroids), posting, counts)

    @classmethod
    def from_device_blocks(
        cls,
        fill,
        n: int,
        dim: int,
        dist: str,
        config: IVFConfig,
        seed: int = 0,
        rerank_dtype=jnp.bfloat16,
        block_rows: int = 131072,
        mirror: str = "scan",
    ) -> "IVFIndex":
        """Memory-LEAN build for datasets whose f32 form exceeds device
        memory (see VecStore.from_device_blocks): k-means trains on the
        first generated block, every block is cluster-assigned while still
        f32 on device, and only the int8 scan mirror + reduced-precision
        rows persist.  This is the intended ingest for the binned-IVF scale
        path, where the full tier cannot hold the f32 canonical copy.

        `mirror="scan"` (default) keeps the randomly-permuted full-scan
        mirror; the binned search then gathers a SECOND, cluster-sorted
        copy on first use (double residency).  `mirror="sorted"` instead
        lays the mirror out in posting order AT INGEST (two passes over
        `fill`: assign-only, then quantize-and-scatter straight into sorted
        slots), so the binned search runs zero-copy.  A sorted mirror
        breaks the full scan's chunk-min survivor statistics, so FlatIndex
        refuses such stores; the binned IVF path serves them."""
        import jax
        from .store import VecStore

        if mirror not in ("scan", "sorted"):
            raise ValueError(f"mirror must be 'scan' or 'sorted', got {mirror!r}")
        n_train = min(config.k_means_size or block_rows, n, block_rows)
        train = fill(0, n_train)
        centroids_dev = KM.kmeans_fit(
            jax.random.PRNGKey(seed),
            train,
            jnp.int32(n_train),
            config.k,
            config.k_means_max_iter,
            config.k_means_tol,
            dist,
        )
        del train
        assign = np.empty(n, np.int32)

        def assign_fn(v, row0):
            a = KM.find_nearest(v, centroids_dev, dist)
            assign[row0 : row0 + v.shape[0]] = np.asarray(a)

        if mirror == "sorted":
            # pass A: assignment only (no store writes) — the sorted slot
            # of a row depends on the full posting layout
            for row0 in range(0, n, block_rows):
                rows = min(block_rows, n - row0)
                v = fill(row0, rows)
                assign_fn(v, row0)
                del v
            posting, counts = _build_posting(assign, config.k)
            lpad, perm_pad, ov_h = _sorted_layout(posting, counts, config.k)
            kl = config.k * lpad
            cap = kl + len(ov_h)
            # full mirror permutation: perm[slot] = original id.  Valid ids
            # (one slot each: capped prefix or overflow) + filler ids
            # n..cap-1 on pad slots (never written -> keep the sentinel).
            perm_full = np.empty(cap, np.int32)
            perm_full[:kl] = perm_pad
            perm_full[kl:] = ov_h
            pad_slots = np.flatnonzero(perm_full < 0)
            perm_full[pad_slots] = np.arange(n, cap, dtype=np.int32)
            store = VecStore.from_device_blocks(
                fill, n, dim, dist,
                rerank_dtype=rerank_dtype, block_rows=block_rows,
                perm=perm_full, cap=cap,
            )
            return cls(store, config, np.asarray(centroids_dev), posting, counts)

        store = VecStore.from_device_blocks(
            fill, n, dim, dist,
            rerank_dtype=rerank_dtype, block_rows=block_rows,
            assign_fn=assign_fn,
        )
        posting, counts = _build_posting(assign, config.k)
        return cls(store, config, np.asarray(centroids_dev), posting, counts)

    # ---- search (ivf_index.rs:143-154) ----
    def _device(self):
        if self._dev_centroids is None:
            self._dev_centroids = jnp.asarray(self.centroids)
            self._dev_posting = jnp.asarray(self.posting)
        return self._dev_centroids, self._dev_posting

    def _device_sorted(self):
        """Cluster-sorted int8 mirror for the binned scan, built once.

        Rows are permuted so each posting list is one contiguous padded
        segment of `lpad` rows; padded rows carry the losing sentinel
        (zero cross factor + BIG additive bias, both metrics) with no
        positional masking.

        k-means lists are skewed (merged natural clusters can be ~5x the
        mean), so padding every list to the GLOBAL max would multiply memory
        and scan work.  Lists are instead capped at the padded
        `_LCAP_QUANTILE` length; rows beyond the cap spill into a shared
        OVERFLOW segment that every query scans with the int8 full scan —
        so spilled rows stay findable regardless of probe choice.
        """
        if self._dev_binned is None:
            k = self.config.k
            if getattr(self.store, "_mirror_layout", "scan") == "sorted":
                # ingest-sorted mirror (from_device_blocks(mirror="sorted")):
                # the store's int8 mirror IS the sorted layout — zero-copy
                # views for the binned scan (which reads only the first
                # k*lpad rows), one small slice for overflow.  This avoids
                # the double-residency gather below.
                import jax

                lpad, perm_pad, ov_h = _sorted_layout(
                    self.posting, self.posting_len, k
                )
                q8_all, scales, cache, _ = self.store.device_int8()
                kl = k * lpad
                if kl + len(ov_h) != self.store._cap:
                    # the recomputed layout must be the one the ingest used
                    # (same posting/config.k); otherwise the binned search
                    # would silently decode wrong ids
                    raise ValueError(
                        "sorted-mirror layout mismatch: recomputed "
                        f"k*lpad+overflow = {kl + len(ov_h)} but the store "
                        f"was ingested with capacity {self.store._cap}; "
                        "this IVFIndex was not built over this store's "
                        "posting layout"
                    )
                ov = None
                n_ov = len(ov_h)
                if n_ov:
                    q8_ov = jax.lax.dynamic_slice_in_dim(q8_all, kl, n_ov)
                    scale_ov = jax.lax.dynamic_slice_in_dim(scales, kl, n_ov)
                    cache_ov = jax.lax.dynamic_slice_in_dim(cache, kl, n_ov)
                    ov = (q8_ov, scale_ov, cache_ov, jnp.asarray(ov_h))
                self._dev_binned = (
                    q8_all, scales, cache, jnp.asarray(perm_pad), lpad, ov,
                )
                return self._dev_binned

            lpad, perm_pad, ov_h = _sorted_layout(self.posting, self.posting_len, k)
            q8_all, scales, cache = self.store.device_int8()[:3]
            # the int8 mirror is scan-permuted; translate original ids to
            # mirror rows on the host before gathering.  Gathered valid rows
            # carry true scale/cache (sentinels only sit on invalid rows).
            inv = self.store._scan_inv
            pp = jnp.asarray(perm_pad)
            clamped = jnp.asarray(inv[np.maximum(perm_pad, 0)])
            valid = pp >= 0
            q8_sorted = q8_all[clamped]
            # pads: zero cross factor + BIG additive bias — a losing
            # sentinel for BOTH metrics under the unified channel formula
            scale_sorted = jnp.where(valid, scales[clamped], 0.0)
            cache_sorted = jnp.where(valid, cache[clamped], jnp.float32(T.BIG))
            ov = None
            if len(ov_h):
                rows_m = jnp.asarray(inv[ov_h])
                ov = (q8_all[rows_m], scales[rows_m], cache[rows_m], jnp.asarray(ov_h))
            import jax

            jax.block_until_ready(q8_sorted)
            self._dev_binned = (q8_sorted, scale_sorted, cache_sorted, pp, lpad, ov)
        return self._dev_binned

    def _knn_device_binned(self, q_dev, k: int, n_probes: int):
        """Batched binned IVF search, fully on device (no host sync).

        The per-query list scan of the reference (ivf_index.rs:143-154)
        inverts into per-LIST scans over the block of queries probing each
        list: centroid GEMM top-p -> on-device query binning -> one batched
        int8 GEMM + group min -> per-query regroup + top-r -> exact rerank.
        Overflowing a list's query bin (> _QB probes) drops that
        (query, list) pair only.
        """
        q8s, scale_s, cache_s, perm_pad, lpad, overflow = self._device_sorted()
        centroids, _ = self._device()
        nlist = self.config.k
        n_probes = min(n_probes, nlist)
        if overflow is not None:
            q8_ov, scale_ov, cache_ov, perm_ov = overflow
        else:
            q8_ov = jnp.zeros((0, q8s.shape[1]), jnp.int8)
            scale_ov = jnp.zeros((0,), jnp.float32)
            cache_ov = jnp.zeros((0,), jnp.float32)
            perm_ov = jnp.zeros((0,), jnp.int32)
        orig, n_dropped = _binned_candidates(
            q_dev, centroids, q8s, scale_s, cache_s, perm_pad,
            q8_ov, scale_ov, cache_ov, perm_ov,
            nlist=nlist, n_probes=n_probes, k=k, lpad=lpad, dist=self.dist,
            has_overflow=overflow is not None,
        )
        d, i = T.exact_distances_sorted(q_dev, self.store.device_rerank(), orig, self.dist)
        self._pending_drop_count = n_dropped  # device scalar; read lazily
        return d[:, :k], i[:, :k]

    def _note_drops(self) -> None:
        """Fold the last batch's bin-overflow drop count into the counters
        (host sync of one scalar; called after results are fetched so it
        never adds a round-trip on the hot path)."""
        nd = self._pending_drop_count
        if nd is None:
            return
        self._pending_drop_count = None
        n = int(nd)
        self.last_dropped_pairs = n
        self.dropped_pairs_total += n
        if n:
            import logging

            logging.getLogger(__name__).warning(
                "binned IVF: %d (query, list) probe pairs dropped by bin "
                "overflow (> %d queries probing one list); recall on the "
                "affected queries is degraded — lower the batch size or "
                "raise nlist for this workload (total dropped: %d)",
                n, _QB, self.dropped_pairs_total,
            )

    def knn_batch(self, queries: np.ndarray, k: int, n_probes: int | None = None):
        n_probes = n_probes or self.default_n_probes
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        q_dev = jnp.asarray(queries)
        if (
            backend.accelerated()
            and len(queries) >= 32
            and self.store.int8_reliable()
        ):
            # batched binned path: each probed list is scanned ONCE against
            # the block of queries probing it (per-query posting gathers
            # re-read shared rows B times over).  Gated on the int8
            # ordering self-test like the Flat/HNSW int8 paths.
            d, i = self._knn_device_binned(q_dev, k, n_probes)
            d, i = np.asarray(d), np.asarray(i)
            self._note_drops()
            return d, i
        centroids, posting = self._device()
        _, probe_ids = KM.find_n_nearest(q_dev, centroids, n_probes, self.dist)
        cand = posting[probe_ids]  # (B, n_probes, Lmax)
        cand = cand.reshape(cand.shape[0], -1)
        # probe unions can span most of the set: the gather runs in column
        # blocks so the (B, block, dim) intermediate stays bounded
        d, i = T.knn_gathered_blocked(
            q_dev, self.store.device_rerank(), cand, k, self.dist
        )
        return np.asarray(d), np.asarray(i)

    def knn(self, query, k: int) -> list[CandidatePair]:
        d, i = self.knn_batch(query, k, self.default_n_probes)
        return pairs_from_arrays(d[0], i[0], k)

    def knn_with_ef(self, query, k: int, ef: int) -> list[CandidatePair]:
        """`ef` is the number of probes (ivf_index.rs:137-142)."""
        d, i = self.knn_batch(query, k, ef)
        return pairs_from_arrays(d[0], i[0], k)

    # ---- serde ----
    def state(self, include_vectors: bool = True) -> tuple[dict, dict]:
        arrays = self.store.state_arrays(include_vectors)
        arrays.update(
            ivf_centroids=self.centroids,
            ivf_posting=self.posting,
            ivf_posting_len=self.posting_len,
        )
        meta = {
            "algorithm": "IVF",
            "dim": self.dim,
            "dist": self.dist,
            "n": len(self.store),
            "ivf": {
                "k": self.config.k,
                "k_means_size": self.config.k_means_size,
                "k_means_max_iter": self.config.k_means_max_iter,
                "k_means_tol": self.config.k_means_tol,
            },
        }
        return arrays, meta

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, external_vectors=None) -> "IVFIndex":
        vecs = arrays.get("vectors", external_vectors)
        if vecs is None:
            raise ValueError("IVFIndex state has no vectors and none were provided")
        store = VecStore.from_numpy(np.asarray(vecs), meta["dist"])
        cfg = IVFConfig.from_dict(meta["ivf"])
        return cls(
            store, cfg, arrays["ivf_centroids"], arrays["ivf_posting"], arrays["ivf_posting_len"]
        )

    def save(self, path, include_vectors: bool = True) -> None:
        arrays, meta = self.state(include_vectors)
        serde.save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path, external_vectors=None) -> "IVFIndex":
        arrays, meta = serde.load_arrays(path)
        return cls.from_state(arrays, meta, external_vectors)
