"""Flat (brute-force exact) index.

Parity target: `FlatIndex` (reference: src/index_algorithm/flat_index.rs).
The reference's per-vector scalar scan loop (flat_index.rs:48-57) becomes a
blocked (B, dim) x (dim, N) GEMM with a running top-k
(`ops/topk.knn_scan`).  `knn_pq` is a blocked ADC scan followed by an exact
rerank of the top max(ef, k) (flat_index.rs:84-104).
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from .store import VecStore
from .pq_table import PQTable
from ..ops import backend
from ..ops import topk as T
from ..utils import serde
from ..utils.candidates import CandidatePair, pairs_from_arrays

# Scan policy (env VECDB_SCAN):
#   "int8"  (default) — per-row-quantized int8 candidate pass (half the
#            bytes of bf16) + exact f32 rerank.
#   "pca"   — PCA-projected int8 candidate pass at VECDB_PCA_DIM dims
#            (default 256) + deeper exact f32 rerank (ops/project.py).
#   "bf16" / "2stage" — bf16 candidate pass + exact f32 rerank.
#   "exact" — single-pass full-f32 scan everywhere (ground-truth mode).
_SCAN_MODE = os.environ.get("VECDB_SCAN", "int8")
# Below this N the planner uses the single-pass exact f32 scan instead of
# the two-stage int8 plan.  The chunk-min scan keeps at most ONE stage-1
# survivor per 128 consecutive mirror rows, so its candidate pool caps at
# n/128 regardless of ef; 64k rows (a 512-survivor cap) keeps the cap above
# any sane ef.  The crossover in time awaits measurement on the card.
_EXACT_BELOW = 65536
# stage-1 candidates per requested neighbor (floor 32).  Beyond 1M rows the
# depth scales with log2(N/1M): twice the rows means more near-boundary
# competitors for the same r.  Both constants await measurement on the card.
_RERANK_MULT = int(os.environ.get("VECDB_RERANK_MULT", "4"))
_PCA_DIM = int(os.environ.get("VECDB_PCA_DIM", "256"))
_RERANK_MULT_PCA = int(os.environ.get("VECDB_RERANK_PCA", "16"))  # floor 128


class FlatIndex:
    algorithm = "Flat"

    def __init__(self, dim: int, dist: str, capacity: int = 0):
        self.store = VecStore(dim, dist, capacity)

    # ---- construction ----
    @classmethod
    def from_numpy(cls, vectors: np.ndarray, dist: str) -> "FlatIndex":
        idx = cls(vectors.shape[1], dist, capacity=len(vectors))
        if len(vectors):
            idx.store.batch_push(vectors)
        return idx

    @classmethod
    def from_store(cls, store: VecStore) -> "FlatIndex":
        if getattr(store, "_mirror_layout", "scan") == "sorted":
            # fail at construction, not first search: the cluster-sorted
            # mirror breaks the full scan's survivor statistics (see
            # _knn_device) and such stores belong to IVFIndex
            raise ValueError(
                "store's int8 mirror is cluster-sorted (binned-IVF scale "
                "layout); FlatIndex requires the randomly-permuted layout"
            )
        idx = cls.__new__(cls)
        idx.store = store
        return idx

    @property
    def dim(self) -> int:
        return self.store.dim

    @property
    def dist(self) -> str:
        return self.store.dist

    def __len__(self) -> int:
        return len(self.store)

    def index_bytes(self) -> int:
        """Device-memory footprint of this index (store arrays; Flat has no
        topology) — recorded per sweep row (BASELINE.md: equal index
        memory)."""
        return self.store.device_bytes()

    def add(self, vec) -> int:
        return self.store.push(vec)

    def batch_add(self, vecs) -> list[int]:
        return self.store.batch_push(vecs)

    # ---- search ----
    def knn_batch(self, queries: np.ndarray, k: int, exact: bool | None = None):
        """Batched exact kNN -> ((B, k) dists, (B, k) ids), -1 padded.

        Default path: int8 candidate scan keeping the best max(4k, 32)
        stage-1 survivors, then an exact f32 rerank of those (returned
        distances are exact f32, matching the reference's f32 scalar scan,
        flat_index.rs:48-57).  `exact=True` (or VECDB_SCAN=exact) forces
        the single-pass full-f32 scan — used for ground-truth generation.

        Lean-tier stores rerank on their bf16 rows; when the
        store retained its block generator (keep_fill, the default) the
        final (B, k) distances are refined to exact f32 here, honoring the
        reference's exact-returned-distance contract.
        """
        d, i = self._knn_device(queries, k, exact)
        if self.store.tier == "lean":
            return self.store.refine_results(
                np.atleast_2d(np.asarray(queries, np.float32)), d, i
            )
        return np.asarray(d), np.asarray(i)

    def _knn_device(self, queries, k: int, exact: bool | None = None,
                    rerank_depth: int | None = None):
        """Device-resident variant of knn_batch (no host fetch; accepts an
        already-uploaded (B, dim) device array to keep pipelines sync-free).

        `rerank_depth` overrides the stage-1 survivor count (how many
        candidates reach the exact rerank).  HNSW's scan route maps its
        `ef` here so the reference's accuracy knob keeps its meaning —
        recall is monotone in the candidate-pool width on both designs."""
        if isinstance(queries, jax.Array):
            q = queries
        else:
            q = jnp.asarray(np.atleast_2d(np.asarray(queries, dtype=np.float32)))
        n = len(self.store)
        lean = self.store.tier == "lean"
        if getattr(self.store, "_mirror_layout", "scan") == "sorted":
            # ingest-sorted mirror (IVFIndex.from_device_blocks(mirror=
            # "sorted")): posting order concentrates a query's neighbors
            # into few 128-row chunks, which collapses the chunk-min
            # survivor statistics the full scan depends on
            raise RuntimeError(
                "store's int8 mirror is cluster-sorted (binned-IVF scale "
                "layout); the full scan requires the randomly-permuted "
                "layout — search via IVFIndex instead"
            )
        if exact is None:
            exact = not lean and (_SCAN_MODE == "exact" or n <= _EXACT_BELOW)
            if not exact and _SCAN_MODE in ("int8", "pca"):
                # quantization self-test: datasets whose neighbor gaps are
                # tiny relative to vector magnitudes defeat int8 ordering
                # at ANY rerank depth; use the exact scan there
                exact = not self.store.int8_reliable()
        if exact:
            if lean:
                raise RuntimeError(
                    "exact f32 scan unavailable on a lean-tier store "
                    "(no f32 device copy; and the int8 self-test failed, "
                    "so the quantized stage-1 cannot be trusted either)"
                )
            vecs, cache = self.store.device()
            return T.knn_scan(q, vecs, cache, jnp.int32(n), k, self.dist)
        mult = _RERANK_MULT
        if n > 1_500_000:  # log2 depth growth past ~1M (see knob comment)
            mult = _RERANK_MULT * max(1, int(np.log2(n / 1_000_000)) + 1)
        r = min(max(mult * k, 32), n)
        if rerank_depth is not None:
            r = min(max(rerank_depth, k, 32), n)
        if _SCAN_MODE == "pca" and _PCA_DIM < self.dim:
            from ..ops import project as PJ

            r = min(max(_RERANK_MULT_PCA * k, 128), n)
            if rerank_depth is not None:
                r = min(max(rerank_depth, k, 128), n)
            proj, mu, p8, pscale, pcache = self.store.device_proj_int8(_PCA_DIM)
            qp = PJ.project(q, proj, mu)
            _, cand = backend.scan_candidates_int8(qp, p8, pscale, pcache, r, self.dist)
            cand = jnp.where(cand < n, cand, T.INVALID_ID)
        elif _SCAN_MODE in ("int8", "pca"):  # pca degrades to int8 at small dim
            base_i8, scales, cache8, perm = self.store.device_int8()
            # validity lives IN the permuted mirror (sentinels)
            _, cand = backend.scan_candidates_int8(
                q, base_i8, scales, cache8, r, self.dist
            )
            cand = T.decode_perm(cand, perm, jnp.int32(n))
        else:
            scan_vecs, scan_cache0 = self.store.device_traversal()
            _, cand = T.scan_candidates(
                q, scan_vecs, scan_cache0, jnp.int32(n), r, self.dist
            )
        # exact f32 distances of the r candidates (the lean tier's rows are
        # its bf16 copy: bf16-grade here, refined in knn_batch)
        d, i = T.exact_distances_sorted(q, self.store.device_rerank(), cand, self.dist)
        return d[:, :k], i[:, :k]

    def knn(self, query, k: int) -> list[CandidatePair]:
        # Single-query fast path: the native serial scan avoids device
        # dispatch latency for interactive lookups.
        from . import native

        res = native.flat_knn_single(self.store, np.asarray(query, np.float32), k)
        if res is not None:
            ids, dists = res
            return [CandidatePair(int(i_), float(d_)) for i_, d_ in zip(ids, dists)]
        d, i = self.knn_batch(query, k)
        return pairs_from_arrays(d[0], i[0], k)

    def knn_with_ef(self, query, k: int, ef: int) -> list[CandidatePair]:
        """Flat search ignores ef (reference: src/database/dynamic_index.rs:75-80)."""
        return self.knn(query, k)

    def knn_pq_batch(self, queries: np.ndarray, k: int, ef: int, pq: PQTable):
        """ADC scan + exact rerank (flat_index.rs:84-104)."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        pq.warn_if_unreliable("FlatIndex.knn_pq (ADC candidate ordering)")
        q_dev = jnp.asarray(queries)
        lookup, q_norms = pq.create_lookup(q_dev)
        _, cand_ids = pq.adc_scan(lookup, q_norms, max(ef, k))
        d, i = T.exact_distances_sorted(q_dev, self.store.device_rerank(), cand_ids, self.dist)
        return np.asarray(d[:, :k]), np.asarray(i[:, :k])

    def knn_pq(self, query, k: int, ef: int, pq: PQTable) -> list[CandidatePair]:
        d, i = self.knn_pq_batch(query, k, ef, pq)
        return pairs_from_arrays(d[0], i[0], k)

    # ---- serde (flat_index.rs:72-83; external-vec-set form stores only config) ----
    def state(self, include_vectors: bool = True) -> tuple[dict, dict]:
        arrays = self.store.state_arrays(include_vectors)
        meta = {
            "algorithm": "Flat",
            "dim": self.dim,
            "dist": self.dist,
            "n": len(self.store),
        }
        return arrays, meta

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, external_vectors: np.ndarray | None = None):
        vecs = arrays.get("vectors", external_vectors)
        if vecs is None:
            raise ValueError("FlatIndex state has no vectors and none were provided")
        idx = cls.from_numpy(np.asarray(vecs), meta["dist"])
        return idx

    def save(self, path, include_vectors: bool = True) -> None:
        arrays, meta = self.state(include_vectors)
        serde.save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path, external_vectors: np.ndarray | None = None) -> "FlatIndex":
        arrays, meta = serde.load_arrays(path)
        return cls.from_state(arrays, meta, external_vectors)
