"""Multi-chip sharding: mesh + shard_map kernels with collectives (NCCL on GPUs).

The reference is single-node shared-memory (rayon work-stealing + OS threads;
SURVEY.md section 2 parallelism inventory) with multi-process explicitly
prevented by a lock file.  The device scale story replaces all of that
with SPMD over a `jax.sharding.Mesh`:

- **data axis**: the vector set is sharded over chips along N; each chip
  scans its shard with the same blocked GEMM kernel and keeps a local top-k;
  a `lax.all_gather` over the interconnect merges the per-chip candidates into a global
  top-k (the distributed equivalent of the rayon fan-out at
  examples/bench.rs:414-418).
- **subspace axis**: PQ's m groups are embarrassingly parallel (the
  reference trains them serially, pq_table.rs:154-171); sharding the group
  axis is the "tensor/subspace-parallel" analog for this workload.
- k-means: per-chip assignment + `psum` of the per-centroid partial sums and
  counts — one Lloyd step with data parallelism over N.

Everything is jit-compiled once; XLA inserts the collectives.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import inspect

from jax import shard_map as _shard_map

if "check_vma" in inspect.signature(_shard_map).parameters:
    # new API: disable varying-manual-axes inference — the outputs here are
    # replicated by construction (all_gather/psum before returning)
    def shard_map(f=None, **kw):
        if f is None:
            return _shard_map(check_vma=False, **kw)
        return _shard_map(f, check_vma=False, **kw)
else:  # pragma: no cover - older jax
    shard_map = _shard_map

from ..ops import distance as D
from ..ops import topk as T


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_base(mesh: Mesh, base: np.ndarray, dist: str):
    """Pad and shard an (N, dim) base over the mesh's data axis.

    Returns (base_sharded, cache_sharded, n_local (n_dev,), shard_size).
    """
    n_dev = mesh.devices.size
    n, dim = base.shape
    shard = -(-n // n_dev)
    shard = max(shard, 8)
    pad = n_dev * shard - n
    base_p = np.zeros((n_dev * shard, dim), np.float32)
    base_p[:n] = base
    n_local = np.minimum(np.maximum(n - shard * np.arange(n_dev), 0), shard).astype(
        np.int32
    )
    sharding = NamedSharding(mesh, P("data", None))
    base_dev = jax.device_put(base_p, sharding)
    cache_dev = jax.jit(
        lambda x: D.dist_cache(x, dist),
        in_shardings=sharding,
        out_shardings=NamedSharding(mesh, P("data")),
    )(base_dev)
    n_local_dev = jax.device_put(n_local, NamedSharding(mesh, P("data")))
    return base_dev, cache_dev, n_local_dev, shard


@partial(jax.jit, static_argnames=("k", "dist", "mesh", "shard"))
def _sharded_knn(queries, base, cache, n_local, k, dist, mesh, shard):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, None), P("data", None), P("data"), P("data")),
        out_specs=(P(None, None), P(None, None)),
    )
    def kernel(q, base_l, cache_l, n_l):
        # per-chip blocked scan over the local shard
        d, i = T.knn_scan(q, base_l, cache_l, n_l[0], k, dist)
        # local ids -> global ids
        offset = jax.lax.axis_index("data").astype(jnp.int32) * shard
        i = jnp.where(i >= 0, i + offset, -1)
        # all-gather of per-chip candidates, then a local merge
        all_d = jax.lax.all_gather(d, "data", axis=1).reshape(d.shape[0], -1)
        all_i = jax.lax.all_gather(i, "data", axis=1).reshape(d.shape[0], -1)
        return T.topk_smallest(jnp.where(all_i >= 0, all_d, jnp.inf), all_i, k)

    return kernel(queries, base, cache, n_local)


@partial(jax.jit, static_argnames=("k", "r", "dist", "mesh", "shard"))
def _sharded_knn_2stage(queries, base, base_scan, cache, n_local, k, r, dist, mesh, shard):
    """Sharded two-stage scan: per-chip bf16 candidate GEMM + approx_min_k,
    per-chip exact f32 rerank of its own r candidates, then an
    all-gather of the (B, k) per-chip bests and a final merge.

    The multi-chip form of the single-chip fast path
    (models/flat.py:_knn_device): heavy traffic (bf16 scan + candidate
    vector reads) stays shard-local; only (B, k) floats cross the interconnect.
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, None), P("data", None), P("data", None), P("data"), P("data")),
        out_specs=(P(None, None), P(None, None)),
    )
    def kernel(q, base_l, scan_l, cache_l, n_l):
        _, cand = T.scan_candidates(q, scan_l, cache_l, n_l[0], r, dist)
        dd, ii = T.exact_distances_sorted(q, base_l, cand, dist, base_cache=cache_l)
        dd, ii = dd[:, :k], ii[:, :k]
        offset = jax.lax.axis_index("data").astype(jnp.int32) * shard
        ii = jnp.where(ii >= 0, ii + offset, -1)
        all_d = jax.lax.all_gather(dd, "data", axis=1).reshape(dd.shape[0], -1)
        all_i = jax.lax.all_gather(ii, "data", axis=1).reshape(dd.shape[0], -1)
        return T.topk_smallest(jnp.where(all_i >= 0, all_d, jnp.inf), all_i, k)

    return kernel(queries, base, base_scan, cache, n_local)


def _load_checkpoint(path: str, kind: str, mesh: Mesh, external_base):
    """Shared load prologue: read the npz, check the kind tag, resolve the
    base rows (inline or external), and re-derive the mesh placement.
    Sharded checkpoints store the UNSHARDED canonical rows (placement is a
    property of the mesh, not of the data) so a checkpoint saved on an
    8-chip mesh loads onto any mesh size."""
    from ..utils.serde import load_arrays

    arrays, meta = load_arrays(path)
    if meta.get("kind") != kind:
        raise ValueError(f"{path} is not a {kind} checkpoint (kind={meta.get('kind')!r})")
    if "base" in arrays:
        base = arrays["base"]
    else:
        if external_base is None:
            raise ValueError(f"{path} was saved without vectors; pass external_base")
        base = np.ascontiguousarray(external_base[: int(meta["n"])], dtype=np.float32)
    if base.shape != (int(meta["n"]), int(meta["dim"])):
        raise ValueError(
            f"base shape {base.shape} != checkpointed ({meta['n']}, {meta['dim']})"
        )
    return arrays, meta, base


class ShardedFlatIndex:
    """Exact kNN over a vector set sharded across every chip in the mesh."""

    def __init__(self, mesh: Mesh, base: np.ndarray, dist: str):
        D.check_dist(dist)
        self.mesh = mesh
        self.dist = dist
        self.n = len(base)
        self.dim = base.shape[1]
        self.base, self.cache, self.n_local, self.shard = shard_base(mesh, base, dist)
        self._scan = None

    # ---- serde (reference shapes: whole-structure and external-vec-set,
    # index_algorithm/mod.rs:120-148; Flat's topology is just the dist tag,
    # flat_index.rs:72-83) ----
    def save(self, path: str, include_vectors: bool = True) -> None:
        from ..utils.serde import save_arrays

        arrays = {}
        if include_vectors:
            arrays["base"] = np.asarray(self.base)[: self.n]
        save_arrays(path, arrays, dict(kind="sharded_flat", dist=self.dist,
                                       n=self.n, dim=self.dim))

    @classmethod
    def load(cls, path: str, mesh: Mesh, external_base: np.ndarray | None = None):
        _, meta, base = _load_checkpoint(path, "sharded_flat", mesh, external_base)
        return cls(mesh, base, meta["dist"])

    def knn_batch(self, queries: np.ndarray, k: int, exact: bool = True):
        """Batched kNN.  exact=True runs the single-pass f32 scan per shard;
        exact=False runs the two-stage bf16-candidates + exact-rerank path
        (same recall profile as the single-chip fast path)."""
        q = jnp.asarray(np.atleast_2d(np.asarray(queries, np.float32)))
        if exact:
            d, i = _sharded_knn(
                q, self.base, self.cache, self.n_local, k, self.dist, self.mesh, self.shard
            )
        else:
            if self._scan is None:
                self._scan = jax.jit(
                    lambda x: x.astype(jnp.bfloat16),
                    out_shardings=NamedSharding(self.mesh, P("data", None)),
                )(self.base)
            r = min(max(8 * k, 64), self.shard)
            d, i = _sharded_knn_2stage(
                q, self.base, self._scan, self.cache, self.n_local, k, r,
                self.dist, self.mesh, self.shard,
            )
        return np.asarray(d), np.asarray(i)


@partial(jax.jit, static_argnames=("k", "ef", "dist", "mesh", "shard"))
def _sharded_knn_pq(
    queries, lookup, q_norms, codes, cb_sq, base, cache, n_local, k, ef, dist, mesh, shard
):
    """Sharded ADC scan + per-chip exact rerank + all-gather top-k merge.

    The PQ codes ride the same data axis as the vectors; each chip scans its
    code shard with the lookup table (replicated — it is tiny), reranks its
    own top-ef candidates exactly against its local vector shard, and the
    reranked per-chip k-bests are all-gathered and merged.  This keeps the
    heavy traffic (codes + candidate vectors) local and sends only (B, k)
    floats over the interconnect.
    """
    from ..ops import pq as PQ

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(None, None),
            P(None, None, None),
            P(None),
            P("data", None),
            P(None, None),
            P("data", None),
            P("data"),
            P("data"),
        ),
        out_specs=(P(None, None), P(None, None)),
    )
    def kernel(q, lut, qn, codes_l, cb, base_l, cache_l, n_l):
        d, i = PQ.adc_scan(lut, codes_l, n_l[0], cb, qn, ef, dist)
        dd, ii = T.knn_gathered(q, base_l, i, k, dist, base_cache=cache_l)
        offset = jax.lax.axis_index("data").astype(jnp.int32) * shard
        ii = jnp.where(ii >= 0, ii + offset, -1)
        all_d = jax.lax.all_gather(dd, "data", axis=1).reshape(dd.shape[0], -1)
        all_i = jax.lax.all_gather(ii, "data", axis=1).reshape(dd.shape[0], -1)
        return T.topk_smallest(jnp.where(all_i >= 0, all_d, jnp.inf), all_i, k)

    return kernel(queries, lookup, q_norms, codes, cb_sq, base, cache, n_local)


class ShardedPQFlatIndex:
    """PQ-accelerated exact-reranked kNN over a sharded vector set.

    The multi-device analog of the reference's Flat+PQ path
    (flat_index.rs:84-104) distributed over chips.
    """

    def __init__(self, mesh: Mesh, base: np.ndarray, pq_table, dist: str):
        D.check_dist(dist)
        self.mesh = mesh
        self.dist = dist
        self.pq = pq_table
        self.n = len(base)
        self.dim = base.shape[1]
        self.base, self.cache, self.n_local, self.shard = shard_base(mesh, base, dist)
        n_dev = mesh.devices.size
        codes = np.asarray(pq_table.codes)
        pad = n_dev * self.shard - len(codes)
        codes_p = np.zeros((len(codes) + pad, codes.shape[1]), codes.dtype)
        codes_p[: len(codes)] = codes
        self.codes = jax.device_put(codes_p, NamedSharding(mesh, P("data", None)))
        _, cb, cb_sq = pq_table.device()
        self.cb_sq = cb_sq

    def knn_batch(self, queries: np.ndarray, k: int, ef: int | None = None):
        q = jnp.asarray(np.atleast_2d(np.asarray(queries, np.float32)))
        ef = max(ef or k, k)
        lookup, q_norms = self.pq.create_lookup(q)
        d, i = _sharded_knn_pq(
            q, lookup, q_norms, self.codes, self.cb_sq, self.base, self.cache,
            self.n_local, k, ef, self.dist, self.mesh, self.shard,
        )
        return np.asarray(d), np.asarray(i)

    # ---- serde: the PQ sidecar's own state rides inside the checkpoint ----
    def save(self, path: str, include_vectors: bool = True) -> None:
        from ..utils.serde import save_arrays

        pq_arrays, pq_meta = self.pq.state()
        arrays = dict(pq_arrays)
        if include_vectors:
            arrays["base"] = np.asarray(self.base)[: self.n]
        save_arrays(path, arrays, dict(kind="sharded_pq_flat", dist=self.dist,
                                       n=self.n, dim=self.dim, **pq_meta))

    @classmethod
    def load(cls, path: str, mesh: Mesh, external_base: np.ndarray | None = None):
        from ..models.pq_table import PQTable

        arrays, meta, base = _load_checkpoint(path, "sharded_pq_flat", mesh, external_base)
        pq = PQTable.from_state(arrays, meta)
        return cls(mesh, base, pq, meta["dist"])


@partial(jax.jit, static_argnames=("k", "n_probes", "dist", "mesh", "shard"))
def _sharded_knn_ivf(
    queries, centroids, posting, base, cache, n_local, k, n_probes, dist, mesh, shard
):
    """Sharded IVF probe scan: replicated centroids, per-chip posting
    segments, all-gather top-k merge.

    Every chip selects the SAME n_probes lists for a query (the centroid
    GEMM is replicated — it is tiny), then scans only its own segment of
    each probed list: the row shard is contiguous, so a chip's segment of
    list l holds exactly the list-l members that live on that chip.  The
    heavy traffic (posting gathers + candidate GEMM) stays shard-local;
    only the per-chip (B, k) bests cross the interconnect.  The multi-chip form of
    `models/ivf.py` search (reference: ivf_index.rs:143-154 fanned out)."""
    from ..ops import kmeans as KM

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(None, None),
            P(None, None),
            P("data", None, None),
            P("data", None),
            P("data"),
            P("data"),
        ),
        out_specs=(P(None, None), P(None, None)),
    )
    def kernel(q, c, posting_l, base_l, cache_l, n_l):
        _, probe_ids = KM.find_n_nearest(q, c, n_probes, dist)  # (B, p)
        cand = posting_l[0][probe_ids].reshape(q.shape[0], -1)  # local ids
        dd, ii = T.knn_gathered(q, base_l, cand, k, dist, base_cache=cache_l)
        offset = jax.lax.axis_index("data").astype(jnp.int32) * shard
        ii = jnp.where(ii >= 0, ii + offset, -1)
        all_d = jax.lax.all_gather(dd, "data", axis=1).reshape(dd.shape[0], -1)
        all_i = jax.lax.all_gather(ii, "data", axis=1).reshape(dd.shape[0], -1)
        return T.topk_smallest(jnp.where(all_i >= 0, all_d, jnp.inf), all_i, k)

    return kernel(queries, centroids, posting, base, cache, n_local)


class ShardedIVFIndex:
    """IVF sharded over the mesh's data axis (VERDICT r1 item 4).

    Build is the distributed analog of ivf_index.rs:64-107: the coarse
    quantizer trains with k-means++ on a host-drawn sample (replicated),
    then `refine_steps` data-parallel Lloyd steps over the FULL sharded set
    (`kmeans_step_sharded`: local assignment GEMM + psum over the interconnect); row
    assignment runs shard-local under jit, and each chip's posting segments
    are built over its contiguous row shard.  Search = `_sharded_knn_ivf`.
    """

    def __init__(
        self,
        mesh: Mesh,
        base: np.ndarray,
        dist: str,
        config,
        seed: int = 0,
        refine_steps: int = 2,
        centroids: np.ndarray | None = None,
    ):
        from ..models.ivf import DEFAULT_N_PROBES, _build_posting
        from ..ops import kmeans as KM

        D.check_dist(dist)
        self.mesh = mesh
        self.dist = dist
        self.config = config
        self.n, self.dim = base.shape
        self.default_n_probes = DEFAULT_N_PROBES
        self.base, self.cache, self.n_local, self.shard = shard_base(mesh, base, dist)
        n_dev = mesh.devices.size
        repl = NamedSharding(mesh, P(None, None))

        if centroids is None:
            n_train = min(config.k_means_size or self.n, self.n)
            rng = np.random.default_rng(seed)
            sel = (
                rng.choice(self.n, size=n_train, replace=False)
                if n_train < self.n
                else np.arange(self.n)
            )
            cents = KM.kmeans_fit(
                jax.random.PRNGKey(seed),
                jnp.asarray(base[sel]),
                jnp.int32(n_train),
                config.k,
                config.k_means_max_iter,
                config.k_means_tol,
                dist,
            )
            cents = jax.device_put(np.asarray(cents), repl)
            for _ in range(refine_steps):
                cents = kmeans_step_sharded(self.base, self.n_local, cents, dist, mesh)
        else:
            cents = jax.device_put(np.asarray(centroids, np.float32), repl)
        self.centroids = cents

        assign_fn = jax.jit(
            lambda b, c: KM.find_nearest(b, c, dist),
            in_shardings=(NamedSharding(mesh, P("data", None)), repl),
            out_shardings=NamedSharding(mesh, P("data")),
        )
        self._assign = np.asarray(assign_fn(self.base, self.centroids))[: self.n]
        self.posting = self._place_postings()

    def _place_postings(self):
        """Build per-chip posting segments from the host assignment vector
        and place them with a `P("data", ...)` sharding.  A chip's segment
        of list l holds exactly the list-l members living on that chip (the
        row shard is contiguous)."""
        from ..models.ivf import _build_posting

        n_dev = self.mesh.devices.size
        n_loc_h = np.minimum(
            np.maximum(self.n - self.shard * np.arange(n_dev), 0), self.shard
        ).astype(np.int64)
        postings = []
        for c in range(n_dev):
            a = self._assign[c * self.shard : c * self.shard + n_loc_h[c]]
            p, _ = _build_posting(a, self.config.k)
            postings.append(p)
        lmax = max(max(p.shape[1] for p in postings), 1)
        post = np.full((n_dev, self.config.k, lmax), -1, np.int32)
        for c, p in enumerate(postings):
            post[c, :, : p.shape[1]] = p
        return jax.device_put(post, NamedSharding(self.mesh, P("data", None, None)))

    # ---- serde: centroids + the (n,) assignment vector; posting segments
    # are a property of the mesh placement and are rebuilt on load, so a
    # checkpoint re-places onto ANY mesh size ----
    def save(self, path: str, include_vectors: bool = True) -> None:
        from ..utils.serde import save_arrays

        arrays = {
            "centroids": np.asarray(self.centroids),
            "assign": np.asarray(self._assign, np.int32),
        }
        if include_vectors:
            arrays["base"] = np.asarray(self.base)[: self.n]
        save_arrays(path, arrays, dict(
            kind="sharded_ivf", dist=self.dist, n=self.n, dim=self.dim,
            k=self.config.k, k_means_size=self.config.k_means_size,
            k_means_max_iter=self.config.k_means_max_iter,
            k_means_tol=self.config.k_means_tol,
        ))

    @classmethod
    def load(cls, path: str, mesh: Mesh, external_base: np.ndarray | None = None):
        from ..models.ivf import DEFAULT_N_PROBES
        from ..utils.config import IVFConfig

        arrays, meta, base = _load_checkpoint(path, "sharded_ivf", mesh, external_base)
        self = cls.__new__(cls)
        self.mesh = mesh
        self.dist = meta["dist"]
        self.config = IVFConfig(
            k=int(meta["k"]), k_means_size=meta.get("k_means_size"),
            k_means_max_iter=int(meta["k_means_max_iter"]),
            k_means_tol=float(meta["k_means_tol"]),
        )
        self.n, self.dim = base.shape
        self.default_n_probes = DEFAULT_N_PROBES
        self.base, self.cache, self.n_local, self.shard = shard_base(mesh, base, self.dist)
        self.centroids = jax.device_put(
            arrays["centroids"], NamedSharding(mesh, P(None, None))
        )
        self._assign = arrays["assign"]
        self.posting = self._place_postings()
        return self

    def knn_batch(self, queries: np.ndarray, k: int, n_probes: int | None = None):
        q = jnp.asarray(np.atleast_2d(np.asarray(queries, np.float32)))
        n_probes = min(n_probes or self.default_n_probes, self.config.k)
        d, i = _sharded_knn_ivf(
            q, self.centroids, self.posting, self.base, self.cache,
            self.n_local, k, n_probes, self.dist, self.mesh, self.shard,
        )
        return np.asarray(d), np.asarray(i)


@partial(
    jax.jit,
    static_argnames=("k", "ef", "iters", "expand", "ring", "dist", "mesh", "shard"),
)
def _sharded_knn_hnsw(
    queries, vecs, vcache, links0, uppers, entries, n_local,
    k, ef, iters, expand, ring, dist, mesh, shard,
):
    """Sharded HNSW search: per-chip greedy descent + lock-step beam search
    over that chip's sub-graph, then an all-gather top-k merge.

    Each chip owns an independent HNSW graph over its contiguous row shard
    (the multi-index form of "shard N", SURVEY.md section 7.8) — graph
    gathers, frontier distances, and the beam all stay shard-local; only the
    per-chip (B, k) bests cross the interconnect.  Beam distances run on the exact f32
    shard, so the sorted beam head IS the answer (no rerank pass).  Shards
    padded past their `enter_level` carry empty upper levels (pos == -1
    everywhere): the greedy descent sees only -1 links there and holds
    position, so one static level loop serves every shard.
    """
    from ..ops import beam as BM
    from ..models.hnsw import _make_node_dist

    n_levels = len(uppers)
    upper_specs = tuple((P("data", None, None), P("data", None)) for _ in range(n_levels))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(None, None),
            P("data", None, None),
            P("data", None),
            P("data", None, None),
            upper_specs,
            P("data"),
            P("data"),
        ),
        out_specs=(P(None, None), P(None, None)),
    )
    def kernel(q, vecs_l, vcache_l, links0_l, uppers_l, entry_l, n_l):
        vecs_s, vcache_s, links0_s = vecs_l[0], vcache_l[0], links0_l[0]
        q_cache = D.dist_cache(q, dist)
        nd = _make_node_dist(q, q_cache, vecs_s, vcache_s, dist)
        B = q.shape[0]
        cur = jnp.full((B,), jnp.maximum(entry_l[0], 0), jnp.int32)
        for links_l, pos_l in uppers_l:  # highest level first
            links_s, pos_s = links_l[0], pos_l[0]

            def lf(ids, links_s=links_s, pos_s=pos_s):
                rows = pos_s[ids]
                out = links_s[jnp.maximum(rows, 0)]
                return jnp.where((rows >= 0)[..., None], out, -1)

            cur = BM.greedy_descent(cur, nd, lf, 256)
        bd, bi = BM.beam_search(cur, nd, lambda ids: links0_s[ids], ef, iters, expand, ring)
        dd, ii = bd[:, :k], bi[:, :k]
        ok = (ii >= 0) & (ii < n_l[0]) & (n_l[0] > 0)
        offset = jax.lax.axis_index("data").astype(jnp.int32) * shard
        dd = jnp.where(ok, dd, jnp.inf)
        ii = jnp.where(ok, ii + offset, -1)
        all_d = jax.lax.all_gather(dd, "data", axis=1).reshape(B, -1)
        all_i = jax.lax.all_gather(ii, "data", axis=1).reshape(B, -1)
        return T.topk_smallest(jnp.where(all_i >= 0, all_d, jnp.inf), all_i, k)

    return kernel(queries, vecs, vcache, links0, uppers, entries, n_local)


class ShardedHNSWIndex:
    """HNSW sharded over the mesh's data axis (VERDICT r1 item 4).

    Build: the base is split into contiguous row shards and an independent
    single-chip HNSW graph is built per shard with the bulk builder
    (models/hnsw.py); per-shard graph arrays are then stacked and placed
    with a `P("data", ...)` sharding so each chip holds exactly its own
    sub-graph.  Search: `_sharded_knn_hnsw`.  Recall semantics match an
    ef-search over each sub-graph merged globally — the multi-index
    decomposition, the standard way graph indices scale past one device
    (the reference scales with rayon threads over ONE graph instead:
    hnsw_index.rs:399-457; shared memory does not survive chip boundaries).
    """

    def __init__(self, mesh: Mesh, base: np.ndarray, dist: str, config, seed: int = 0,
                 progress=None, parallel: bool = True):
        from ..models.hnsw import HNSWIndex

        D.check_dist(dist)
        self.mesh = mesh
        self.dist = dist
        self.config = config
        self.seed = seed  # saved: deterministic rebuild on a different mesh
        self.n, self.dim = base.shape
        n_dev = mesh.devices.size
        self.shard = max(-(-self.n // n_dev), 8)
        devices = list(mesh.devices.flat)

        def build_shard(s: int):
            lo = min(s * self.shard, self.n)
            hi = min(lo + self.shard, self.n)
            # pin each shard's build to its own chip so the N builds overlap
            # (the multi-chip analog of the reference's rayon add_parallel,
            # hnsw_index.rs:399-457; round-2 built shards serially on the
            # default device — an 8-chip mesh built no faster than 1 chip).
            # Per-shard seeds are fixed, so parallel == serial bit-for-bit.
            with jax.default_device(devices[s % len(devices)]):
                return HNSWIndex.build(
                    base[lo:hi], dist, config, seed=seed + s,
                    progress=progress if s == 0 else None,
                )

        if parallel and n_dev > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=n_dev) as ex:
                subs = list(ex.map(build_shard, range(n_dev)))
        else:
            subs = [build_shard(s) for s in range(n_dev)]
        self.default_ef = subs[0].config.default_ef

        cap = max(ix.store.capacity for ix in subs)
        m0 = subs[0].config.max_m0
        m = subs[0].config.m
        vecs = np.zeros((n_dev, cap, self.dim), np.float32)
        links0 = np.full((n_dev, cap, m0), -1, np.int32)
        entries = np.full((n_dev,), -1, np.int32)
        n_local = np.zeros((n_dev,), np.int32)
        for s, ix in enumerate(subs):
            ns = len(ix.store)
            vecs[s, :ns] = ix.store.numpy()
            links0[s, : ix.links0.shape[0]] = ix.links0
            if ix.entry_point is not None:
                entries[s] = ix.entry_point
            n_local[s] = ns
        l_max = max((ix.enter_level or 0) for ix in subs)
        uppers = []
        for level in range(l_max, 0, -1):
            rows = max(max((ix.upper[level - 1].n if level <= (ix.enter_level or 0) else 0) for ix in subs), 1)
            lk = np.full((n_dev, rows, m), -1, np.int32)
            pos = np.full((n_dev, cap), -1, np.int32)
            for s, ix in enumerate(subs):
                if level <= (ix.enter_level or 0):
                    ul = ix.upper[level - 1]
                    lk[s, : ul.n] = ul.links[: ul.n]
                    pos[s, : len(ul.pos)] = ul.pos
            uppers.append((lk, pos))

        self._place(vecs, links0, uppers, entries, n_local)

    def _place(self, vecs, links0, uppers, entries, n_local) -> None:
        """device_put the stacked per-shard arrays with `P("data", ...)`
        shardings so each chip holds exactly its own sub-graph."""
        mesh, dist = self.mesh, self.dist
        n_dev, cap, _ = vecs.shape
        row = NamedSharding(mesh, P("data", None, None))
        vec1 = NamedSharding(mesh, P("data", None))
        dev1 = NamedSharding(mesh, P("data"))
        self.vecs = jax.device_put(vecs, row)
        self.vcache = jax.jit(
            lambda x: D.dist_cache(x.reshape(-1, self.dim), dist).reshape(n_dev, cap),
            in_shardings=row,
            out_shardings=vec1,
        )(self.vecs)
        self.links0 = jax.device_put(np.ascontiguousarray(links0), row)
        self.uppers = tuple(
            (jax.device_put(np.ascontiguousarray(lk), row),
             jax.device_put(np.ascontiguousarray(pos), vec1))
            for lk, pos in uppers
        )
        self.entries = jax.device_put(np.ascontiguousarray(entries), dev1)
        self.n_local = jax.device_put(np.ascontiguousarray(n_local), dev1)

    # ---- serde (VERDICT r3 item 3: sharded indexes must save/load) ----
    def save(self, path: str, include_vectors: bool = True) -> None:
        """One npz holding the stacked per-shard topology (+ vectors unless
        the base is stored externally — the reference's external-vec-set
        shape, index_algorithm/mod.rs:143-148)."""
        from ..utils.serde import save_arrays

        arrays = {
            "links0": np.asarray(self.links0),
            "entries": np.asarray(self.entries),
            "n_local": np.asarray(self.n_local),
        }
        for lvl, (lk, pos) in enumerate(self.uppers):
            arrays[f"upper_links_{lvl}"] = np.asarray(lk)
            arrays[f"upper_pos_{lvl}"] = np.asarray(pos)
        if include_vectors:
            arrays["vecs"] = np.asarray(self.vecs)
        meta = dict(
            kind="sharded_hnsw", dist=self.dist, n=self.n, dim=self.dim,
            shard=self.shard, n_dev=int(self.mesh.devices.size),
            cap=int(self.links0.shape[1]), n_uppers=len(self.uppers),
            default_ef=self.default_ef,
            ef_construction=self.config.ef_construction, M=self.config.M,
            seed=int(getattr(self, "seed", 0)),
        )
        save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path: str, mesh: Mesh, external_base: np.ndarray | None = None) -> "ShardedHNSWIndex":
        """Re-place a saved sharded index on `mesh`.  The mesh must have the
        same device count the index was saved with (the topology is
        per-shard); pass `external_base` (the original (n, dim) rows) for
        files saved with include_vectors=False."""
        from ..utils.config import HNSWConfig
        from ..utils.serde import load_arrays

        arrays, meta = load_arrays(path)
        if meta.get("kind") != "sharded_hnsw":
            raise ValueError(f"{path} is not a sharded HNSW checkpoint")
        n_dev = int(meta["n_dev"])
        if mesh.devices.size != n_dev:
            # A saved K-chip index must still open on an M-chip mesh
            # (VERDICT r3 item 6).  Per-shard graph topology cannot be
            # re-split, so rebuild deterministically from the rows (same
            # config + per-shard seeds -> same graphs the original build
            # would produce on this mesh).
            import warnings

            n = int(meta["n"])
            dim = int(meta["dim"])
            shard = int(meta["shard"])
            if "vecs" in arrays:
                stacked = arrays["vecs"]  # (n_dev, cap, dim)
                base = np.zeros((n, dim), np.float32)
                for s in range(n_dev):
                    lo = min(s * shard, n)
                    hi = min(lo + shard, n)
                    base[lo:hi] = stacked[s, : hi - lo]
            elif external_base is not None:
                base = np.asarray(external_base, np.float32)[:n]
            else:
                raise ValueError(
                    f"checkpoint was sharded over {n_dev} devices; the mesh "
                    f"has {mesh.devices.size}, and no vectors are available "
                    "to rebuild from (pass external_base)"
                )
            from ..utils.config import HNSWConfig as _HC

            warnings.warn(
                f"sharded HNSW checkpoint ({n_dev} devices) opened on a "
                f"{mesh.devices.size}-device mesh: rebuilding per-shard "
                "graphs from rows (topology is per-shard and cannot be "
                "re-split)",
                stacklevel=2,
            )
            cfg = _HC(ef_construction=int(meta["ef_construction"]),
                      M=int(meta["M"]))
            rebuilt = cls(mesh, base, meta["dist"], cfg,
                          seed=int(meta.get("seed", 0)))
            # carry every persisted config field, not just the build knobs:
            # knn_batch on the rebuilt index must use the SAVED default_ef,
            # not the class default re-derived from ef_construction
            # (ADVICE r4 #4)
            rebuilt.default_ef = int(meta["default_ef"])
            return rebuilt
        self = cls.__new__(cls)
        self.mesh = mesh
        self.dist = meta["dist"]
        self.n = int(meta["n"])
        self.dim = int(meta["dim"])
        self.shard = int(meta["shard"])
        self.default_ef = int(meta["default_ef"])
        self.config = HNSWConfig(
            ef_construction=int(meta["ef_construction"]), M=int(meta["M"])
        )
        cap = int(meta["cap"])
        if "vecs" in arrays:
            vecs = arrays["vecs"]
        else:
            if external_base is None:
                raise ValueError(
                    f"{path} was saved without vectors; pass external_base"
                )
            vecs = np.zeros((n_dev, cap, self.dim), np.float32)
            for s in range(n_dev):
                lo = min(s * self.shard, self.n)
                hi = min(lo + self.shard, self.n)
                vecs[s, : hi - lo] = external_base[lo:hi]
        uppers = [
            (arrays[f"upper_links_{lvl}"], arrays[f"upper_pos_{lvl}"])
            for lvl in range(int(meta["n_uppers"]))
        ]
        self._place(vecs, arrays["links0"], uppers, arrays["entries"], arrays["n_local"])
        return self

    def knn_with_ef_batch(self, queries: np.ndarray, k: int, ef: int, expand: int | None = None):
        from ..models.hnsw import BEAM_EXPAND, _pow2

        q = jnp.asarray(np.atleast_2d(np.asarray(queries, np.float32)))
        ef = max(ef, k)
        expand = expand or BEAM_EXPAND
        iters = (2 * ef + 64 + expand - 1) // expand + 16
        ring = _pow2(min(2 * ef + 64, 4 * ef))
        d, i = _sharded_knn_hnsw(
            q, self.vecs, self.vcache, self.links0, self.uppers, self.entries,
            self.n_local, k, ef, iters, expand, ring, self.dist, self.mesh, self.shard,
        )
        return np.asarray(d), np.asarray(i)

    def knn_batch(self, queries: np.ndarray, k: int):
        return self.knn_with_ef_batch(queries, k, self.default_ef)


@partial(jax.jit, static_argnames=("dist", "mesh"))
def kmeans_step_sharded(data, n_local, centroids, dist, mesh):
    """One Lloyd step, data-parallel over the mesh: local assignment GEMM +
    psum of partial centroid sums/counts over the interconnect."""
    k, dim = centroids.shape

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data", None), P("data"), P(None, None)),
        out_specs=P(None, None),
    )
    def kernel(data_l, n_l, c):
        n_pad = data_l.shape[0]
        valid = jnp.arange(n_pad) < n_l[0]
        d = D.pairwise(data_l, c, dist)
        a = jnp.argmin(d, axis=1)
        w = jnp.where(valid, 1.0, 0.0)
        counts = jnp.zeros((k,), jnp.float32).at[a].add(w)
        sums = jnp.zeros((k, dim), jnp.float32).at[a].add(
            jnp.where(valid[:, None], data_l, 0.0)
        )
        counts = jax.lax.psum(counts, "data")
        sums = jax.lax.psum(sums, "data")
        return jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0), c)

    return kernel(data, n_local, centroids)
