"""Padded device-resident vector storage.

The device re-design of `VecSet<T>` (reference: src/vec_set.rs:15-203):
- canonical storage is a host numpy array with geometric capacity growth
  (push/batch_push/swap_remove, mirroring vec_set.rs:116-137)
- the device view is a fixed-capacity `(cap, dim)` float32 array plus the
  per-row distance cache (`dist_cache`, reference src/distance/mod.rs:31-36),
  padded rows zeroed, refreshed *incrementally*: small writes are applied as
  device scatters instead of re-uploading the whole set, so XLA keeps static
  shapes while N changes on the host side.

Capacity changes (growth) trigger one full re-upload and a recompile of the
downstream jitted kernels — amortized by doubling.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import distance as D
from ..ops import topk as T

_MIN_CAP = 8


from functools import partial as _partial


@_partial(
    jax.jit,
    static_argnames=("dist", "flags"),
    donate_argnums=(0, 1, 2, 3, 4),
)
def _sync_rows_jit(dev, cache, bf16, int8triple, projtriple, rows, vals, rows_scan, valid8, validp, projmat, projmu, dist, flags):
    """Scatter `vals` into row `rows` of every live device mirror in ONE
    dispatch, with donated (in-place) buffers.

    The int8 scan mirror is PERMUTED (see device_int8): its scatter rows are
    `rows_scan` = scan_inv[rows], and rows no longer valid (`valid8` False,
    e.g. the vacated tail of a swap_remove) are written as losing sentinels
    rather than data."""
    has_bf16, has_int8, has_proj = flags
    dev = dev.at[rows].set(vals)
    cache = cache.at[rows].set(D.dist_cache(vals, dist))
    if has_bf16:
        bf16 = bf16.at[rows].set(vals.astype(jnp.bfloat16))
    if has_int8:
        q8, sc, cp = int8triple
        v8 = vals
        if q8.shape[1] != v8.shape[1]:
            v8 = jnp.pad(v8, ((0, 0), (0, q8.shape[1] - v8.shape[1])))
        q8v, scv = T.quantize_rows_int8(v8)
        cpv = D.dist_cache(vals, dist)
        if dist == "cosine":  # unified channels: scale s/|x|, cache 0
            scv = scv / jnp.maximum(cpv, 1e-20)
            cpv = jnp.zeros_like(cpv)
        scv = jnp.where(valid8, scv, 0.0)
        cpv = jnp.where(valid8, cpv, jnp.float32(T.BIG))
        int8triple = (
            q8.at[rows_scan].set(q8v),
            sc.at[rows_scan].set(scv),
            cp.at[rows_scan].set(cpv),
        )
    if has_proj:
        from ..ops import project as PJ

        p8, psc, pca = projtriple
        p8v, pscv, pcav = PJ.project_quantize(vals, projmat, projmu, dist)
        # invalid rows (vacated swap_remove tail) carry the losing additive
        # sentinel: the chunk-min scans have no positional masking
        pscv = jnp.where(validp, pscv, 0.0)
        pcav = jnp.where(validp, pcav, jnp.float32(T.BIG))
        projtriple = (
            p8.at[rows].set(p8v),
            psc.at[rows].set(pscv),
            pca.at[rows].set(pcav),
        )
    return dev, cache, bf16, int8triple, projtriple


def _round_cap(n: int) -> int:
    cap = _MIN_CAP
    while cap < n:
        cap *= 2
    return cap


# ---- chunked on-device mirror builders (device-born data path) ----
# When the canonical data is born ON the device (from_device ingest — e.g.
# the bench's jax.random dataset, or an embedding pipeline's output), the
# derived mirrors are built device-side in bounded row blocks: one whole-set
# pad/quantize materializes multi-GB transients next to the live mirrors,
# and round-tripping through the host copies the set twice.  Blocked
# dynamic_update_slice into a donated buffer keeps the transient to one
# block.

_BLOCK_ROWS = 65536


@_partial(jax.jit, static_argnames=("dist",))
def _refine_dist_jit(q, rows, dist):
    """Exact f32 distances of a gathered (B, k, dim) row block vs (B, dim)
    queries (the lean tier's final-result refinement)."""
    q = q.astype(jnp.float32)
    rows = rows.astype(jnp.float32)
    if dist == "l2sqr":
        diff = rows - q[:, None, :]
        return jnp.sum(diff * diff, axis=-1)
    dots = jnp.einsum("bd,bkd->bk", q, rows, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    qn = jnp.sqrt(jnp.sum(q * q, axis=-1))[:, None]
    rn = jnp.sqrt(jnp.sum(rows * rows, axis=-1))
    return 1.0 - dots / jnp.maximum(qn * rn, 1e-30)


@_partial(jax.jit, static_argnames=("dist",), donate_argnums=(1, 2, 3, 4, 5))
def _lean_block_jit(v, q8, scale, cache_ch, rows_bf16, cache, inv_rows, row0, dist):
    """Fold one f32 block into the lean-tier arrays (all donated):
    quantize + channel-fold + scatter into the PERMUTED int8 mirror, and
    write the bf16 rows and exact dist cache (original-id order)."""
    rows, dim = v.shape
    dim_pad = q8.shape[1]
    vp = v if dim_pad == dim else jnp.pad(v, ((0, 0), (0, dim_pad - dim)))
    q8v, scv = T.quantize_rows_int8(vp)
    cx = D.dist_cache(v, dist)
    cpv = cx
    if dist == "cosine":  # unified channels: scale s/|x|, cache 0
        scv = scv / jnp.maximum(cpv, 1e-20)
        cpv = jnp.zeros_like(cpv)
    q8 = q8.at[inv_rows].set(q8v)
    scale = scale.at[inv_rows].set(scv)
    cache_ch = cache_ch.at[inv_rows].set(cpv)
    rows_bf16 = jax.lax.dynamic_update_slice(
        rows_bf16, v.astype(rows_bf16.dtype), (row0, 0)
    )
    cache = jax.lax.dynamic_update_slice(cache, cx, (row0,))
    return q8, scale, cache_ch, rows_bf16, cache


@_partial(jax.jit, static_argnames=("dim_pad", "rows"), donate_argnums=(1, 2))
def _int8_block_jit(vecs, q8, scale, row0, dim_pad, rows):
    dim = vecs.shape[1]
    v = jax.lax.dynamic_slice(vecs, (row0, 0), (rows, dim)).astype(jnp.float32)
    if dim_pad != dim:
        v = jnp.pad(v, ((0, 0), (0, dim_pad - dim)))
    q8v, scv = T.quantize_rows_int8(v)
    return (
        jax.lax.dynamic_update_slice(q8, q8v, (row0, 0)),
        jax.lax.dynamic_update_slice(scale, scv, (row0,)),
    )


@jax.jit
def _bound_mask_jit(scale, cache, perm, bound):
    """Re-mask the int8 mirror's channel vectors for a moving scan bound:
    rows whose ORIGINAL id >= bound get the losing additive sentinel (same
    convention as the baked perm<n validity)."""
    ok = perm < bound
    return jnp.where(ok, scale, 0.0), jnp.where(ok, cache, jnp.float32(T.BIG))


class VecStore:
    def __init__(self, dim: int, dist: str, capacity: int = 0, dtype=np.float32):
        D.check_dist(dist)
        self.dim = int(dim)
        self.dist = dist
        self.dtype = np.dtype(dtype)
        self._n = 0
        self._cap = _round_cap(max(capacity, _MIN_CAP))
        self._data = np.zeros((self._cap, dim), dtype=self.dtype)
        # device state
        self._dev: jax.Array | None = None
        self._dev_cache: jax.Array | None = None
        self._dev_bf16: jax.Array | None = None
        self._dev_int8: tuple | None = None
        self._scan_perm: np.ndarray | None = None  # fixed scan shuffle
        self._scan_inv: np.ndarray | None = None
        self._int8_ok: tuple[bool, int] | None = None  # (verdict, n at test)
        # rows >= this bound are written as INVALID into the int8 scan
        # mirror (HNSW bulk build excludes the in-flight chunk this way)
        self._scan_bound: int | None = None
        # (d_red, proj (dim, d_red), mu (dim,), (q8p, scale_p, cache_p))
        self._dev_proj: tuple | None = None
        self._dirty_rows: set[int] = set()
        self._dev_full_dirty = True

    # Lean-tier exact-row source: retained block generator (class default
    # so every construction path — __init__, from_device, from_numpy,
    # from_device_blocks(keep_fill=False) — reads None without setup).
    _fill = None
    _fill_block_rows = 0

    @classmethod
    def from_device(cls, vecs: jax.Array, dist: str) -> "VecStore":
        """Ingest an already-device-resident (n, dim) array as the canonical
        data — no host round-trip, no re-upload.  The host copy materializes
        lazily on first host-side access (serde, native search, mutation)."""
        n, dim = vecs.shape
        store = cls.__new__(cls)
        D.check_dist(dist)
        store.dim = int(dim)
        store.dist = dist
        store.dtype = np.dtype(np.float32)
        store._n = int(n)
        # static ingest: round capacity to the mirror-builder block (a
        # 16384-multiple keeps every kernel tile alignment) instead of the
        # next power of two — at n=1e6 the pow2 cap wastes 4.9% of every
        # scan on zero rows.  Later growth re-rounds to pow2 as usual.
        store._cap = (
            -(-int(n) // 16384) * 16384 if n >= 65536 else _round_cap(max(n, _MIN_CAP))
        )
        store._data = None  # lazy host mirror
        vecs = vecs.astype(jnp.float32)
        if store._cap != n:
            buf = jnp.zeros((store._cap, store.dim), jnp.float32)
            vecs = jax.lax.dynamic_update_slice(buf, vecs, (0, 0))
        store._dev = vecs
        store._dev_cache = D.dist_cache(vecs, dist)
        store._dev_bf16 = None
        store._dev_int8 = None
        store._scan_perm = None
        store._scan_inv = None
        store._int8_ok = None
        store._scan_bound = None
        store._dev_proj = None
        store._dirty_rows = set()
        store._dev_full_dirty = False
        jax.block_until_ready(store._dev_cache)
        return store

    @property
    def tier(self) -> str:
        """"full" (f32 canonical on device + derived mirrors) or "lean"
        (int8 scan mirror + reduced-precision rows ONLY — see
        `from_device_blocks`)."""
        return getattr(self, "_tier", "full")

    def _require_full(self, what: str):
        if self.tier == "lean":
            raise RuntimeError(
                f"{what} requires the full store tier; this store was "
                "ingested with from_device_blocks (lean tier: int8 scan "
                "mirror + reduced-precision rows, no f32 copy)"
            )

    @classmethod
    def from_device_blocks(
        cls,
        fill,
        n: int,
        dim: int,
        dist: str,
        rerank_dtype=jnp.bfloat16,
        block_rows: int = 131072,
        assign_fn=None,
        perm: "np.ndarray | None" = None,
        cap: int | None = None,
        keep_fill: bool = True,
    ) -> "VecStore":
        """Memory-LEAN ingest for datasets whose f32 form exceeds device
        memory: stream `fill(row0, rows) -> (rows, dim) f32 device block`
        (deterministic generator or host uploader), build ONLY the permuted
        int8 scan mirror, a reduced-precision (default bf16) copy of the
        rows and their exact dist cache, and discard each f32 block.
        Device cost per row: ~1 B/dim (int8) + 2 B/dim (bf16) instead of
        the full tier's ~7 B/dim (f32 + int8 + bf16).  Where the tiers
        cross over on one card awaits measurement.

        The lean store serves the two-stage scan (stage-1 int8 + rerank on
        the bf16 rows: distances are bf16-grade, ~1e-2 relative, until
        refined) and the binned IVF path; exact-f32 accessors, mutation,
        and serde raise RuntimeError.

        `assign_fn(v, row0)` is an optional per-block callback (e.g. IVF
        cluster assignment) run on each f32 block before it is discarded.

        `perm`/`cap` inject a CUSTOM mirror layout: `perm[slot] = original
        id` (a permutation of `cap >= n` rows; slots of ids >= n are never
        written and keep the losing sentinel).  The binned-IVF scale path
        uses this to lay the mirror out in cluster-sorted posting order AT
        INGEST (`IVFIndex.from_device_blocks(mirror="sorted")`), which
        removes the double-residency gather `_device_sorted` would
        otherwise need.
        A custom layout breaks the full scan's chunk-min survivor statistics
        (it assumes a random permutation), so the store records
        `_mirror_layout = "sorted"` and the flat scan refuses it.
        """
        D.check_dist(dist)
        store = cls.__new__(cls)
        store.dim = int(dim)
        store.dist = dist
        store.dtype = np.dtype(np.float32)
        store._n = int(n)
        store._cap = int(cap) if cap is not None else -(-int(n) // 16384) * 16384
        if store._cap < n:
            raise ValueError(f"cap {store._cap} < n {n}")
        store._tier = "lean"
        store._mirror_layout = "sorted" if perm is not None else "scan"
        store._data = None
        store._dev = None
        store._dev_cache = None
        store._dev_bf16 = None
        store._dev_proj = None
        store._scan_bound = None
        store._dirty_rows = set()
        store._dev_full_dirty = False
        cap = store._cap
        if perm is not None:
            perm = np.asarray(perm, dtype=np.int32)
            if perm.shape != (cap,):
                raise ValueError(f"perm shape {perm.shape} != ({cap},)")
            store._scan_perm = perm
        else:
            rng = np.random.default_rng(cap ^ 0x5EED)
            store._scan_perm = rng.permutation(cap).astype(np.int32)
        store._scan_inv = np.empty(cap, np.int32)
        store._scan_inv[store._scan_perm] = np.arange(cap, dtype=np.int32)

        dim_pad = ((dim + 127) // 128) * 128
        q8 = jnp.zeros((cap, dim_pad), jnp.int8)
        scale = jnp.zeros((cap,), jnp.float32)
        cache_ch = jnp.full((cap,), T.BIG, jnp.float32)  # sentinel everywhere
        # the rows are indexed by ORIGINAL id (< n), so they never need the
        # mirror's layout padding (a sorted layout can inflate cap ~1.2x)
        rows_cap = -(-int(n) // 16384) * 16384
        rows_lp = jnp.zeros((rows_cap, dim), rerank_dtype)
        cache = jnp.zeros((rows_cap,), jnp.float32)
        inv_dev = jnp.asarray(store._scan_inv)

        verdict = None
        for row0 in range(0, n, block_rows):
            rows = min(block_rows, n - row0)
            v = fill(row0, rows)
            if verdict is None:
                # int8 ordering self-test on the first block (the lean
                # store can never re-derive it from f32 later)
                m = min(rows, 4096)
                score = T.int8_ordering_selftest(
                    v[:m], jnp.int32(m), jax.random.PRNGKey(0), dist
                )
                verdict = bool(float(score) >= 0.95)
            if assign_fn is not None:
                assign_fn(v, row0)
            inv_rows = jax.lax.dynamic_slice(inv_dev, (row0,), (rows,))
            q8, scale, cache_ch, rows_lp, cache = _lean_block_jit(
                v, q8, scale, cache_ch, rows_lp, cache, inv_rows, row0, dist
            )
            del v
        jax.block_until_ready(q8)
        store._dev_int8 = (q8, scale, cache_ch, jnp.asarray(store._scan_perm))
        store._dev_bf16 = rows_lp
        store._dev_cache = cache
        store._int8_ok = (verdict if verdict is not None else True, max(n, 1))
        if keep_fill:
            # retain the generator: final-result distances can then be
            # refined to exact f32 by regenerating only the blocks that
            # hold candidate rows (exact_rows/refine_distances) — the
            # reference's exact-returned-distance contract
            # (hnsw_index.rs:624-633) at ~zero resident device memory
            store._fill = fill
            store._fill_block_rows = int(block_rows)
        return store

    @property
    def distance_precision(self) -> str:
        """Precision of distances computed against this store's best
        available row source: "f32" when an exact source exists (full tier,
        or a lean tier with its block generator retained), else the lean
        rows' dtype name (e.g. "bfloat16") — selection-grade only."""
        if self.tier != "lean" or self._fill is not None:
            return "f32"
        return str(self._dev_bf16.dtype)

    def exact_rows(self, ids: np.ndarray) -> "jax.Array | None":
        """Exact f32 rows for a small id set, in order.

        Full tier: a device gather.  Lean tier with the block generator
        retained: regenerate ONLY the blocks containing requested ids and
        gather from each before discarding it — a (B, k) result set touches
        at most min(B*k, n/block_rows) blocks, so refinement stays cheap
        even at multi-million N.  Returns None when no exact source exists
        (lean + keep_fill=False).  Negative ids yield zero rows (callers
        mask padding)."""
        ids_h = np.asarray(ids, np.int64).ravel()
        if self.tier != "lean":
            vecs, _ = self.device()
            return vecs[jnp.asarray(np.maximum(ids_h, 0), np.int32)]
        if self._fill is None:
            return None
        br = self._fill_block_rows
        out = jnp.zeros((len(ids_h), self.dim), jnp.float32)
        valid = ids_h >= 0
        for b in np.unique(ids_h[valid] // br):
            row0 = int(b) * br
            rows = min(br, self._n - row0)
            v = self._fill(row0, rows)
            sel = np.nonzero(valid & (ids_h >= row0) & (ids_h < row0 + rows))[0]
            out = out.at[jnp.asarray(sel, np.int32)].set(
                v[jnp.asarray(ids_h[sel] - row0, np.int32)]
            )
            del v
        return out

    def refine_distances(self, queries, ids: np.ndarray) -> "np.ndarray | None":
        """Exact f32 distances d(queries[b], row ids[b, j]) for a final
        (B, k) result set, or None when no exact source exists.  Positions
        with id < 0 come back +inf."""
        ids_h = np.asarray(ids)
        rows = self.exact_rows(ids_h)
        if rows is None:
            return None
        B, k = ids_h.shape
        q = queries if hasattr(queries, "devices") else jnp.asarray(
            np.atleast_2d(np.asarray(queries, np.float32))
        )
        rows = rows.reshape(B, k, self.dim)
        d = _refine_dist_jit(q, rows, self.dist)
        return np.where(ids_h >= 0, np.asarray(d), np.inf)

    def refine_results(self, queries, d, ids):
        """A (B, k) result re-scored with exact f32 distances and re-sorted
        (the reference's exact-returned-distance contract,
        hnsw_index.rs:624-633).  Lean tier: rows come from regenerated
        blocks; without a retained generator the given distances stand and
        `distance_precision` says so.  Returns host arrays."""
        i_h = np.asarray(ids)
        refined = self.refine_distances(queries, i_h)
        if refined is None:
            return np.asarray(d), i_h
        order = np.argsort(refined, axis=1, kind="stable")
        return (
            np.take_along_axis(refined, order, axis=1),
            np.take_along_axis(i_h, order, axis=1),
        )

    def device_bytes(self) -> int:
        """Total bytes of this store's live DEVICE arrays (canonical copy,
        caches, mirrors) — the store half of a sweep row's "index memory"
        (the reference records index size implicitly via its serde files;
        here device residency is the scarce resource)."""
        total = 0

        def add(x):
            nonlocal total
            if x is None:
                return
            if isinstance(x, (tuple, list)):
                for y in x:
                    add(y)
            elif hasattr(x, "nbytes"):
                total += int(x.nbytes)

        add(self._dev)
        add(self._dev_cache)
        add(self._dev_bf16)
        add(self._dev_int8)
        add(self._dev_proj)
        return total

    def free_search_caches(self) -> None:
        """Release EVERY derived device mirror (int8/proj scan mirrors, bf16
        traversal copy), keeping only the canonical rows + dist cache.  All
        of them rebuild lazily on demand; use before a phase with a big
        transient working set.  No-op on the lean tier (there the mirrors
        ARE the data)."""
        if self.tier == "lean":
            return
        self._dev_int8 = None
        self._dev_proj = None
        self._dev_bf16 = None

    def free_scan_mirrors(self) -> None:
        """Release the derived int8/projection scan mirrors (device memory).

        They are caches: any later scan path rebuilds them on demand.  Use
        between phases with different working sets — e.g. after an HNSW
        bulk build (whose candidate scans need the int8 mirror) and before
        batched graph search (which needs the bf16 traversal copy
        instead).  No-op on the lean tier (there they ARE the data)."""
        if self.tier == "lean":
            return
        self._dev_int8 = None
        self._dev_proj = None

    def set_scan_bound(self, bound: int | None) -> None:
        """Treat rows >= `bound` as INVALID in the int8 scan mirror.  Used
        by HNSW bulk build to keep the in-flight chunk out of its own
        candidate scan.  The bound is applied DYNAMICALLY at `device_int8`
        read time (the two (cap,) channel vectors are re-masked on device,
        ~microseconds); the big q8 matrix and its baked perm<n validity
        never change, so moving the bound each chunk costs no host round
        trip and no mirror re-sync."""
        self._scan_bound = bound

    def mark_rows_dirty(self, rows) -> None:
        for r in rows:
            self._mark_dirty(int(r))

    def _scan_valid_n(self) -> int:
        b = self._scan_bound
        return self._n if b is None else min(self._n, b)

    # (validity baked into the int8 mirror is always perm < n; the scan
    # bound is applied dynamically in device_int8 — see set_scan_bound)

    def _host(self) -> np.ndarray:
        """The (cap, dim) host array, materializing it from the device
        mirror on first access for device-born stores."""
        self._require_full("host data access")
        if self._data is None:
            host = np.zeros((self._cap, self.dim), dtype=self.dtype)
            if self._n:
                host[: self._n] = np.asarray(self._dev[: self._n]).astype(self.dtype)
            self._data = host
        return self._data

    # ---- host-side mutation (vec_set.rs push/pop/swap_remove parity) ----
    def __len__(self) -> int:
        return self._n

    @property
    def n(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return self._cap

    def numpy(self) -> np.ndarray:
        """Valid rows as a host array view (n, dim)."""
        return self._host()[: self._n]

    def __getitem__(self, i: int) -> np.ndarray:
        if not (0 <= i < self._n):
            raise IndexError(i)
        return self._host()[i]

    def _grow_to(self, n: int) -> None:
        if n <= self._cap:
            return
        new_cap = _round_cap(n)
        new = np.zeros((new_cap, self.dim), dtype=self.dtype)
        new[: self._n] = self._host()[: self._n]
        self._data = new
        self._cap = new_cap
        self._dev = None
        self._dev_cache = None
        self._dev_full_dirty = True
        self._dirty_rows.clear()

    def push(self, vec) -> int:
        self._require_full("push()")
        vec = np.asarray(vec, dtype=self.dtype).reshape(-1)
        if vec.shape[0] != self.dim:
            raise ValueError(f"Dimension mismatch: {vec.shape[0]} != {self.dim}")
        self._grow_to(self._n + 1)
        idx = self._n
        self._host()[idx] = vec
        self._n += 1
        self._mark_dirty(idx)
        return idx

    def batch_push(self, vecs) -> list[int]:
        self._require_full("batch_push()")
        vecs = np.asarray(vecs, dtype=self.dtype)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"Dimension mismatch: {vecs.shape} vs dim={self.dim}")
        start = self._n
        self._grow_to(self._n + len(vecs))
        self._host()[start : start + len(vecs)] = vecs
        self._n += len(vecs)
        for i in range(start, self._n):
            self._mark_dirty(i)
        return list(range(start, self._n))

    def swap_remove(self, i: int) -> None:
        """Remove row i by moving the last row into it (vec_set.rs:131-137)."""
        self._require_full("swap_remove()")
        if not (0 <= i < self._n):
            raise IndexError(i)
        last = self._n - 1
        data = self._host()
        if i != last:
            data[i] = data[last]
            self._mark_dirty(i)
        data[last] = 0
        self._mark_dirty(last)
        self._n = last

    def _mark_dirty(self, row: int) -> None:
        if self._dev_full_dirty:
            return
        self._dirty_rows.add(row)
        # Full rebuild only when a big fraction changed: a rebuild re-uploads
        # the whole set and invalidates every derived copy (bf16/int8), so
        # incremental row-scatter wins until the dirty set approaches half
        # the data.
        if len(self._dirty_rows) > max(16384, self._cap // 2):
            self._dev_full_dirty = True
            self._dirty_rows.clear()

    # ---- device view ----
    def device(self) -> tuple[jax.Array, jax.Array]:
        """Return (vectors (cap, dim) f32, dist_cache (cap,) f32), synced."""
        self._require_full("device() (the f32 canonical copy)")
        if self._dev is None or self._dev_full_dirty:
            host = np.zeros((self._cap, self.dim), dtype=np.float32)
            host[: self._n] = self._host()[: self._n].astype(np.float32)
            self._dev = jnp.asarray(host)
            self._dev_cache = D.dist_cache(self._dev, self.dist)
            self._dev_bf16 = None
            self._dev_int8 = None
            self._dev_proj = None
            self._int8_ok = None
            self._dev_full_dirty = False
            self._dirty_rows.clear()
            # barrier: let upload staging free before derived copies build
            # (async overlap of the transients raises peak device memory)
            jax.block_until_ready(self._dev_cache)
        elif self._dirty_rows:
            rows = np.fromiter(self._dirty_rows, dtype=np.int32)
            vals = self._host()[rows].astype(np.float32)
            # one fused + donated dispatch: every live device mirror updates
            # in place (eager .at[].set chains copied the full arrays)
            def dummy():
                # distinct buffer per donated slot (same buffer cannot be
                # donated twice in one call)
                return jnp.zeros((0,), jnp.float32)

            flags = (
                self._dev_bf16 is not None,
                self._dev_int8 is not None,
                self._dev_proj is not None,
            )
            proj_mat, proj_mu = (
                (self._dev_proj[1], self._dev_proj[2])
                if flags[2]
                else (dummy(), dummy())
            )
            if flags[1]:
                rows_scan = jnp.asarray(self._scan_inv[rows])
            else:
                rows_scan = jnp.asarray(rows)
            valid8 = jnp.asarray(rows < self._n)
            validp = jnp.asarray(rows < self._n)
            dev, cache, bf16, int8triple, projtriple = _sync_rows_jit(
                self._dev,
                self._dev_cache,
                self._dev_bf16 if flags[0] else dummy(),
                self._dev_int8[:3] if flags[1] else (dummy(), dummy(), dummy()),
                self._dev_proj[3] if flags[2] else (dummy(), dummy(), dummy()),
                jnp.asarray(rows),
                jnp.asarray(vals),
                rows_scan,
                valid8,
                validp,
                proj_mat,
                proj_mu,
                self.dist,
                flags,
            )
            self._dev, self._dev_cache = dev, cache
            if flags[0]:
                self._dev_bf16 = bf16
            if flags[1]:
                self._dev_int8 = (*int8triple, self._dev_int8[3])
            if flags[2]:
                self._dev_proj = (self._dev_proj[0], proj_mat, proj_mu, projtriple)
            self._dirty_rows.clear()
        return self._dev, self._dev_cache

    def device_traversal(self) -> tuple[jax.Array, jax.Array]:
        """Return (vectors (cap, dim) bf16, dist_cache (cap,) f32), synced.

        The bf16 copy exists for graph traversal: beam/greedy search is
        gather-bound, and half-width rows halve the bytes moved.  Distances
        computed from it are approximate (~1e-2 relative); callers must
        rerank final results against `device_rerank()`.  On the lean tier
        the bf16 rows ARE the stored data (with their exact f32 caches).
        """
        if self.tier == "lean":
            return self._dev_bf16, self._dev_cache
        vecs, cache = self.device()
        if self._dev_bf16 is None:
            self._dev_bf16 = vecs.astype(jnp.bfloat16)
            jax.block_until_ready(self._dev_bf16)
        return self._dev_bf16, cache

    def device_rerank(self) -> jax.Array:
        """The (cap, dim) rows the exact rerank reads: the f32 canonical
        copy, synced; on the lean tier its bf16 rows (distances from them
        are bf16-grade until refined, see `refine_distances`)."""
        if self.tier == "lean":
            return self._dev_bf16
        return self.device()[0]

    def device_int8(self) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
        """Return the SCAN-PERMUTED int8 mirror: ((cap, dim_pad) int8 rows,
        (cap,) f32 scales, (cap,) f32 dist-cache, (cap,) int32 perm), all
        synced and cached; mirror row i holds original row perm[i].

        Why permuted: the chunk-min scan keeps one survivor per 128
        consecutive MIRROR rows.  Real ingests often arrive cluster-sorted
        (documents grouped by topic), which would concentrate a query's
        true neighbors into a handful of chunks and collapse stage-1
        recall.  A fixed pseudo-random permutation (seeded by capacity)
        scatters any storage order; callers decode candidate ids through
        `perm` before the exact rerank (see topk.decode_perm).

        Channel convention (unified scan formula, see
        topk.query_channels): scale = s_x (l2sqr) or
        s_x/|x| (cosine); cache = |x|^2 (l2sqr) or 0 (cosine).  Validity is
        carried IN the mirror (no positional n_valid masking is possible
        post-permutation): invalid rows hold scale 0 + cache +BIG — a
        losing additive sentinel for BOTH metrics.  Callers must still drop
        decoded ids >= len(store).

        The int8 copy feeds stage-1 candidate selection on an int8 GEMM
        (half the bytes of bf16); results are always reranked against the
        exact f32 view."""

        if self.tier == "lean":
            return self._dev_int8  # pre-built at ingest, immutable
        vecs, cache = self.device()
        if self._dev_int8 is None:
            if self._scan_perm is None or len(self._scan_perm) != self._cap:
                rng = np.random.default_rng(self._cap ^ 0x5EED)
                self._scan_perm = rng.permutation(self._cap).astype(np.int32)
                self._scan_inv = np.empty(self._cap, np.int32)
                self._scan_inv[self._scan_perm] = np.arange(self._cap, dtype=np.int32)
            perm = self._scan_perm
            dim_pad = ((self.dim + 127) // 128) * 128
            if self._data is None:
                # device-born data: blocked on-device quantize (see note
                # above), then one device gather into permuted order
                rows = _BLOCK_ROWS if self._cap % _BLOCK_ROWS == 0 else 16384
                rows = min(rows, self._cap)
                q8u = jnp.zeros((self._cap, dim_pad), jnp.int8)
                scale_u = jnp.ones((self._cap,), jnp.float32)
                for row0 in range(0, self._cap, rows):
                    q8u, scale_u = _int8_block_jit(vecs, q8u, scale_u, row0, dim_pad, rows)
                perm_dev = jnp.asarray(perm)
                q8 = q8u[perm_dev]
                scale = scale_u[perm_dev]
                del q8u, scale_u
            else:
                # columns padded to a multiple of 128 (the scan kernel's
                # contraction tile); zero columns are dot-transparent and
                # leave per-row scales unchanged.  Quantize on the HOST: a
                # device-side pad+quantize materializes ~3x the f32 mirror
                # in transients.
                x = self._data[: self._n].astype(np.float32)
                amax = np.abs(x).max(axis=1) if self._n else np.zeros((0,), np.float32)
                scale_u = np.ones((self._cap,), np.float32)
                scale_u[: self._n] = np.where(amax > 0, amax / 127.0, 1.0)
                q8u = np.zeros((self._cap, dim_pad), np.int8)
                if self._n:
                    np.clip(
                        np.round(x / scale_u[: self._n, None]), -127, 127,
                        out=x,
                    )
                    q8u[: self._n, : self.dim] = x.astype(np.int8)
                q8 = jnp.asarray(q8u[perm])
                scale = jnp.asarray(scale_u[perm])
                perm_dev = jnp.asarray(perm)
            valid = jnp.asarray(perm < self._n)
            cache_p = cache[perm_dev]  # |x|^2 (l2sqr) / |x| (cosine)
            if self.dist == "cosine":
                scale = scale / jnp.maximum(cache_p, 1e-20)
                cache_p = jnp.zeros_like(cache_p)
            scale = jnp.where(valid, scale, 0.0)
            cache_p = jnp.where(valid, cache_p, jnp.float32(T.BIG))
            self._dev_int8 = (q8, scale, cache_p, perm_dev)
            jax.block_until_ready(self._dev_int8)
        q8, scale, cache_p, perm_dev = self._dev_int8
        b = self._scan_bound
        if b is not None and b < self._n:
            # dynamic re-mask of the channel vectors only (see set_scan_bound)
            scale, cache_p = _bound_mask_jit(scale, cache_p, perm_dev, jnp.int32(b))
        return q8, scale, cache_p, perm_dev

    def device_proj_int8(self, d_red: int):
        """Return (proj (dim, d_red) f32, mu (dim,) f32, q8p (cap, d_red)
        int8, scale_p (cap,) f32, cache_p (cap,) f32): the PCA-projected
        int8 stage-1 mirror (ops/project.py), synced and cached.

        The projection is fit ONCE from the data present at first call and
        then held fixed; subsequent row writes are projected through it
        incrementally.  That is sound because the mirror only orders stage-1
        candidates — the exact f32 rerank downstream is distribution-free.
        A full rebuild (capacity growth / bulk upload) refits.
        """
        from ..ops import project as PJ

        vecs, _ = self.device()  # syncs dirty rows into _dev_proj too
        if self._dev_proj is None or self._dev_proj[0] != d_red:
            proj_h, mu_h = PJ.pca_fit(vecs, self._n, d_red, self.dist)
            proj = jnp.asarray(proj_h)
            mu = jnp.asarray(mu_h)
            q8p, scale_p, cache_p = PJ.project_quantize(vecs, proj, mu, self.dist)
            # rows beyond n carry the losing sentinel (the chunk-min scans
            # have no positional masking — validity is cache-borne)

            validp = jnp.arange(self._cap) < self._n
            triple = (
                q8p,
                jnp.where(validp, scale_p, 0.0),
                jnp.where(validp, cache_p, jnp.float32(T.BIG)),
            )
            jax.block_until_ready(triple)
            self._dev_proj = (d_red, proj, mu, triple)
        _, proj, mu, (q8p, scale_p, cache_p) = self._dev_proj
        return proj, mu, q8p, scale_p, cache_p

    def int8_reliable(self) -> bool:
        """Whether per-row int8 quantization preserves neighbor ORDER on
        this data (ops/topk.int8_ordering_selftest).

        False in the pathological regime (inter-point gaps tiny relative to
        point magnitudes); callers fall back to exact/f32 scans there.
        The verdict is re-evaluated once the row count drifts >= 25% from
        the tested size, so incrementally-ingested regime shifts are caught
        without paying a device round trip on every write.
        """
        if self._int8_ok is not None:
            verdict, n_at = self._int8_ok
            if n_at > 0 and abs(self._n - n_at) <= n_at // 4:
                return verdict
        if self._n < 64:
            self._int8_ok = (True, max(self._n, 1))  # tiny sets: exact path anyway
        else:
            vecs, _ = self.device()
            score = float(
                T.int8_ordering_selftest(
                    vecs, jnp.int32(self._n), jax.random.PRNGKey(0), self.dist
                )
            )
            self._int8_ok = (score >= 0.95, self._n)
            if not self._int8_ok[0]:
                import sys

                print(
                    f"[vecdb] int8 ordering self-test scored {score:.2f}"
                    " (<0.95): neighbor gaps are small relative to vector"
                    " magnitudes, falling back to exact f32 scans",
                    file=sys.stderr,
                )
        return self._int8_ok[0]

    # ---- conversions (vec_set.rs:142-163 parity) ----
    def to_type(self, dtype) -> "VecStore":
        """dtype conversion via f32 mediation (vec_set.rs:142-149)."""
        self._require_full("to_type()")
        out = VecStore(self.dim, self.dist, capacity=self._n, dtype=dtype)
        if self._n:
            out.batch_push(self._host()[: self._n].astype(np.float32).astype(dtype))
        return out

    def random_sample(self, size: int, rng: np.random.Generator) -> np.ndarray:
        """Sample `size` rows without replacement (vec_set.rs:154-163)."""
        self._require_full("random_sample()")
        size = min(size, self._n)
        sel = rng.choice(self._n, size=size, replace=False)
        return self._host()[np.sort(sel)].copy()

    # ---- serde ----
    def state_arrays(self, include_vectors: bool = True) -> dict[str, np.ndarray]:
        self._require_full("serialization")
        out = {}
        if include_vectors:
            out["vectors"] = self._host()[: self._n].copy()
        return out

    @classmethod
    def from_numpy(cls, vectors: np.ndarray, dist: str, dtype=None) -> "VecStore":
        vectors = np.asarray(vectors)
        dtype = dtype or vectors.dtype
        store = cls(vectors.shape[1], dist, capacity=len(vectors), dtype=dtype)
        if len(vectors):
            store.batch_push(vectors)
        return store
