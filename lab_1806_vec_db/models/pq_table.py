"""PQ table: trained codebooks + encoded vector set (ADC sidecar).

Parity target: `PQTable` (reference: src/distance/pq_table.rs:110-238).
Like the reference, the PQ table is a *sidecar* that lives next to an index
and accelerates its distance function (metadata_vec_table.rs:17); it is not
an index itself.

Device design: training is an m-way vmapped k-means (one batched kernel for all
subspaces — the reference trains groups serially, pq_table.rs:154-171);
encoding is a blocked distance-GEMM + argmin; the ADC scan is a blocked
lookup gather-accumulate (`ops/pq.py`).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import pq as P
from ..ops import topk as T
from ..utils.config import PQConfig
from ..utils import serde

_ENCODE_BLOCK = 131072


class PQTable:
    def __init__(
        self,
        config: PQConfig,
        dim: int,
        codebooks: np.ndarray,  # (m, k, dsub_max) f32
        codes: np.ndarray,  # (N, m) uint8 (unpacked)
        rotation: np.ndarray | None = None,  # (dim, dim) orthogonal
        center: np.ndarray | None = None,  # (dim,) training-sample mean
        adc_quality: float | None = None,  # build-time self-test overlap@10
    ):
        self.config = config
        self.dim = int(dim)
        self.k = 1 << config.n_bits
        self.codebooks = np.asarray(codebooks, dtype=np.float32)
        self.codes = np.asarray(codes, dtype=np.uint8)
        self.rotation = None if rotation is None else np.asarray(rotation, np.float32)
        self.center = None if center is None else np.asarray(center, np.float32)
        self.adc_quality = adc_quality
        idx, mask, dsub_max = P.group_gather_indices(dim, config.m)
        self._gidx = idx
        self._gmask = mask
        self.dsub_max = dsub_max
        # device caches
        self._dev_codes: jax.Array | None = None
        self._dev_codebooks: jax.Array | None = None
        self._dev_cb_sqnorm: jax.Array | None = None
        self._dev_rotation: jax.Array | None = None
        self._dev_center: jax.Array | None = None

    # ---- distance-preserving input transform (config.rotate) ----
    @staticmethod
    def _make_rotation(dim: int, seed: int) -> np.ndarray:
        """Seeded random orthogonal matrix (QR of a Gaussian), f32."""
        rng = np.random.default_rng(seed ^ 0x5EED_07A7)
        q, r = np.linalg.qr(rng.standard_normal((dim, dim)))
        # fix the sign convention so the factorization is deterministic
        q *= np.sign(np.diagonal(r))
        return q.astype(np.float32)

    def _transform_dev(self, x: jax.Array) -> jax.Array:
        """Apply the training-space transform on device.  For L2Sqr the
        center shift is distance-transparent (d(x-c, y-c) = d(x, y)); the
        rotation preserves both L2 and cosine exactly, so ADC distances in
        the transformed space ARE original-space distances."""
        x = x.astype(jnp.float32)
        if self.rotation is None:
            return x
        if self._dev_rotation is None:
            self._dev_rotation = jnp.asarray(self.rotation)
            self._dev_center = (
                None if self.center is None else jnp.asarray(self.center)
            )
        if self._dev_center is not None:
            x = x - self._dev_center
        return jnp.matmul(
            x, self._dev_rotation, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    # ---- training (pq_table.rs:141-191) ----
    @classmethod
    def train(
        cls,
        vectors: np.ndarray,
        config: PQConfig,
        seed: int = 0,
        n_valid: int | None = None,
    ) -> "PQTable":
        if config.n_bits not in (4, 8):
            raise ValueError("n_bits must be 4 or 8")
        # `vectors` may be a host array OR a device array (device-born
        # ingest, models/store.py:from_device): in the device case the
        # training sample is gathered on device and only the (N, m) uint8
        # codes ever cross the host boundary — no base download/re-upload.
        # `n_valid` restricts training + encoding to the first n_valid rows
        # WITHOUT slicing (a [:n] slice of a capacity-padded device array
        # materializes a second multi-GB copy);
        # rows past n_valid are capacity padding, never sampled or encoded.
        on_device = isinstance(vectors, jax.Array) and not isinstance(vectors, np.ndarray)
        n, dim = vectors.shape
        if n_valid is not None:
            if not (0 < n_valid <= n):
                raise ValueError(f"n_valid {n_valid} out of range (0, {n}]")
            n = n_valid
        if not (1 <= config.m <= dim):
            raise ValueError("m must be in 1..=dim")
        k = 1 << config.n_bits
        rng = np.random.default_rng(seed)
        if config.k_means_size is not None and config.k_means_size < n:
            # random_sample without replacement (vec_set.rs:154-163)
            sel = rng.choice(n, size=config.k_means_size, replace=False)
            train_vecs = (
                jnp.take(vectors, jnp.asarray(np.sort(sel)), axis=0)
                if on_device
                else vectors[sel]
            )
        elif n < vectors.shape[0]:
            train_vecs = (
                jax.lax.slice_in_dim(vectors, 0, n, axis=0)
                if on_device
                else vectors[:n]
            )
        else:
            train_vecs = vectors
        idx, mask, _ = P.group_gather_indices(dim, config.m)
        idx_j = jnp.asarray(idx)
        mask_j = jnp.asarray(mask)
        if on_device:
            train_dev = train_vecs.astype(jnp.float32)
        else:
            train_dev = jnp.asarray(np.ascontiguousarray(train_vecs, dtype=np.float32))

        rotation = center = None
        if config.rotate:
            rotation = cls._make_rotation(dim, seed)
            rot_dev = jnp.asarray(rotation)
            if config.dist == "l2sqr":
                # centering is L2-transparent but NOT cosine-transparent
                center_dev = jnp.mean(train_dev, axis=0)
                center = np.asarray(center_dev)
                train_dev = train_dev - center_dev
            train_dev = jnp.matmul(
                train_dev, rot_dev, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )

        grouped = P.regroup(train_dev, idx_j, mask_j)
        key = jax.random.PRNGKey(seed)
        codebooks = P.train_codebooks(
            key,
            grouped,
            jnp.int32(train_dev.shape[0]),
            k,
            config.k_means_max_iter,
            config.k_means_tol,
            config.dist,
        )
        codebooks = np.asarray(jax.device_get(codebooks))

        table = cls(config, dim, codebooks, np.empty((0, config.m), np.uint8),
                    rotation=rotation, center=center)

        # encode the full set in blocks
        cb_dev = jnp.asarray(codebooks)
        codes = np.empty((n, config.m), dtype=np.uint8)
        for s in range(0, n, _ENCODE_BLOCK):
            e = min(s + _ENCODE_BLOCK, n)
            if on_device:
                blk = jax.lax.slice_in_dim(vectors, s, e, axis=0).astype(jnp.float32)
            else:
                blk = jnp.asarray(np.ascontiguousarray(vectors[s:e], dtype=np.float32))
            blk = table._transform_dev(blk)
            grouped_blk = P.regroup(blk, idx_j, mask_j)
            codes[s:e] = np.asarray(
                jax.device_get(P.encode(grouped_blk, cb_dev, config.dist))
            )
        table.codes = codes

        # build-time ADC self-test (VERDICT r2 item 6): the int8 scan mirror
        # has one (store.int8_reliable), PQ gets the same discipline — on
        # datasets whose neighbor gaps are tiny vs vector magnitudes the
        # quantized ordering can collapse SILENTLY (measured recall 0.15 at
        # 1M on the raw Gist-spectrum synthetic); measure it at build time
        # so search routes can warn / prefer exact-reranked plans.
        table.adc_quality = table._self_test(train_dev, grouped, cb_dev)
        if table.adc_quality < 0.5:
            import warnings

            warnings.warn(
                f"PQ ADC ordering self-test scored {table.adc_quality:.3f} "
                "overlap@10 on the training sample — quantized ordering is "
                "unreliable on this data (try rotate=True, more bits, or an "
                "exact-reranked route)",
                stacklevel=2,
            )
        return table

    def _self_test(self, train_t: jax.Array, grouped: jax.Array, cb_dev: jax.Array,
                   n_q: int = 256, n_base: int = 8192, k: int = 10) -> float:
        """Overlap@k of ADC ordering vs exact ordering on the (transformed)
        training sample.  Pure device math; returns a float in [0, 1]."""
        from ..ops import distance as D
        from ..ops import topk as T

        s = min(train_t.shape[0], n_base)
        base_t = jax.lax.slice_in_dim(train_t, 0, s, axis=0)
        q_t = base_t[:: max(1, s // n_q)][:n_q]
        codes_s = P.encode(
            jax.lax.slice_in_dim(grouped, 0, s, axis=1), cb_dev, self.config.dist
        )
        gi, gm = jnp.asarray(self._gidx), jnp.asarray(self._gmask)
        lookup = P.build_lookup(P.regroup(q_t, gi, gm), cb_dev, self.config.dist)
        if self.config.dist == "cosine":
            q_norms = jnp.sqrt(jnp.sum(q_t * q_t, axis=-1))
        else:
            q_norms = jnp.zeros(q_t.shape[0], jnp.float32)
        cb_sq = P.centroid_sqnorm_cache(cb_dev)
        kk = min(k, s)
        _, adc_ids = P.adc_scan(
            lookup, codes_s, jnp.int32(s), cb_sq, q_norms, kk, self.config.dist
        )
        cache = D.dist_cache(base_t, self.config.dist)
        _, ex_ids = T.knn_scan(q_t, base_t, cache, jnp.int32(s), kk, self.config.dist)
        a, e = np.asarray(adc_ids), np.asarray(ex_ids)
        overlap = np.mean(
            [len(set(a[i]) & set(e[i])) / kk for i in range(a.shape[0])]
        )
        return float(overlap)

    def __len__(self) -> int:
        return self.codes.shape[0]

    def device_bytes(self) -> int:
        """Device-memory footprint of the PQ sidecar (packed codes + codebooks
        + caches + rotation)."""
        total = 0
        for a in (
            self._dev_codes, self._dev_codebooks, self._dev_cb_sqnorm,
            self._dev_rotation, self._dev_center,
        ):
            if a is not None:
                total += int(a.nbytes)
        return total

    def warn_if_unreliable(self, context: str, threshold: float = 0.5) -> bool:
        """Loud fallback check for ADC-ordered search plans: returns True
        (and warns) when the build-time self-test said quantized ordering
        collapsed on this table's data.  Callers on exact-reranked plans
        need not care; plans whose CANDIDATE ordering is ADC do."""
        if self.adc_quality is not None and self.adc_quality < threshold:
            import warnings

            warnings.warn(
                f"{context}: PQ ADC self-test overlap@10 = "
                f"{self.adc_quality:.3f} (< {threshold}); quantized ordering "
                "is unreliable on this data — results may have very low "
                "recall.  Retrain with rotate=True / n_bits=8, or use an "
                "exact-reranked route.",
                stacklevel=3,
            )
            return True
        return False

    @property
    def packed(self) -> bool:
        """4-bit tables keep their DEVICE codes nibble-packed (two codes per
        byte, the reference's in-memory layout pq_table.rs:66-91) — half the
        device memory for the n_bits=4 configs.  Consumers unpack on device
        (`adc_scan`, `unpack_rows`)."""
        return self.config.n_bits == 4

    # ---- device views ----
    def device(self):
        if self._dev_codes is None:
            if self.packed:
                self._dev_codes = jnp.asarray(P.pack_codes_4bit(self.codes))
            else:
                self._dev_codes = jnp.asarray(self.codes)
            self._dev_codebooks = jnp.asarray(self.codebooks)
            self._dev_cb_sqnorm = P.centroid_sqnorm_cache(self._dev_codebooks)
        return self._dev_codes, self._dev_codebooks, self._dev_cb_sqnorm

    def unpack_rows(self, rows: jax.Array) -> jax.Array:
        """Unpack gathered device code rows to (…, m) int codes."""
        if self.packed:
            return P.unpack_codes_4bit_dev(rows, self.config.m)
        return rows

    def create_lookup(self, queries: jax.Array):
        """(B, dim) queries -> ((B, m, k) lookup, (B,) query norms).

        Parity: `PQTable::create_lookup` (pq_table.rs:195-224).
        """
        _, cb, _ = self.device()
        # rotated tables transform the query into the training space first
        # (distance-preserving, see _transform_dev) — lookup entries remain
        # original-space partial distances
        q = self._transform_dev(queries)
        qg = P.regroup(q, jnp.asarray(self._gidx), jnp.asarray(self._gmask))
        lookup = P.build_lookup(qg, cb, self.config.dist)
        if self.config.dist == "cosine":
            q_norms = jnp.sqrt(jnp.sum(q * q, axis=-1))
        else:
            q_norms = jnp.zeros(q.shape[0], jnp.float32)
        return lookup, q_norms

    def adc_scan(self, lookup, q_norms, k_out: int):
        """Full ADC scan over the encoded set -> (B, k_out) dists/ids
        (ops/pq.py adc_scan: blocked LUT gather-accumulate + running top-k;
        4-bit codes are unpacked on device first)."""
        codes, _, cb_sq = self.device()
        if self.packed:
            codes = P.unpack_codes_4bit_dev(codes, self.config.m)
        return P.adc_scan(
            lookup, codes, jnp.int32(len(self)), cb_sq, q_norms, k_out, self.config.dist
        )

    def adc_for_ids(self, lookup, q_norms, ids: jax.Array):
        """ADC distances for (B, C) candidate ids (HNSW+PQ traversal)."""
        codes, _, cb_sq = self.device()
        c = self.unpack_rows(codes[jnp.maximum(ids, 0)])  # (B, C, m)
        d = P.adc_lookup_codes(c, lookup, cb_sq, self.config.dist, q_norms)
        return jnp.where(ids >= 0, d, jnp.inf)

    # ---- serde (pq_table.rs:226-238; our format is npz) ----
    def state(self) -> tuple[dict[str, np.ndarray], dict]:
        if self.config.n_bits == 4:
            stored = P.pack_codes_4bit(self.codes)
        else:
            stored = self.codes
        arrays = {"pq_codebooks": self.codebooks, "pq_codes": stored}
        if self.rotation is not None:
            arrays["pq_rotation"] = self.rotation
        if self.center is not None:
            arrays["pq_center"] = self.center
        meta = {
            "pq": {
                "n_bits": self.config.n_bits,
                "m": self.config.m,
                "dist": self.config.dist,
                "k_means_size": self.config.k_means_size,
                "k_means_max_iter": self.config.k_means_max_iter,
                "k_means_tol": self.config.k_means_tol,
                "dim": self.dim,
                "rotate": self.config.rotate,
                "adc_quality": self.adc_quality,
            }
        }
        return arrays, meta

    @classmethod
    def from_state(cls, arrays: dict[str, np.ndarray], meta: dict) -> "PQTable":
        m = meta["pq"]
        config = PQConfig(
            n_bits=m["n_bits"],
            m=m["m"],
            dist=m["dist"],
            k_means_size=m["k_means_size"],
            k_means_max_iter=m["k_means_max_iter"],
            k_means_tol=m["k_means_tol"],
            rotate=bool(m.get("rotate", False)),
        )
        codes = arrays["pq_codes"]
        if config.n_bits == 4:
            codes = P.unpack_codes_4bit(codes, config.m)
        return cls(
            config, m["dim"], arrays["pq_codebooks"], codes,
            rotation=arrays.get("pq_rotation"),
            center=arrays.get("pq_center"),
            adc_quality=m.get("adc_quality"),
        )

    def save(self, path) -> None:
        arrays, meta = self.state()
        serde.save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path) -> "PQTable":
        arrays, meta = serde.load_arrays(path)
        return cls.from_state(arrays, meta)
