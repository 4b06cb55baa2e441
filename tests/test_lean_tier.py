"""Memory-lean store tier: block ingest builds only the int8 scan mirror +
reduced-precision rerank slab (no f32 device copy).  The two-stage flat
scan and the binned IVF path must still deliver high recall vs the exact
full-tier oracle; f32 accessors and mutation must be refused."""

import numpy as np
import jax.numpy as jnp
import pytest

from lab_1806_vec_db.models import FlatIndex, IVFIndex
from lab_1806_vec_db.models.store import VecStore
from lab_1806_vec_db.utils.config import IVFConfig


def _clustered(n, dim, n_q, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, dim)).astype(np.float32)
    base = (0.3 * rng.standard_normal((n, dim)) + centers[rng.integers(0, 16, n)]).astype(np.float32)
    qs = (0.3 * rng.standard_normal((n_q, dim)) + centers[rng.integers(0, 16, n_q)]).astype(np.float32)
    return base, qs


def _recall(gt, ids, k):
    return np.mean([len(set(gt[i][:k]) & set(ids[i][:k])) / k for i in range(len(gt))])


def test_lean_flat_two_stage_recall():
    N, dim, k = 6000, 64, 10
    base, qs = _clustered(N, dim, 16)
    _, gt = FlatIndex.from_numpy(base, "l2sqr").knn_batch(qs, k, exact=True)

    def fill(row0, rows):
        return jnp.asarray(base[row0 : row0 + rows])

    store = VecStore.from_device_blocks(fill, N, dim, "l2sqr", block_rows=2048)
    assert store.tier == "lean"
    assert len(store) == N
    flat = FlatIndex.from_store(store)
    d, ids = flat.knn_batch(qs, k)
    assert _recall(gt, ids, k) >= 0.9
    # slab-precision distances: ascending, close to exact
    assert (np.diff(d, axis=1) >= -1e-4).all()


def test_lean_refuses_f32_and_mutation():
    N, dim = 600, 32
    base, _ = _clustered(N, dim, 2)

    def fill(row0, rows):
        return jnp.asarray(base[row0 : row0 + rows])

    store = VecStore.from_device_blocks(fill, N, dim, "l2sqr", block_rows=256)
    for fn in (
        store.device,
        lambda: store.push(np.zeros(dim, np.float32)),
        lambda: store.swap_remove(0),
        lambda: store.random_sample(4, np.random.default_rng(0)),
        store.state_arrays,
    ):
        with pytest.raises(RuntimeError, match="lean"):
            fn()
    # lean accessors still work
    q8, scale, cache, perm = store.device_int8()
    assert q8.dtype == jnp.int8
    assert store.device_rerank().dtype == jnp.bfloat16
    assert isinstance(store.int8_reliable(), bool)


def test_lean_binned_ivf_recall():
    N, dim, k = 6000, 64, 10
    base, qs = _clustered(N, dim, 16, seed=3)
    _, gt = FlatIndex.from_numpy(base, "l2sqr").knn_batch(qs, k, exact=True)

    def fill(row0, rows):
        return jnp.asarray(base[row0 : row0 + rows])

    idx = IVFIndex.from_device_blocks(
        fill, N, dim, "l2sqr", IVFConfig(k=16), seed=0, block_rows=2048
    )
    assert idx.store.tier == "lean"
    qp = jnp.asarray(np.pad(qs, ((0, 0), (0, 0))))
    d, ids = idx._knn_device_binned(qp, k, 4)
    assert _recall(gt, np.asarray(ids), k) >= 0.85


def test_sorted_mirror_matches_scan_mirror():
    """mirror="sorted" (ingest-time cluster-sorted layout, the >2M-rows
    scale path) must produce the same binned search results as the default
    scan-layout mode: same blocks -> same int8 rows and same sorted layout,
    so the whole pipeline is value-identical."""
    N, dim, k = 6000, 64, 10
    base, qs = _clustered(N, dim, 16, seed=5)

    def fill(row0, rows):
        return jnp.asarray(base[row0 : row0 + rows])

    kw = dict(seed=0, block_rows=2048)
    idx_scan = IVFIndex.from_device_blocks(
        fill, N, dim, "l2sqr", IVFConfig(k=16), **kw
    )
    idx_sorted = IVFIndex.from_device_blocks(
        fill, N, dim, "l2sqr", IVFConfig(k=16), mirror="sorted", **kw
    )
    assert idx_sorted.store._mirror_layout == "sorted"
    assert np.array_equal(idx_scan.posting, idx_sorted.posting)

    qp = jnp.asarray(qs)
    d1, i1 = idx_scan._knn_device_binned(qp, k, 4)
    d2, i2 = idx_sorted._knn_device_binned(qp, k, 4)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=0, atol=0)

    # the full scan is statistically broken on a sorted layout: refused
    # at CONSTRUCTION (fail-fast, close to the cause)
    with pytest.raises(ValueError, match="sorted"):
        FlatIndex.from_store(idx_sorted.store)


def test_lean_exact_distance_refinement():
    """The reference's contract is exact returned distances
    (hnsw_index.rs:624-633).  With the block generator retained (default),
    lean-tier scan results refine to exact f32; with keep_fill=False the
    slab's precision is advertised instead."""
    N, dim, k = 4000, 64, 10
    base, qs = _clustered(N, dim, 12, seed=3)

    def fill(row0, rows):
        return jnp.asarray(base[row0 : row0 + rows])

    store = VecStore.from_device_blocks(fill, N, dim, "l2sqr", block_rows=1024)
    assert store.distance_precision == "f32"
    flat = FlatIndex.from_store(store)
    d, ids = flat.knn_batch(qs, k)
    true = ((base[ids] - qs[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d, true, rtol=1e-5, atol=1e-5)  # EXACT f32
    assert (np.diff(d, axis=1) >= -1e-6).all()

    store2 = VecStore.from_device_blocks(
        fill, N, dim, "l2sqr", block_rows=1024, keep_fill=False
    )
    assert store2.distance_precision == "bfloat16"
    d2, ids2 = FlatIndex.from_store(store2).knn_batch(qs, k)
    # slab-grade: close but NOT exact in general
    np.testing.assert_allclose(
        d2, ((base[ids2] - qs[:, None, :]) ** 2).sum(-1), rtol=2e-2, atol=1e-2
    )


def test_lean_exact_rows_gather():
    N, dim = 3000, 32
    base, _ = _clustered(N, dim, 2, seed=5)

    def fill(row0, rows):
        return jnp.asarray(base[row0 : row0 + rows])

    store = VecStore.from_device_blocks(fill, N, dim, "l2sqr", block_rows=512)
    ids = np.array([0, 511, 512, 2999, 7, -1])
    rows = np.asarray(store.exact_rows(ids))
    np.testing.assert_allclose(rows[:5], base[ids[:5]], rtol=1e-6)
    np.testing.assert_array_equal(rows[5], np.zeros(dim, np.float32))


def test_lean_hnsw_graph_route_exact_distances(tmp_path):
    """Lean-tier HNSW graph route: the beam walks the bf16 rows, and the
    returned distances are exact f32 for the returned ids when the block
    generator is retained.  The topology is built on a full-tier copy and
    loaded over the lean store (the external-store pairing)."""
    from lab_1806_vec_db.models import HNSWIndex
    from lab_1806_vec_db.utils.config import HNSWConfig

    N, dim, k = 2500, 48, 5
    base, qs = _clustered(N, dim, 6, seed=9)

    def fill(row0, rows):
        return jnp.asarray(base[row0 : row0 + rows])

    built = HNSWIndex.build(base, "l2sqr", HNSWConfig(), seed=0)
    built.save(tmp_path / "topo", include_vectors=False)
    store = VecStore.from_device_blocks(fill, N, dim, "l2sqr", block_rows=640)
    lean = HNSWIndex.load(tmp_path / "topo", external_store=store)
    d, ids = lean.knn_with_ef_batch(qs, k, ef=N, route="graph")
    true = ((base[ids] - qs[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d, true, rtol=1e-5, atol=1e-5)
    gt = np.argsort(((base[None] - qs[:, None]) ** 2).sum(-1), axis=1)[:, :k]
    assert _recall(gt, ids, k) >= 0.9
