"""Flat index tests (mirrors reference src/index_algorithm/flat_index.rs:117-170
plus a NumPy exact oracle for the blocked GEMM scan)."""

import os

import numpy as np
import pytest

from lab_1806_vec_db.models import FlatIndex
from lab_1806_vec_db.ops import distance as D


def numpy_knn(base, query, k, dist):
    if dist == "l2sqr":
        d = ((base - query[None, :]) ** 2).sum(axis=1)
    else:
        dots = base @ query
        denom = np.maximum(np.linalg.norm(base, axis=1) * np.linalg.norm(query), 1e-10)
        d = 1.0 - dots / denom
    order = np.lexsort((np.arange(len(d)), d))
    return order[:k]


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_self_query(dist, gist_1000):
    vecs = gist_1000[:100, :32].copy()
    index = FlatIndex.from_numpy(vecs, dist)
    res = index.knn(vecs[41], 6)
    assert res[0].index == 41
    assert res[0].distance < 1e-4
    ds = [p.distance for p in res]
    assert ds == sorted(ds)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_oracle_parity(dist, gist_1000, rng):
    vecs = gist_1000[:300, :48].copy()
    index = FlatIndex.from_numpy(vecs, dist)
    queries = gist_1000[300:310, :48].copy()
    d, i = index.knn_batch(queries, 5)
    for qi in range(len(queries)):
        expect = numpy_knn(vecs, queries[qi], 5, dist)
        assert list(i[qi]) == list(expect)


def test_blocked_scan_matches_single_tile(gist_1000):
    """The blocked running-top-k path must agree with the one-GEMM path."""
    from lab_1806_vec_db.ops import topk as T
    import jax.numpy as jnp

    vecs = gist_1000[:512, :64]
    queries = gist_1000[512:520, :64]
    vdev = jnp.asarray(vecs)
    cache = D.dist_cache(vdev, "l2sqr")
    d1, i1 = T.knn_scan(jnp.asarray(queries), vdev, cache, jnp.int32(500), 10, "l2sqr")
    d2, i2 = T.knn_scan(
        jnp.asarray(queries), vdev, cache, jnp.int32(500), 10, "l2sqr", block=128
    )
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5, atol=1e-5)


def test_k_exceeds_n():
    vecs = np.eye(4, dtype=np.float32)
    index = FlatIndex.from_numpy(vecs, "l2sqr")
    res = index.knn(vecs[0], 10)
    assert len(res) == 4


def test_serde_roundtrip(tmp_path, gist_1000):
    vecs = gist_1000[:50, :16].copy()
    index = FlatIndex.from_numpy(vecs, "cosine")
    p = tmp_path / "flat.npz"
    index.save(str(p))
    loaded = FlatIndex.load(str(p))
    assert len(loaded) == 50
    r1 = index.knn(vecs[3], 4)
    r2 = loaded.knn(vecs[3], 4)
    assert [p_.index for p_ in r1] == [p_.index for p_ in r2]


def test_serde_external_vectors(tmp_path, gist_1000):
    """Index-without-vectors checkpoint shape (flat_index.rs:72-83)."""
    vecs = gist_1000[:50, :16].copy()
    index = FlatIndex.from_numpy(vecs, "l2sqr")
    p = tmp_path / "flat_novec.npz"
    index.save(str(p), include_vectors=False)
    loaded = FlatIndex.load(str(p), external_vectors=vecs)
    assert len(loaded) == 50
    assert loaded.knn(vecs[7], 1)[0].index == 7


def test_add_and_swap_remove(gist_1000):
    vecs = gist_1000[:20, :8].copy()
    index = FlatIndex.from_numpy(vecs, "l2sqr")
    index.add(gist_1000[20, :8])
    assert len(index) == 21
    assert index.knn(gist_1000[20, :8], 1)[0].index == 20
    index.store.swap_remove(0)  # last row moves into slot 0
    assert len(index) == 20
    assert index.knn(gist_1000[20, :8], 1)[0].index == 0


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_two_stage_int8_matches_exact(dist, gist_1000):
    """The int8-selection + exact-rerank path (models/flat.py:_knn_device)
    must agree with the exact f32 scan at high recall, with exact distances
    for whatever it returns."""
    rng = np.random.default_rng(0)
    vecs = np.vstack([gist_1000[:, :64]] * 3) + rng.standard_normal(
        (3000, 64)
    ).astype(np.float32) * 1e-3
    queries = gist_1000[:32, :64].copy()
    index = FlatIndex.from_numpy(vecs.astype(np.float32), dist)

    d_ex, i_ex = index.knn_batch(queries, 10, exact=True)
    d_2s, i_2s = index.knn_batch(queries, 10, exact=False)
    recall = np.mean(
        [len(set(i_ex[i]) & set(i_2s[i])) / 10 for i in range(len(queries))]
    )
    assert recall >= 0.9
    # two-stage distances are exact f32 for the ids it returns
    for b in (0, 7, 31):
        for j in range(10):
            idx = i_2s[b, j]
            if idx < 0:
                continue
            expect = d_ex[b][i_ex[b] == idx]
            if len(expect):
                np.testing.assert_allclose(d_2s[b, j], expect[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_device_int8_lane_padding(dist):
    """The int8 mirror is zero-padded to a 128-multiple width; scans over it
    must agree with scans over an unpadded quantization (zeros are
    dot-transparent), and incremental row sync must preserve the width."""
    import jax.numpy as jnp
    from lab_1806_vec_db.ops import topk as T

    rng = np.random.default_rng(1)
    dim = 60  # pads to 128
    vecs = rng.standard_normal((600, dim)).astype(np.float32)
    index = FlatIndex.from_numpy(vecs, dist)
    b8, scales, cache, perm = index.store.device_int8()
    perm_h = np.asarray(perm)
    inv = index.store._scan_inv
    assert b8.shape[1] == 128
    # the mirror is scan-permuted: row inv[i] holds original row i
    q8_ref, sc_ref = T.quantize_rows_int8(jnp.asarray(vecs))
    rows = inv[:600]
    sc_exp = np.asarray(sc_ref)
    if dist == "cosine":  # unified channels fold the norm into the factor
        sc_exp = sc_exp / np.maximum(np.linalg.norm(vecs, axis=1), 1e-20)
    np.testing.assert_allclose(np.asarray(scales)[rows], sc_exp, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(b8)[rows][:, :dim], np.asarray(q8_ref))
    assert (np.asarray(b8)[rows][:, dim:] == 0).all()

    queries = vecs[:16]
    cap = b8.shape[0]
    bd, bi = T.scan_candidates_int8(
        jnp.asarray(queries), b8, scales, cache, jnp.int32(cap), 10, dist
    )
    bi = np.asarray(T.decode_perm(bi, perm, jnp.int32(600)))
    # self-query: row itself must be among the candidates
    assert all(i in bi[i] for i in range(16))
    # decoded ids are all valid rows
    assert ((bi >= -1) & (bi < 600)).all()

    # incremental sync keeps the padded width and scans still work
    index.store.push(vecs[0] * 2.0)
    b8b, scalesb, cacheb, permb = index.store.device_int8()
    assert b8b.shape[1] == 128
    assert (np.asarray(b8b)[inv[600]][dim:] == 0).all()
    bd2, bi2 = T.scan_candidates_int8(
        jnp.asarray(vecs[:1] * 2.0), b8b, scalesb, cacheb, jnp.int32(cap), 5, dist
    )
    bi2 = np.asarray(T.decode_perm(bi2, permb, jnp.int32(601)))
    assert 600 in bi2[0]


def test_dense_cluster_fallback_to_exact():
    """Datasets whose neighbor gaps are tiny relative to vector magnitudes
    (dense clusters far from the origin) defeat int8 ordering at ANY rerank
    depth; the store's quantization self-test must detect this and route
    the search to the exact f32 scan."""
    import jax.numpy as jnp
    from lab_1806_vec_db.models import flat as flat_mod

    rng = np.random.default_rng(7)
    n_clusters, per, dim = 24, 1024, 48
    centers = 6.0 * rng.standard_normal((n_clusters, dim)).astype(np.float32)
    # contiguous clusters: rows [c*per, (c+1)*per) all belong to cluster c
    base = np.repeat(centers, per, axis=0) + 0.5 * rng.standard_normal(
        (n_clusters * per, dim)
    ).astype(np.float32)
    queries = centers[rng.integers(0, n_clusters, 32)] + 0.5 * rng.standard_normal(
        (32, dim)
    ).astype(np.float32)

    index = FlatIndex.from_numpy(base, "l2sqr")
    _, gt = index.knn_batch(queries, 10, exact=True)
    # force the two-stage int8 path (below _EXACT_BELOW it would use exact)
    old = flat_mod._EXACT_BELOW
    flat_mod._EXACT_BELOW = 0
    try:
        _, ids = index.knn_batch(queries, 10)
    finally:
        flat_mod._EXACT_BELOW = old
    recall = np.mean([len(set(gt[q]) & set(ids[q])) / 10 for q in range(32)])
    assert recall >= 0.95


def test_sorted_ingest_scan_permutation():
    """Cluster-SORTED storage order must not degrade the chunk-min scan
    kernel: the int8 mirror's fixed permutation de-clusters storage,
    otherwise the kernel keeps one survivor per 128 contiguous rows and a
    query's co-located true neighbors annihilate each other."""
    import jax.numpy as jnp
    from lab_1806_vec_db.ops import scan_triton as ST
    from lab_1806_vec_db.ops import topk as T

    rng = np.random.default_rng(3)
    # healthy gaps (centers near origin, noise comparable): int8 is fine,
    # the failure mode under test is purely the chunk-min survivor cap
    n_clusters, per, dim = 8, 1024, 64
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    base = np.repeat(centers, per, axis=0) + 0.35 * rng.standard_normal(
        (n_clusters * per, dim)
    ).astype(np.float32)
    queries = centers[rng.integers(0, n_clusters, 16)] + 0.35 * rng.standard_normal(
        (16, dim)
    ).astype(np.float32)

    index = FlatIndex.from_numpy(base, "l2sqr")
    assert index.store.int8_reliable()
    _, gt = index.knn_batch(queries, 10, exact=True)

    b8, sc, c8, perm = index.store.device_int8()
    _, cand = ST.scan_candidates_int8(
        jnp.asarray(queries), b8, sc, c8, 40, "l2sqr", interpret=True
    )
    cand = np.asarray(T.decode_perm(cand, perm, jnp.int32(len(base))))
    surv = np.mean([len(set(gt[q]) & set(cand[q])) / 10 for q in range(16)])
    assert surv >= 0.9  # true top-10 survive the chunk-min + top-r


def test_cosine_obtuse_query_with_sentinels():
    """A cosine query roughly OPPOSITE the data (all true distances > 1.0)
    must still return the true neighbors: the permuted mirror's invalid-row
    sentinels must lose to real rows across the whole [0, 2] cosine range
    (regression: a d=1.0 sentinel once outranked every obtuse neighbor)."""
    import jax.numpy as jnp
    from lab_1806_vec_db.models import flat as flat_mod

    rng = np.random.default_rng(11)
    dim = 48
    center = rng.standard_normal(dim).astype(np.float32)
    center /= np.linalg.norm(center)
    base = (center[None, :] + 0.05 * rng.standard_normal((9000, dim))).astype(
        np.float32
    )
    queries = (-center[None, :] + 0.05 * rng.standard_normal((8, dim))).astype(
        np.float32
    )
    index = FlatIndex.from_numpy(base, "cosine")
    d_gt, gt = index.knn_batch(queries, 10, exact=True)
    assert (d_gt[np.isfinite(d_gt)] > 1.0).all()  # genuinely obtuse regime

    old = flat_mod._EXACT_BELOW
    flat_mod._EXACT_BELOW = 0
    try:
        d, ids = index.knn_batch(queries, 10)
    finally:
        flat_mod._EXACT_BELOW = old
    assert (np.asarray(ids) >= 0).all()  # results exist (no all-sentinel wipeout)
    recall = np.mean([len(set(gt[q]) & set(ids[q])) / 10 for q in range(8)])
    assert recall >= 0.9
