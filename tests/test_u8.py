"""First-class u8 compute: exact distances, k-means overflow guard, storage.

Mirrors the reference's u8 coverage: scalar/dot semantics
(src/distance/mod.rs:79-95), the u8 k-means overflow-guard test
(src/distance/k_means.rs:222-240), the centroid fixed-point property
(:269-274), and the raw binary round trip (src/vec_set.rs:296-343 /
scalar.rs:89-105).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lab_1806_vec_db.models import FlatIndexU8, U8VecSet
from lab_1806_vec_db.ops import u8 as U8


def _oracle_l2(a, b):
    af = a.astype(np.int64)
    bf = b.astype(np.int64)
    return ((af[:, None, :] - bf[None, :, :]) ** 2).sum(-1)


def _oracle_cos(a, b):
    af = a.astype(np.float64)
    bf = b.astype(np.float64)
    dots = af @ bf.T
    na = np.linalg.norm(af, axis=1)
    nb = np.linalg.norm(bf, axis=1)
    return 1.0 - dots / np.maximum(na[:, None] * nb[None, :], 1e-10)


def test_pairwise_u8_exact_l2(rng):
    # full-range values including 255: the int8-centering + rank-1
    # correction must reproduce the integer distances EXACTLY
    a = rng.integers(0, 256, size=(33, 960)).astype(np.uint8)
    b = rng.integers(0, 256, size=(17, 960)).astype(np.uint8)
    d = np.asarray(U8.pairwise_u8(jnp.asarray(a), jnp.asarray(b), "l2sqr"))
    np.testing.assert_array_equal(d.astype(np.int64), _oracle_l2(a, b))


def test_pairwise_u8_cosine(rng):
    a = rng.integers(1, 256, size=(9, 64)).astype(np.uint8)
    b = rng.integers(1, 256, size=(7, 64)).astype(np.uint8)
    d = np.asarray(U8.pairwise_u8(jnp.asarray(a), jnp.asarray(b), "cosine"))
    np.testing.assert_allclose(d, _oracle_cos(a, b), atol=1e-5)


def test_knn_scan_u8_oracle(rng):
    base = rng.integers(0, 256, size=(500, 96)).astype(np.uint8)
    queries = base[:20]  # self-queries must return themselves at distance 0
    idx = FlatIndexU8.from_numpy(base, "l2sqr")
    d, i = idx.knn_batch(queries, 5)
    assert (i[:, 0] == np.arange(20)).all()
    np.testing.assert_array_equal(d[:, 0], 0.0)
    # full oracle: sorted ascending, ids match argsort of exact distances
    od = _oracle_l2(queries, base)
    gt = np.argsort(od, axis=1, kind="stable")[:, :5]
    gt_d = np.take_along_axis(od, gt, axis=1)
    np.testing.assert_array_equal(d.astype(np.int64), gt_d)


def test_kmeans_u8_overflow_guard():
    # the reference's guard set (k_means.rs:222-240): values at the top of
    # the u8 range — u8 accumulation would wrap, f32 sums must not
    data = np.array([[0, 0], [1, 0], [255, 254], [255, 255]], np.uint8)
    c = U8.kmeans_fit_u8(
        jax.random.PRNGKey(42), jnp.asarray(data), jnp.int32(4), 2, 20, 1e-6, "l2sqr"
    )
    c = np.asarray(c)
    assert c.dtype == np.uint8 and c.shape == (2, 2)
    # one centroid near {0,0}, the other near {255,254.5} (trunc-toward-zero)
    c_sorted = c[np.argsort(c[:, 0])]
    assert (c_sorted[0] <= 1).all()
    assert (c_sorted[1] >= 254).all()


def test_kmeans_u8_centroid_fixed_point(rng):
    # "the nearest centroid of a centroid is itself" (k_means.rs:269-274)
    data = rng.integers(0, 256, size=(200, 16)).astype(np.uint8)
    c = U8.kmeans_fit_u8(
        jax.random.PRNGKey(42), jnp.asarray(data), jnp.int32(200), 3, 20, 1e-6, "l2sqr"
    )
    near = np.asarray(U8.find_nearest_u8(c, c, "l2sqr"))
    np.testing.assert_array_equal(near, np.arange(3))


def test_u8_store_mutation_and_raw_roundtrip(tmp_path, rng):
    vs = U8VecSet(8, "l2sqr")
    rows = rng.integers(0, 256, size=(5, 8)).astype(np.uint8)
    ids = vs.batch_push(rows)
    assert ids == [0, 1, 2, 3, 4] and len(vs) == 5
    np.testing.assert_array_equal(vs[3], rows[3])
    # swap_remove moves the last row into the hole (vec_set.rs:131-137)
    vs.swap_remove(1)
    assert len(vs) == 4
    np.testing.assert_array_equal(vs[1], rows[4])
    # dtype conversion is f32-mediated and lossless for u8
    np.testing.assert_array_equal(vs.to_f32()[0], rows[0].astype(np.float32))
    # raw byte round trip (scalar.rs:89-105)
    p = str(tmp_path / "u8.bin")
    vs.save_raw(p)
    back = U8VecSet.load_raw(p, 8)
    np.testing.assert_array_equal(back.numpy(), vs.numpy())


def test_u8_rejects_wrong_dtype(rng):
    with pytest.raises(ValueError, match="uint8"):
        U8VecSet.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    idx = FlatIndexU8.from_numpy(rng.integers(0, 256, (10, 4)).astype(np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        idx.knn_batch(np.zeros((1, 4), np.float32), 3)


def test_db_uint8_table(tmp_path):
    """DB-layer u8: a uint8 table stores bytes, searches exactly, survives
    a save/load round trip, and refuses float-only features."""
    from lab_1806_vec_db import VecDB

    db = VecDB(str(tmp_path / "db"))
    db.create_table_if_not_exists("bytes", 4, "l2sqr", data_type="uint8")
    db.add("bytes", [0, 0, 0, 0], {"name": "zero"})
    db.add("bytes", [255, 255, 255, 255], {"name": "max"})
    db.add("bytes", [200.7, 200.7, 200.7, 200.7], {"name": "trunc"})  # -> 200

    hits = db.search("bytes", [255, 255, 255, 255], 1)
    assert hits[0][0]["name"] == "max" and hits[0][1] == 0.0
    # `as u8` truncation: 200.7 -> 200, so distance from [201]*4 is 4
    hits = db.search("bytes", [201, 201, 201, 201], 1)
    assert hits[0][0]["name"] == "trunc" and hits[0][1] == 4.0

    with pytest.raises(RuntimeError, match="float32"):
        db.build_hnsw_index("bytes")
    with pytest.raises(RuntimeError, match="float32"):
        db.build_pq_table("bytes")

    db.force_save()
    db.close()
    db2 = VecDB(str(tmp_path / "db"))
    hits = db2.search("bytes", [0, 0, 0, 0], 1)
    assert hits[0][0]["name"] == "zero" and hits[0][1] == 0.0
    db2.close()
