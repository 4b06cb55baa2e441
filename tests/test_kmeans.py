"""K-means tests (mirrors reference src/distance/k_means.rs:203-277)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lab_1806_vec_db.ops import kmeans as KM


def test_tiny_two_clusters():
    # two obvious clusters (k_means.rs:204-220)
    data = np.array(
        [[0.0, 0.0], [1.0, 0.0], [-1.0, -2.0], [-2.0, -1.0]], dtype=np.float32
    )
    c = KM.kmeans_fit(
        jax.random.PRNGKey(42), jnp.asarray(data), jnp.int32(4), 2, 20, 1e-6, "l2sqr"
    )
    c = np.asarray(c)
    assert c.shape == (2, 2)
    # the two centroids must be the two cluster means, in some order
    means = {(0.5, 0.0), (-1.5, -1.5)}
    got = {tuple(np.round(row, 4)) for row in c}
    assert got == means


def test_u8_range_data():
    # u8-origin data incl. near-255 values (k_means.rs:223-239); training is
    # f32 on device, so no overflow concern — just shape/validity
    data = np.array([[0, 0], [1, 0], [255, 254], [255, 255]], dtype=np.uint8)
    c = KM.kmeans_fit(
        jax.random.PRNGKey(42),
        jnp.asarray(data.astype(np.float32)),
        jnp.int32(4),
        2,
        20,
        1e-6,
        "l2sqr",
    )
    c = np.asarray(c)
    assert c.shape == (2, 2)
    assert np.isfinite(c).all()


def test_centroid_fixed_point(gist_1000):
    """Nearest centroid of a centroid is itself (k_means.rs:269-274)."""
    data = gist_1000[:400, :5].copy()
    c = KM.kmeans_fit(
        jax.random.PRNGKey(42), jnp.asarray(data), jnp.int32(400), 3, 20, 1e-6, "l2sqr"
    )
    near = np.asarray(KM.find_nearest(c, c, "l2sqr"))
    assert list(near) == [0, 1, 2]


def test_find_n_nearest_sorted(gist_1000):
    data = gist_1000[:200, :8].copy()
    c = KM.kmeans_fit(
        jax.random.PRNGKey(0), jnp.asarray(data), jnp.int32(200), 8, 20, 1e-6, "l2sqr"
    )
    d, ids = KM.find_n_nearest(jnp.asarray(data[:5]), c, 4, "l2sqr")
    d = np.asarray(d)
    assert (np.diff(d, axis=1) >= 0).all()


def test_padding_rows_ignored():
    data = np.zeros((8, 2), np.float32)
    data[:4] = [[0, 0], [1, 0], [10, 10], [11, 10]]
    data[4:] = 99.0  # padding garbage beyond n_valid
    c = KM.kmeans_fit(
        jax.random.PRNGKey(1), jnp.asarray(data), jnp.int32(4), 2, 20, 1e-6, "l2sqr"
    )
    c = np.asarray(c)
    assert c.max() < 12.0  # padding rows must not leak into centroids
