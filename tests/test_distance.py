"""Distance kernel tests (mirrors reference src/distance/mod.rs:131-151)."""

import numpy as np
import jax.numpy as jnp
import pytest

from lab_1806_vec_db.ops import distance as D

EPS = 1e-5


def test_l2sqr_known_value():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([4.0, 5.0, 6.0], np.float32)
    assert abs(D.calc_dist_host(a, b, "l2sqr") - 27.0) < EPS


def test_cosine_known_value():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([2.0, 4.0, 6.0], np.float32)
    assert abs(D.calc_dist_host(a, b, "cosine") - 0.0) < EPS


def test_invalid_dist_raises():
    with pytest.raises(ValueError):
        D.calc_dist_host([1.0], [1.0], "manhattan")


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_pairwise_matches_pointwise(dist, rng):
    q = rng.standard_normal((7, 24)).astype(np.float32)
    b = rng.standard_normal((13, 24)).astype(np.float32)
    full = np.asarray(D.pairwise(jnp.asarray(q), jnp.asarray(b), dist))
    for i in range(7):
        for j in range(13):
            expect = D.calc_dist_host(q[i], b[j], dist)
            # the GEMM identity (a-b)^2 = a^2+b^2-2ab carries f32 relative
            # error ~1e-4 vs the direct form — same trade the reference makes
            # on its cached path (src/distance/mod.rs:54-57)
            assert abs(full[i, j] - expect) < 1e-3 + 5e-4 * abs(expect)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_dist_cache_matches(dist, rng):
    x = rng.standard_normal((5, 16)).astype(np.float32)
    cache = np.asarray(D.dist_cache(jnp.asarray(x), dist))
    for i in range(5):
        if dist == "l2sqr":
            expect = float(np.dot(x[i], x[i]))
        else:
            expect = float(np.linalg.norm(x[i]))
        assert abs(cache[i] - expect) < 1e-4
