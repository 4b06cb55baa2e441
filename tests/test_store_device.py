"""Device-born ingest path (VecStore.from_device + chunked mirror builds)."""

import numpy as np
import jax.numpy as jnp

from lab_1806_vec_db.models import FlatIndex
from lab_1806_vec_db.models import store as store_mod
from lab_1806_vec_db.models.store import VecStore


def _data(n=300, dim=48, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, dim)).astype(np.float32)


def test_from_device_matches_from_numpy():
    x = _data()
    q = _data(8, 48, seed=1)
    a = FlatIndex.from_numpy(x, "l2sqr")
    b = FlatIndex.from_store(VecStore.from_device(jnp.asarray(x), "l2sqr"))
    da, ia = a.knn_batch(q, 5, exact=True)
    db, ib = b.knn_batch(q, 5, exact=True)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, rtol=1e-5)


def test_from_device_lazy_host_and_serde():
    x = _data()
    s = VecStore.from_device(jnp.asarray(x), "cosine")
    assert s._data is None  # host not materialized yet
    np.testing.assert_allclose(s.numpy(), x, rtol=1e-6)
    arrays = s.state_arrays()
    np.testing.assert_allclose(arrays["vectors"], x, rtol=1e-6)


def test_from_device_then_mutate():
    x = _data(100, 32)
    s = VecStore.from_device(jnp.asarray(x), "l2sqr")
    idx = FlatIndex.from_store(s)
    v = _data(1, 32, seed=7)[0]
    s.push(v)
    d, i = idx.knn_batch(v[None, :], 1, exact=True)
    assert i[0][0] == 100 and d[0][0] < 1e-6
    s.swap_remove(0)
    assert len(s) == 100
    np.testing.assert_allclose(s[0], v, rtol=1e-6)


def test_chunked_mirror_builders(monkeypatch):
    # small block size forces the multi-block loop in the device-born builders
    monkeypatch.setattr(store_mod, "_BLOCK_ROWS", 16)
    x = _data(120, 40, seed=3)
    s_dev = VecStore.from_device(jnp.asarray(x), "l2sqr")
    s_host = VecStore.from_numpy(x, "l2sqr")
    q8d, scd, cd, pd = s_dev.device_int8()
    q8h, sch, ch, ph = s_host.device_int8()
    np.testing.assert_array_equal(np.asarray(pd), np.asarray(ph))  # same cap -> same perm
    np.testing.assert_array_equal(np.asarray(q8d), np.asarray(q8h))
    np.testing.assert_allclose(np.asarray(scd), np.asarray(sch), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(cd), np.asarray(ch), rtol=1e-5)
    rd = np.asarray(s_dev.device_rerank())
    rh = np.asarray(s_host.device_rerank())
    np.testing.assert_allclose(rd, rh, rtol=1e-6)


def test_native_single_query_on_device_born_store():
    """native.flat_knn_single must materialize the lazy host mirror."""
    from lab_1806_vec_db.models import native

    x = _data(400, 32, seed=5)
    idx = FlatIndex.from_store(VecStore.from_device(jnp.asarray(x), "l2sqr"))
    res = idx.knn(x[7], 3)  # routes through flat_knn_single when available
    assert res[0].index == 7 and res[0].distance < 1e-6
