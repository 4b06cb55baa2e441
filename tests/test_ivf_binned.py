"""Batched binned IVF search (ops/binning.py + scan_chunkmin_int8_binned)."""

import numpy as np
import jax.numpy as jnp
import pytest

from lab_1806_vec_db.models import FlatIndex, IVFIndex
from lab_1806_vec_db.ops import binning as BN
from lab_1806_vec_db.utils.config import IVFConfig


def test_bin_queries_inverts_probe_map():
    rng = np.random.default_rng(0)
    B, p, nlist, qb = 64, 3, 16, 32
    # distinct lists per query (find_n_nearest returns distinct ids)
    probe = np.stack([rng.choice(nlist, size=p, replace=False) for _ in range(B)]).astype(np.int32)
    bins, slots = BN.bin_queries(jnp.asarray(probe), nlist, qb)
    bins, slots = np.asarray(bins), np.asarray(slots)
    for b in range(B):
        for j in range(p):
            l, s = probe[b, j], slots[b, j]
            assert s >= 0  # no overflow at these sizes
            assert bins[l, s] == b
    # each bin entry maps back to a probing query
    for l in range(nlist):
        for s, q in enumerate(bins[l]):
            if q >= 0:
                assert l in probe[q]


def test_bin_queries_overflow_drops():
    # all queries probe list 0 -> only qb survive
    B, qb = 16, 4
    probe = np.zeros((B, 1), np.int32)
    bins, slots = BN.bin_queries(jnp.asarray(probe), 4, qb)
    slots = np.asarray(slots).ravel()
    assert (slots >= 0).sum() == qb
    assert sorted(np.asarray(bins)[0].tolist()) == sorted(
        [b for b in range(B) if slots[b] >= 0]
    )


def _clustered(n, dim, n_queries, seed=0, n_clusters=8):
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.standard_normal((n_clusters, dim)).astype(np.float32)
    base = centers[rng.integers(0, n_clusters, n)] + 0.5 * rng.standard_normal(
        (n, dim)
    ).astype(np.float32)
    queries = centers[rng.integers(0, n_clusters, n_queries)] + 0.5 * rng.standard_normal(
        (n_queries, dim)
    ).astype(np.float32)
    return base.astype(np.float32), queries.astype(np.float32)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_binned_search_recall(dist):
    # list length ~1500: the strided group-min keeps 1-in-4 rows per list,
    # so expected true-top-10 same-group collisions ~0.12 (see _SPT note)
    base, queries = _clustered(6000, 64, 40, n_clusters=4)
    index = IVFIndex.from_numpy(base, dist, IVFConfig(k=4), seed=1)
    flat = FlatIndex.from_numpy(base, dist)
    _, gt = flat.knn_batch(queries, 10, exact=True)

    # all lists probed -> candidate pool covers everything: group-min-grade
    d, i = index._knn_device_binned(jnp.asarray(queries), 10, 4)
    d, i = np.asarray(d), np.asarray(i)
    recall = np.mean([len(set(gt[q]) & set(i[q])) / 10 for q in range(len(queries))])
    assert recall >= 0.95
    # distances are exact f32 and ascending
    assert all(np.all(np.diff(d[q][np.isfinite(d[q])]) >= -1e-6) for q in range(len(queries)))

    # realistic probe count on well-separated clusters
    d2, i2 = index._knn_device_binned(jnp.asarray(queries), 10, 2)
    i2 = np.asarray(i2)
    recall2 = np.mean([len(set(gt[q]) & set(i2[q])) / 10 for q in range(len(queries))])
    assert recall2 >= 0.9


def test_binned_agrees_with_gathered_path():
    """The binned fast path approximates the per-query union path (its
    group-min keeps 1-in-4 rows per list); returned distances must be the
    EXACT f32 distances of the returned ids in both."""
    base, queries = _clustered(4000, 48, 16, seed=3, n_clusters=4)
    index = IVFIndex.from_numpy(base, "l2sqr", IVFConfig(k=4), seed=1)
    d_old, i_old = index.knn_batch(queries, 5, n_probes=4)  # CPU: gathered path
    d_new, i_new = index._knn_device_binned(jnp.asarray(queries), 5, 4)
    d_new, i_new = np.asarray(d_new), np.asarray(i_new)
    overlap = np.mean(
        [len(set(i_old[q]) & set(i_new[q])) / 5 for q in range(len(queries))]
    )
    assert overlap >= 0.85
    for q in range(len(queries)):
        for c in range(5):
            if i_new[q, c] >= 0:
                true = float(((base[i_new[q, c]] - queries[q]) ** 2).sum())
                assert abs(d_new[q, c] - true) <= 1e-3 + 1e-5 * abs(true)


def test_binned_overflow_segment(monkeypatch):
    """Rows spilled past the list cap must stay findable (overflow scan)."""
    from lab_1806_vec_db.models import ivf as ivf_mod

    monkeypatch.setattr(ivf_mod, "_LCAP_QUANTILE", 0.0)  # cap at min length
    base, queries = _clustered(6000, 64, 30, n_clusters=4, seed=5)
    index = IVFIndex.from_numpy(base, "l2sqr", IVFConfig(k=4), seed=1)
    assert index._device_sorted()[5] is not None  # overflow segment exists
    flat = FlatIndex.from_numpy(base, "l2sqr")
    _, gt = flat.knn_batch(queries, 10, exact=True)
    _, i = index._knn_device_binned(jnp.asarray(queries), 10, 4)
    i = np.asarray(i)
    recall = np.mean([len(set(gt[q]) & set(i[q])) / 10 for q in range(len(queries))])
    assert recall >= 0.95


def test_binned_small_batch_pads_dont_evict_probes():
    """Zero-vector pad queries (B_pad-B of them) must not consume bin slots:
    with B=33 (95 pads) every real query still reaches its probed lists."""
    base, queries = _clustered(4000, 48, 33, seed=11, n_clusters=4)
    index = IVFIndex.from_numpy(base, "l2sqr", IVFConfig(k=4), seed=1)
    flat = FlatIndex.from_numpy(base, "l2sqr")
    _, gt = flat.knn_batch(queries, 10, exact=True)
    _, i = index._knn_device_binned(jnp.asarray(queries), 10, 4)
    i = np.asarray(i)
    recall = np.mean([len(set(gt[q]) & set(i[q])) / 10 for q in range(len(queries))])
    assert recall >= 0.95


def test_binned_n_probes_exceeds_nlist():
    base, queries = _clustered(2000, 48, 16, seed=4, n_clusters=4)
    index = IVFIndex.from_numpy(base, "l2sqr", IVFConfig(k=4), seed=1)
    d, i = index._knn_device_binned(jnp.asarray(queries), 5, 8)
    assert np.asarray(i).shape == (16, 5)
