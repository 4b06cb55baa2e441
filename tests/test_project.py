"""PCA-projected stage-1 scan (ops/project.py + VECDB_SCAN=pca)."""

import numpy as np
import jax.numpy as jnp
import pytest

from lab_1806_vec_db.models import FlatIndex
from lab_1806_vec_db.models import flat as flat_mod
from lab_1806_vec_db.ops import project as PJ


def _clustered(n, dim, n_queries, seed=0, n_clusters=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    base = centers[rng.integers(0, n_clusters, n)] + 0.3 * rng.standard_normal(
        (n, dim)
    ).astype(np.float32)
    queries = centers[rng.integers(0, n_clusters, n_queries)] + 0.3 * rng.standard_normal(
        (n_queries, dim)
    ).astype(np.float32)
    return base.astype(np.float32), queries.astype(np.float32)


def test_pca_fit_recovers_dominant_subspace():
    # data spread along 4 directions embedded in 64 dims: the projection must
    # capture nearly all variance
    rng = np.random.default_rng(1)
    basis = np.linalg.qr(rng.standard_normal((64, 4)))[0].astype(np.float32)
    z = rng.standard_normal((500, 4)).astype(np.float32) * np.array(
        [10, 7, 5, 3], np.float32
    )
    x = z @ basis.T + 0.01 * rng.standard_normal((500, 64)).astype(np.float32)
    proj, mu = PJ.pca_fit(jnp.asarray(x), 500, 4, "l2sqr")
    xp = np.asarray(PJ.project(jnp.asarray(x), jnp.asarray(proj), jnp.asarray(mu)))
    var_kept = xp.var(axis=0).sum() / (x - x.mean(0)).var(axis=0).sum()
    assert var_kept > 0.99


def test_pca_fit_ignores_padded_rows():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((100, 32)).astype(np.float32)
    padded = np.zeros((160, 32), np.float32)
    padded[:100] = x
    p1, m1 = PJ.pca_fit(jnp.asarray(x), 100, 8, "l2sqr")
    p2, m2 = PJ.pca_fit(jnp.asarray(padded), 100, 8, "l2sqr")
    np.testing.assert_allclose(m1, m2, atol=1e-5)
    np.testing.assert_allclose(np.abs(p1), np.abs(p2), atol=1e-3)


def _lowrank(n, dim, n_queries, rank, seed=0):
    """Data with spectral decay (the regime the PCA scan targets — real
    embedding sets like GIST are strongly low-rank; isotropic noise is the
    adversarial case and is covered by the recall gate in the 1M bench)."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.standard_normal((dim, rank)))[0].astype(np.float32)
    scales = (1.0 / np.sqrt(1 + np.arange(rank))).astype(np.float32)

    def draw(m):
        z = rng.standard_normal((m, rank)).astype(np.float32) * scales
        return z @ basis.T + 0.01 * rng.standard_normal((m, dim)).astype(np.float32)

    return draw(n), draw(n_queries)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_pca_scan_recall(monkeypatch, dist):
    monkeypatch.setattr(flat_mod, "_SCAN_MODE", "pca")
    monkeypatch.setattr(flat_mod, "_PCA_DIM", 32)
    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)
    base, queries = _lowrank(4000, 96, 50, rank=24)
    index = FlatIndex.from_numpy(base, dist)
    gt_d, gt_i = index.knn_batch(queries, 10, exact=True)
    d, i = index.knn_batch(queries, 10)
    recall = np.mean(
        [len(set(gt_i[q]) & set(i[q])) / 10 for q in range(len(queries))]
    )
    assert recall >= 0.95
    # returned distances are exact f32 for the ids returned
    for q in range(5):
        for c, idx in enumerate(i[q]):
            ref = gt_d[q][list(gt_i[q]).index(idx)] if idx in gt_i[q] else None
            if ref is not None:
                assert abs(d[q][c] - ref) < 1e-3


def test_pca_mirror_incremental_sync(monkeypatch):
    monkeypatch.setattr(flat_mod, "_SCAN_MODE", "pca")
    monkeypatch.setattr(flat_mod, "_PCA_DIM", 16)
    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)
    rng = np.random.default_rng(3)
    base = rng.standard_normal((512, 48)).astype(np.float32)
    index = FlatIndex.from_numpy(base, "l2sqr")
    index.knn_batch(base[:4], 5)  # builds the projected mirror
    # append new rows WITHOUT capacity growth (cap 512 -> stays if <=512? use
    # swap_remove instead: overwrite rows in place via remove+push)
    index.store.swap_remove(0)
    v_new = rng.standard_normal(48).astype(np.float32)
    index.store.push(v_new)
    d, i = index.knn_batch(v_new[None, :], 1)
    assert i[0][0] == 511 and d[0][0] < 1e-5


def test_pca_small_dim_degrades_to_int8(monkeypatch):
    monkeypatch.setattr(flat_mod, "_SCAN_MODE", "pca")
    monkeypatch.setattr(flat_mod, "_PCA_DIM", 256)
    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)
    base, queries = _clustered(1000, 64, 20)  # dim 64 < 256: int8 fallback
    index = FlatIndex.from_numpy(base, "l2sqr")
    _, gt_i = index.knn_batch(queries, 10, exact=True)
    _, i = index.knn_batch(queries, 10)
    recall = np.mean([len(set(gt_i[q]) & set(i[q])) / 10 for q in range(20)])
    assert recall >= 0.95
