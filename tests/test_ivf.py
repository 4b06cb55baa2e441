"""IVF tests (mirrors reference src/index_algorithm/ivf_index.rs:166-235:
oracle-identity against Flat at clipped dim, plus serde roundtrip)."""

import numpy as np
import pytest

from lab_1806_vec_db.models import FlatIndex, IVFIndex
from lab_1806_vec_db.utils.config import IVFConfig


@pytest.fixture(scope="module")
def built(request):
    return None


def test_ivf_oracle_identity(gist_1000, tmp_path):
    vecs = gist_1000[:, :12].copy()  # dim clipped to 12 like the reference
    cfg = IVFConfig(k=7, k_means_size=len(vecs) // 10, k_means_max_iter=20, k_means_tol=1e-6)
    flat = FlatIndex.from_numpy(vecs, "l2sqr")
    ivf = IVFIndex.from_numpy(vecs, "l2sqr", cfg, seed=42)

    # posting lists must cover every vector exactly once
    ids = ivf.posting[ivf.posting >= 0]
    assert sorted(ids.tolist()) == list(range(len(vecs)))

    # save/load without vectors (ivf_index.rs:109-130)
    p = tmp_path / "ivf.npz"
    ivf.save(str(p), include_vectors=False)
    ivf = IVFIndex.load(str(p), external_vectors=vecs)

    k = 6
    q = vecs[200]
    res = ivf.knn(q, k)
    flat_res = flat.knn(q, k)
    assert [p_.index for p_ in res] == [p_.index for p_ in flat_res]
    ds = [p_.distance for p_ in res]
    assert ds == sorted(ds)
    assert len(res) == k


def test_ivf_ef_is_n_probes(gist_1000):
    vecs = gist_1000[:300, :12].copy()
    cfg = IVFConfig(k=16, k_means_size=None)
    ivf = IVFIndex.from_numpy(vecs, "l2sqr", cfg, seed=1)
    flat = FlatIndex.from_numpy(vecs, "l2sqr")
    # probing all clusters is exhaustive => identical to flat
    res = ivf.knn_with_ef(vecs[10], 5, 16)
    flat_res = flat.knn(vecs[10], 5)
    assert [p.index for p in res] == [p.index for p in flat_res]
