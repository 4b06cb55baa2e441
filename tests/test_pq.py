"""PQ tests (mirrors reference src/distance/pq_table.rs:312-438):
group-split rule, exactness-by-construction, p90 relative error bound."""

import numpy as np
import jax.numpy as jnp
import pytest

from lab_1806_vec_db.ops import pq as P
from lab_1806_vec_db.ops import distance as D
from lab_1806_vec_db.models import PQTable, FlatIndex
from lab_1806_vec_db.utils.config import PQConfig


def test_pq_groups():
    # pq_table.rs:313-322
    assert P.pq_groups(6, 2) == [(0, 3), (3, 6)]
    assert P.pq_groups(7, 3) == [(0, 3), (3, 5), (5, 7)]


def test_pack_unpack_roundtrip(rng):
    codes = rng.integers(0, 16, size=(10, 7)).astype(np.uint8)
    packed = P.pack_codes_4bit(codes)
    assert packed.shape == (10, 4)
    np.testing.assert_array_equal(P.unpack_codes_4bit(packed, 7), codes)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_pq_exactness_when_num_vec_le_k(dist, rng):
    """With num_vec <= k the quantization is lossless, so ADC distance must
    equal the true distance (pq_table.rs:324-372)."""
    dim, m, num_vec = 8, 2, 5
    src = rng.uniform(-1.0, 1.0, size=(num_vec, dim)).astype(np.float32)
    cfg = PQConfig(n_bits=4, m=m, dist=dist, k_means_size=None, k_means_max_iter=20, k_means_tol=1e-6)
    pq = PQTable.train(src, cfg, seed=42)

    lookup, q_norms = pq.create_lookup(jnp.asarray(src))
    codes, _, cb_sq = pq.device()
    ids = jnp.broadcast_to(jnp.arange(num_vec, dtype=jnp.int32)[None, :], (num_vec, num_vec))
    adc = np.asarray(pq.adc_for_ids(lookup, q_norms, ids))
    for i in range(num_vec):
        for j in range(num_vec):
            expect = D.calc_dist_host(src[i], src[j], dist)
            assert abs(adc[i, j] - expect) < 1e-5, (i, j, adc[i, j], expect)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_pq_p90_relative_error(dist, gist_1000, rng):
    """p90 relative error < 0.2 on real data (pq_table.rs:374-413)."""
    vecs = gist_1000[:64, :13].copy()
    cfg = PQConfig(n_bits=4, m=-(-13 // 3), dist=dist, k_means_size=None)
    pq = PQTable.train(vecs, cfg, seed=42)

    errors = []
    for _ in range(20):
        i0, i1 = rng.integers(0, len(vecs), 2)
        lookup, q_norms = pq.create_lookup(jnp.asarray(vecs[i1][None, :]))
        adc = float(
            np.asarray(pq.adc_for_ids(lookup, q_norms, jnp.asarray([[int(i0)]])))[0, 0]
        )
        expect = D.calc_dist_host(vecs[i0], vecs[i1], dist)
        errors.append(abs(adc - expect) / max(expect, 1.0))
    errors.sort()
    p90 = errors[int(np.ceil(len(errors) * 0.9)) - 1]
    assert p90 < 0.2, p90


def test_flat_knn_pq_rerank(gist_1000):
    """Flat+PQ: ADC scan + exact rerank gets near-perfect recall with a wide
    ef on a small set (flat_index.rs:84-104)."""
    vecs = gist_1000[:500, :24].copy()
    queries = gist_1000[500:520, :24].copy()
    flat = FlatIndex.from_numpy(vecs, "l2sqr")
    cfg = PQConfig(n_bits=4, m=8, dist="l2sqr", k_means_size=250)
    pq = PQTable.train(vecs, cfg, seed=0)

    d_exact, i_exact = flat.knn_batch(queries, 10)
    d_pq, i_pq = flat.knn_pq_batch(queries, 10, ef=200, pq=pq)
    recall = np.mean(
        [len(set(i_exact[q]) & set(i_pq[q])) / 10 for q in range(len(queries))]
    )
    assert recall > 0.9, recall


def test_pq_serde_roundtrip(tmp_path, gist_1000):
    vecs = gist_1000[:100, :12].copy()
    cfg = PQConfig(n_bits=4, m=4, dist="l2sqr", k_means_size=None)
    pq = PQTable.train(vecs, cfg, seed=3)
    p = tmp_path / "pq.npz"
    pq.save(str(p))
    loaded = PQTable.load(str(p))
    np.testing.assert_array_equal(loaded.codes, pq.codes)
    np.testing.assert_allclose(loaded.codebooks, pq.codebooks, rtol=1e-6)
    assert loaded.config.m == 4 and loaded.config.n_bits == 4


def test_hnsw_pq_mirror_route(gist_1000):
    """knn_pq_batch route="mirror" (the accelerator planner's pick when the int8
    scan mirror is resident) returns exact-grade results; "auto" on CPU
    stays on the reference-shaped ADC plan; bad routes are rejected."""
    from lab_1806_vec_db.models import HNSWIndex
    from lab_1806_vec_db.utils.config import HNSWConfig

    vecs = gist_1000[:400, :24].copy()
    queries = gist_1000[400:420, :24].copy()
    index = HNSWIndex.build(vecs, "l2sqr", HNSWConfig(), seed=0)
    pq = PQTable.train(vecs, PQConfig(n_bits=4, m=8, dist="l2sqr"), seed=0)
    flat = FlatIndex.from_numpy(vecs, "l2sqr")
    _, gt = flat.knn_batch(queries, 10)

    def recall(ids):
        return np.mean([len(set(gt[q]) & set(ids[q])) / 10 for q in range(len(queries))])

    _, i_m = index.knn_pq_batch(queries, 10, 200, pq, route="mirror")
    _, i_g = index.knn_pq_batch(queries, 10, 200, pq, route="graph")
    assert recall(i_m) >= recall(i_g)
    _, i_a = index.knn_pq_batch(queries, 10, 200, pq, route="auto")
    assert np.array_equal(i_a, i_g)  # CPU auto = the true ADC traversal
    with pytest.raises(ValueError):
        index.knn_pq_batch(queries, 10, 200, pq, route="warp")


def test_hnsw_pq_mirror_route_two_stage(gist_1000, monkeypatch):
    """route="mirror" with the exact-scan shortcut disabled really runs the
    int8 two-stage plan with ef as the stage-1 survivor count: a spy on the
    stage-1 kernel proves the plumbing under test (flat.py rerank_depth=ef)
    is live rather than shadowed by the n<=8192 exact branch."""
    import lab_1806_vec_db.models.flat as flat_mod
    from lab_1806_vec_db.models import HNSWIndex
    from lab_1806_vec_db.ops import topk as T
    from lab_1806_vec_db.utils.config import HNSWConfig

    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)
    seen_r: list[int] = []
    real = T.scan_candidates_int8

    def spy(q, base, scales, cache, cap, r, dist):
        seen_r.append(int(r))
        return real(q, base, scales, cache, cap, r, dist)

    monkeypatch.setattr(flat_mod.T, "scan_candidates_int8", spy)
    vecs = gist_1000[:400].copy()
    queries = gist_1000[400:420].copy()
    index = HNSWIndex.build(vecs, "l2sqr", HNSWConfig(), seed=0)
    pq = PQTable.train(vecs, PQConfig(n_bits=4, m=320, dist="l2sqr"), seed=0)
    flat = FlatIndex.from_numpy(vecs, "l2sqr")
    _, gt = flat.knn_batch(queries, 10, exact=True)

    def recall(ids):
        return np.mean([len(set(gt[q]) & set(ids[q])) / 10 for q in range(len(queries))])

    _, i_m = index.knn_pq_batch(queries, 10, 300, pq, route="mirror")
    assert seen_r[-1] == 300  # ef reached stage-1 as the survivor count
    assert recall(i_m) >= 0.95  # exact rerank over a 300-wide int8 pool


def test_pq_rotate_preserves_distances_and_serde(gist_1000, tmp_path):
    """rotate=True trains/encodes in a distance-preserving transformed
    space: ADC distances approximate ORIGINAL-space distances (L2 centering
    is translation-transparent, the rotation is orthogonal), candidates
    rerank exactly, and the rotation/center ride the checkpoint."""
    base = gist_1000[:300, :48].copy()
    queries = gist_1000[500:508, :48].copy()
    cfg = PQConfig(n_bits=4, m=16, dist="l2sqr", rotate=True)
    pq = PQTable.train(base, cfg, seed=3)
    assert pq.rotation is not None and pq.rotation.shape == (48, 48)
    # orthogonality (distance preservation)
    np.testing.assert_allclose(pq.rotation @ pq.rotation.T, np.eye(48), atol=1e-5)
    assert pq.center is not None  # l2sqr centers on the training mean
    assert 0.0 <= pq.adc_quality <= 1.0

    flat = FlatIndex.from_numpy(base, "l2sqr")
    _, gt = flat.knn_batch(queries, 5, exact=True)
    _, ids = flat.knn_pq_batch(queries, 5, 60, pq)
    rec = np.mean([len(set(gt[i]) & set(ids[i])) / 5 for i in range(len(queries))])
    assert rec >= 0.9  # ADC-ordered pool + exact rerank in the rotated space

    p = str(tmp_path / "pq_rot.npz")
    pq.save(p)
    pq2 = PQTable.load(p)
    assert pq2.config.rotate is True
    np.testing.assert_array_equal(pq2.rotation, pq.rotation)
    np.testing.assert_array_equal(pq2.center, pq.center)
    assert pq2.adc_quality == pq.adc_quality
    _, ids2 = flat.knn_pq_batch(queries, 5, 60, pq2)
    np.testing.assert_array_equal(ids, ids2)

    # cosine: rotation only (translation is NOT cosine-transparent)
    pqc = PQTable.train(base, PQConfig(n_bits=4, m=16, dist="cosine", rotate=True), seed=3)
    assert pqc.center is None and pqc.rotation is not None


def test_pq_adc_self_test_warns_when_unreliable(gist_1000):
    """The build-time ADC ordering self-test gates ADC-ordered routes: a
    table whose overlap score falls below the threshold warns loudly
    (VERDICT r2 item 6 — the int8 mirror's discipline applied to PQ)."""
    import warnings

    base = gist_1000[:200, :32].copy()
    pq = PQTable.train(base, PQConfig(n_bits=4, m=8, dist="l2sqr"), seed=0)
    assert pq.adc_quality is not None
    # force the gate with an impossible threshold: deterministic trigger
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert pq.warn_if_unreliable("unit-test", threshold=1.01) is True
        assert any("unreliable" in str(x.message) for x in w)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert pq.warn_if_unreliable("unit-test", threshold=0.0) is False
        assert not w
