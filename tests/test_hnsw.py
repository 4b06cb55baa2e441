"""HNSW tests (mirrors reference src/index_algorithm/hnsw_index.rs:713-790):
oracle-identity against Flat at clipped dim (where HNSW is effectively
exact), both distances, serde roundtrips including the external-vec-set
shape, plus incremental add."""

import numpy as np
import pytest

from lab_1806_vec_db.models import FlatIndex, HNSWIndex
from lab_1806_vec_db.utils.config import HNSWConfig


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_hnsw_oracle_identity(dist, gist_1000, tmp_path):
    vecs = gist_1000[:, :12].copy()  # clipped dim => ANN is effectively exact
    index = HNSWIndex.build(vecs, dist, HNSWConfig(), seed=42)
    flat = FlatIndex.from_numpy(vecs, dist)

    # serde roundtrip (hnsw_index.rs:750-756)
    p = tmp_path / "hnsw.npz"
    index.save(str(p))
    index = HNSWIndex.load(str(p))

    # serde without vec set (hnsw_index.rs:758-765)
    p2 = tmp_path / "hnsw_novec.npz"
    index.save(str(p2), include_vectors=False)
    index = HNSWIndex.load(str(p2), external_vectors=vecs)

    k = 6
    q = vecs[200]
    res = index.knn(q, k)
    flat_res = flat.knn(q, k)
    assert [p_.index for p_ in res] == [p_.index for p_ in flat_res]
    assert len(res) == k
    ds = [p_.distance for p_ in res]
    assert ds == sorted(ds)


def test_hnsw_incremental_add(gist_1000):
    vecs = gist_1000[:200, :12].copy()
    index = HNSWIndex.build(vecs[:150], "l2sqr", HNSWConfig(), seed=7)
    for v in vecs[150:]:
        index.add(v)
    assert len(index) == 200
    flat = FlatIndex.from_numpy(vecs, "l2sqr")
    hits = 0
    for qi in [0, 50, 120, 160, 199]:
        res = index.knn_with_ef(vecs[qi], 5, 60)
        flat_res = flat.knn(vecs[qi], 5)
        hits += len({p.index for p in res} & {p.index for p in flat_res})
    assert hits >= 22  # ~exact on clipped dim


def test_hnsw_empty_and_single():
    index = HNSWIndex(4, "l2sqr", HNSWConfig())
    assert index.knn([0.0, 0.0, 0.0, 0.0], 3) == []
    index.add([1.0, 0.0, 0.0, 0.0])
    res = index.knn([1.0, 0.0, 0.0, 0.0], 3)
    assert len(res) == 1 and res[0].index == 0


def test_hnsw_batch_recall(gist_1000):
    """Batched search recall on the full-dim bundled slice."""
    vecs = gist_1000[:800].copy()
    queries = gist_1000[800:850].copy()
    index = HNSWIndex.build(vecs, "l2sqr", HNSWConfig(), seed=0)
    flat = FlatIndex.from_numpy(vecs, "l2sqr")
    _, gt = flat.knn_batch(queries, 10)
    _, got = index.knn_with_ef_batch(queries, 10, 120)
    recall = np.mean(
        [len(set(gt[i]) & set(got[i])) / 10 for i in range(len(queries))]
    )
    assert recall > 0.85, recall


def test_reverse_arrange_tiny_round_caps(monkeypatch):
    """Overflowing add-lists must apply ALL adds across rounds (a dropped
    round silently degrades connectivity; regression for the flush-guard
    bug where a pivot's later round overwrote its earlier one)."""
    import numpy as np
    from lab_1806_vec_db.models import hnsw as hnsw_mod
    from lab_1806_vec_db.models import FlatIndex
    from lab_1806_vec_db.utils.config import HNSWConfig

    monkeypatch.setattr(hnsw_mod.HNSWIndex, "_REV_ADD_CAP", 2)
    monkeypatch.setattr(hnsw_mod.HNSWIndex, "_REV_PIVOT_CAP", 3)
    rng = np.random.default_rng(0)
    base = rng.standard_normal((3000, 24)).astype(np.float32)
    queries = rng.standard_normal((50, 24)).astype(np.float32)
    index = hnsw_mod.HNSWIndex.build(
        base, "l2sqr", HNSWConfig(ef_construction=60, M=8), seed=3
    )
    flat = FlatIndex.from_numpy(base, "l2sqr")
    _, gt = flat.knn_batch(queries, 10, exact=True)
    _, ids = index.knn_with_ef_batch(queries, 10, 80)
    recall = np.mean([len(set(gt[q]) & set(ids[q])) / 10 for q in range(50)])
    assert recall >= 0.9


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_bulk_device_canonical_links_identical(dist, gist_1000, monkeypatch):
    """The device-canonical bulk links path (batch >= BULK_LINKS_MIN:
    gather/arrange/scatter on device, one final download) must produce a
    graph IDENTICAL to the per-round host path — same arithmetic, same
    round partitioning, only the residency of the links matrix differs."""
    import lab_1806_vec_db.models.hnsw as H

    vecs = gist_1000[:600, :16].copy()
    cfg = HNSWConfig(ef_construction=60, M=8)

    monkeypatch.setattr(H, "BULK_LINKS_MIN", 10**9)  # host path
    a = HNSWIndex.build(vecs, dist, cfg, seed=7)
    assert not a._links0_canonical_dev

    monkeypatch.setattr(H, "BULK_LINKS_MIN", 1)  # device-canonical path
    b = HNSWIndex.build(vecs, dist, cfg, seed=7)
    assert not b._links0_canonical_dev  # exited after build

    np.testing.assert_array_equal(a.links0[:600], b.links0[:600])
    assert a.entry_point == b.entry_point and a.enter_level == b.enter_level
    for ua, ub in zip(a.upper, b.upper):
        np.testing.assert_array_equal(ua.links[: ua.n], ub.links[: ub.n])

    # and the graph still searches: oracle identity at clipped dim
    flat = FlatIndex.from_numpy(vecs, dist)
    q = vecs[123]
    assert [p.index for p in b.knn(q, 5)] == [p.index for p in flat.knn(q, 5)]


def test_build_from_store_matches_host_build(gist_1000):
    """Device-born bulk build (zero vector bytes over the host boundary)
    must produce the SAME graph as the host-array build with the same seed:
    the insert machinery is prefix-bounded by ids, not by push order."""
    import jax.numpy as jnp
    from lab_1806_vec_db.models.store import VecStore

    vecs = gist_1000[:400, :32].copy()
    a = HNSWIndex.build(vecs, "l2sqr", HNSWConfig(M=8), seed=5)
    store = VecStore.from_device(jnp.asarray(vecs), "l2sqr")
    b = HNSWIndex.build_from_store(store, HNSWConfig(M=8), seed=5)
    n = len(vecs)
    assert a.entry_point == b.entry_point
    assert a.enter_level == b.enter_level
    np.testing.assert_array_equal(a.levels[:n], b.levels[:n])
    np.testing.assert_array_equal(a.links0[:n], b.links0[:n])
    q = gist_1000[500:520, :32].copy()
    da, ia = a.knn_with_ef_batch(q, 5, 32)
    db, ib = b.knn_with_ef_batch(q, 5, 32)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-5)


def test_save_topology_load_with_external_store(gist_1000, tmp_path):
    """save(include_vectors=False) + load(external_store=device-born store)
    reproduces the index exactly — the device-resident checkpoint pairing."""
    import jax.numpy as jnp
    from lab_1806_vec_db.models.store import VecStore

    vecs = gist_1000[:300, :24].copy()
    a = HNSWIndex.build(vecs, "l2sqr", HNSWConfig(M=6), seed=2)
    p = str(tmp_path / "topo.npz")
    a.save(p, include_vectors=False)
    store = VecStore.from_device(jnp.asarray(vecs), "l2sqr")
    b = HNSWIndex.load(p, external_store=store)
    q = gist_1000[400:410, :24].copy()
    da, ia = a.knn_with_ef_batch(q, 5, 40)
    db, ib = b.knn_with_ef_batch(q, 5, 40)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-5)


def test_hnsw_scan_route(gist_1000):
    """The scan physical plan honors the knn_with_ef contract: exact-grade
    results whose candidate pool is ef-wide, meeting or beating the graph
    route's recall at the same ef (with an accelerator "auto" picks it)."""
    vecs = gist_1000[:800].copy()
    queries = gist_1000[800:850].copy()
    index = HNSWIndex.build(vecs, "l2sqr", HNSWConfig(), seed=0)
    flat = FlatIndex.from_numpy(vecs, "l2sqr")
    _, gt = flat.knn_batch(queries, 10)

    def recall(ids):
        return np.mean([len(set(gt[i]) & set(ids[i])) / 10 for i in range(len(queries))])

    d_s, i_s = index.knn_with_ef_batch(queries, 10, 120, route="scan")
    _, i_g = index.knn_with_ef_batch(queries, 10, 120, route="graph")
    assert recall(i_s) >= recall(i_g)
    # returned distances are exact f32 (same contract as the graph route)
    row = vecs[i_s[0, 0]] - queries[0]
    assert abs(float(d_s[0, 0]) - float(np.dot(row, row))) < 1e-2
    # on CPU "auto" must stay on the true traversal (oracle fidelity)
    _, i_a = index.knn_with_ef_batch(queries, 10, 120, route="auto")
    assert np.array_equal(i_a, i_g)
    with pytest.raises(ValueError):
        index.knn_with_ef_batch(queries, 10, 120, route="warp")


def test_hnsw_scan_route_two_stage(gist_1000, monkeypatch):
    """The scan route's ef plumbing genuinely reaches FlatIndex's two-stage
    path (int8 stage-1 keeping `ef` survivors + exact rerank): with
    _EXACT_BELOW forced to 0 the n<=8192 exact shortcut is off.  A spy on
    the stage-1 kernel proves (a) the two-stage path runs at all and (b)
    `ef` arrives as the stage-1 survivor count (rerank_depth), i.e. the
    reference's accuracy knob is live, not shadowed by the exact branch."""
    import lab_1806_vec_db.models.flat as flat_mod
    from lab_1806_vec_db.ops import topk as T

    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)
    seen_r: list[int] = []
    real = T.scan_candidates_int8

    def spy(q, base, scales, cache, cap, r, dist):
        seen_r.append(int(r))
        return real(q, base, scales, cache, cap, r, dist)

    monkeypatch.setattr(flat_mod.T, "scan_candidates_int8", spy)
    vecs = gist_1000[:800].copy()
    queries = gist_1000[800:850].copy()
    index = HNSWIndex.build(vecs, "l2sqr", HNSWConfig(), seed=0)
    flat = FlatIndex.from_numpy(vecs, "l2sqr")
    _, gt = flat.knn_batch(queries, 10, exact=True)

    def recall(ids):
        return np.mean([len(set(gt[i]) & set(ids[i])) / 10 for i in range(len(queries))])

    _, ids = index.knn_with_ef_batch(queries, 10, 120, route="scan")
    assert seen_r[-1] == 120  # ef -> stage-1 survivor count, verbatim
    assert recall(ids) >= 0.95  # exact rerank repairs int8 ordering noise
    _, ids = index.knn_with_ef_batch(queries, 10, 400, route="scan")
    assert seen_r[-1] == 400
    # the floor (max(ef, k, 32)) applies to starved ef
    index.knn_with_ef_batch(queries, 10, 10, route="scan")
    assert seen_r[-1] == 32


def test_beam_search_stats_counts_novel_rows(rng):
    """with_stats must not change results and must count the novel rows the
    16 ns/row DMA ceiling prices (>= beam fill, <= expansion budget)."""
    import jax.numpy as jnp
    from lab_1806_vec_db.ops import beam as BM
    from lab_1806_vec_db.ops import distance as D

    N, dim, L, B, ef = 300, 16, 6, 5, 12
    vecs = jnp.asarray(rng.standard_normal((N, dim)).astype(np.float32))
    links = jnp.asarray(rng.integers(0, N, size=(N, L)).astype(np.int32))
    q = jnp.asarray(rng.standard_normal((B, dim)).astype(np.float32))
    vcache = D.dist_cache(vecs, "l2sqr")
    qc = D.dist_cache(q, "l2sqr")

    def nd(ids):
        v = vecs[ids]
        dots = jnp.einsum("bd,bcd->bc", q, v)
        return jnp.maximum(qc[:, None] + vcache[ids] - 2.0 * dots, 0.0)

    lf = lambda ids: links[ids]
    entry = jnp.zeros((B,), jnp.int32)
    iters = 64
    d0, i0 = BM.beam_search(entry, nd, lf, ef, iters, expand=2)
    d1, i1, rows = BM.beam_search(entry, nd, lf, ef, iters, expand=2,
                                  with_stats=True)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1))
    rows = np.asarray(rows)
    assert (rows >= ef).all()  # at least the beam was filled with novel rows
    assert (rows <= 1 + iters * 2 * L).all()  # bounded by the expansion budget


def test_pq_route_planner():
    """The quantized-search planner (VERDICT r4 item 5): mirror wherever
    the int8 scan mirror is resident, ADC scan below the measured
    scan-vs-traversal crossover, the literal ADC traversal above it, and
    always the reference algorithm on CPU (oracle fidelity)."""
    from lab_1806_vec_db.models.hnsw import PQ_SCAN_CROSSOVER, plan_pq_route

    # CPU: the literal reference algorithm, regardless of size or mirror
    assert plan_pq_route(False, True, 10_000) == "graph"
    assert plan_pq_route(False, False, 10 * PQ_SCAN_CROSSOVER) == "graph"
    # accelerator with a resident scan mirror: the mirror dominates 4-bit ADC
    assert plan_pq_route(True, True, 1_000_000) == "mirror"
    assert plan_pq_route(True, True, 10 * PQ_SCAN_CROSSOVER) == "mirror"
    # accelerator, codes-only storage: linear-cost scan below the crossover,
    # flat-cost traversal above it
    assert plan_pq_route(True, False, 1_000_000) == "scan"
    assert plan_pq_route(True, False, PQ_SCAN_CROSSOVER + 1) == "graph"
