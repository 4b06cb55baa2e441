"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lab_1806_vec_db.parallel import sharded as S
from lab_1806_vec_db.models import FlatIndex


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_flat_matches_single_device(gist_1000):
    base = gist_1000[:333, :64].copy()  # deliberately not divisible by 8
    queries = gist_1000[500:510, :64].copy()
    mesh = S.make_mesh()
    sharded = S.ShardedFlatIndex(mesh, base, "l2sqr")
    flat = FlatIndex.from_numpy(base, "l2sqr")
    d1, i1 = sharded.knn_batch(queries, 7)
    d2, i2 = flat.knn_batch(queries, 7)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-4, atol=1e-4)


def test_sharded_pq_matches_single_device(gist_1000):
    """Sharded ADC scan + per-chip exact rerank must match the single-device
    Flat knn_pq path."""
    from lab_1806_vec_db.models import PQTable
    from lab_1806_vec_db.utils.config import PQConfig

    base = gist_1000[:300, :48].copy()
    queries = gist_1000[500:508, :48].copy()
    pq = PQTable.train(base, PQConfig(n_bits=4, m=16, dist="l2sqr"), seed=1)
    mesh = S.make_mesh()
    sharded = S.ShardedPQFlatIndex(mesh, base, pq, "l2sqr")
    flat = FlatIndex.from_numpy(base, "l2sqr")
    d1, i1 = sharded.knn_batch(queries, 5, ef=40)
    d2, i2 = flat.knn_pq_batch(queries, 5, 40, pq)
    # both rerank exactly; sharded reranks per-chip top-ef so candidate pools
    # can differ slightly — require top-1 identity and distance-set overlap
    np.testing.assert_array_equal(i1[:, 0], i2[:, 0])
    assert np.mean([len(set(i1[r]) & set(i2[r])) / 5 for r in range(len(queries))]) >= 0.8


def test_sharded_kmeans_step(gist_1000):
    base = gist_1000[:256, :16].copy()
    mesh = S.make_mesh()
    idx = S.ShardedFlatIndex(mesh, base, "l2sqr")
    centroids = jnp.asarray(base[:4])
    new_c = np.asarray(
        S.kmeans_step_sharded(idx.base, idx.n_local, centroids, "l2sqr", mesh)
    )
    # oracle: single-process Lloyd step
    d = ((base[:, None, :] - base[:4][None, :, :]) ** 2).sum(-1)
    a = d.argmin(1)
    expect = np.stack([base[a == c].mean(0) if (a == c).any() else base[c] for c in range(4)])
    np.testing.assert_allclose(new_c, expect, rtol=1e-4, atol=1e-4)


def test_graft_entry_compiles():
    import sys, os

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    d, i = out
    assert d.shape == (4, 16)

    ge.dryrun_multichip(8)


def test_sharded_two_stage_matches_exact(gist_1000):
    base = np.vstack([gist_1000[:, :32]] * 2).astype(np.float32)  # 2000 rows
    queries = gist_1000[:16, :32].copy()
    index = S.ShardedFlatIndex(S.make_mesh(), base, "l2sqr")
    d_ex, i_ex = index.knn_batch(queries, 10, exact=True)
    d_2s, i_2s = index.knn_batch(queries, 10, exact=False)
    recall = np.mean([len(set(i_ex[b]) & set(i_2s[b])) / 10 for b in range(16)])
    assert recall >= 0.9
    assert (np.diff(d_2s, axis=1) >= -1e-6).all()


def test_sharded_ivf_matches_probe_oracle(gist_1000):
    """Sharded IVF with injected centroids must return exactly the top-k of
    the union of the globally-probed lists (the per-chip posting segments
    partition each list across chips)."""
    from lab_1806_vec_db.utils.config import IVFConfig

    base = gist_1000[:401, :32].copy()  # not divisible by 8
    queries = gist_1000[500:510, :32].copy()
    rng = np.random.default_rng(3)
    cents = base[rng.choice(len(base), 8, replace=False)].copy()
    mesh = S.make_mesh()
    idx = S.ShardedIVFIndex(mesh, base, "l2sqr", IVFConfig(k=8), centroids=cents)
    k, p = 5, 3
    d1, i1 = idx.knn_batch(queries, k, n_probes=p)
    dc = ((queries[:, None, :] - cents[None]) ** 2).sum(-1)
    db = ((base[:, None, :] - cents[None]) ** 2).sum(-1)
    assign = db.argmin(1)
    for r in range(len(queries)):
        probes = np.argsort(dc[r], kind="stable")[:p]
        cand = np.flatnonzero(np.isin(assign, probes))
        dd = ((base[cand] - queries[r]) ** 2).sum(-1)
        order = cand[np.argsort(dd, kind="stable")[:k]]
        assert set(i1[r].tolist()) == set(order.tolist())
        np.testing.assert_allclose(np.sort(d1[r]), np.sort(dd)[:k], rtol=1e-3, atol=1e-3)


def test_sharded_ivf_distributed_fit_all_probes_is_exact(gist_1000):
    """With every list probed, sharded IVF equals the exact sharded scan —
    exercises the distributed k-means fit (sample fit + sharded Lloyd
    refinement) end to end."""
    from lab_1806_vec_db.utils.config import IVFConfig

    base = gist_1000[:300, :24].copy()
    queries = gist_1000[400:408, :24].copy()
    mesh = S.make_mesh()
    idx = S.ShardedIVFIndex(
        mesh, base, "l2sqr", IVFConfig(k=6, k_means_size=128), seed=1, refine_steps=2
    )
    flat = S.ShardedFlatIndex(mesh, base, "l2sqr")
    d1, i1 = idx.knn_batch(queries, 7, n_probes=6)
    d2, i2 = flat.knn_batch(queries, 7)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-3, atol=1e-3)


def test_sharded_hnsw_exhaustive_ef_is_exact(gist_1000):
    """With ef >= shard size every per-shard beam search is exhaustive, so
    the sharded HNSW must equal the exact sharded scan (the oracle pattern
    of hnsw_index.rs:713-790 lifted to the mesh)."""
    from lab_1806_vec_db.utils.config import HNSWConfig

    base = gist_1000[:280, :24].copy()  # 35/chip, not divisible by 8
    queries = gist_1000[400:410, :24].copy()
    mesh = S.make_mesh()
    idx = S.ShardedHNSWIndex(mesh, base, "l2sqr", HNSWConfig(M=6), seed=0)
    flat = S.ShardedFlatIndex(mesh, base, "l2sqr")
    d1, i1 = idx.knn_with_ef_batch(queries, 7, ef=64)
    d2, i2 = flat.knn_batch(queries, 7)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-3, atol=1e-3)


def test_sharded_hnsw_distances_are_exact_and_sorted(gist_1000):
    """At working ef the returned distances must be the true distances of
    the returned global ids, ascending per row (beam runs on the exact f32
    shard, so the beam head is the answer)."""
    from lab_1806_vec_db.utils.config import HNSWConfig

    base = gist_1000[:640, :32].copy()
    queries = gist_1000[700:712, :32].copy()
    mesh = S.make_mesh()
    idx = S.ShardedHNSWIndex(mesh, base, "l2sqr", HNSWConfig(M=8), seed=1)
    d, i = idx.knn_with_ef_batch(queries, 5, ef=24)
    assert (i >= 0).all() and (i < len(base)).all()
    true = ((base[i] - queries[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d, true, rtol=1e-3, atol=1e-3)
    assert (np.diff(d, axis=1) >= -1e-5).all()
    # determinism: a second identical search returns the same ids
    d2, i2 = idx.knn_with_ef_batch(queries, 5, ef=24)
    np.testing.assert_array_equal(i, i2)


# ---- serde: sharded indexes save/load (VERDICT r2 item 3) ----


def test_sharded_flat_serde_roundtrip(tmp_path, gist_1000):
    base = gist_1000[:210, :32].copy()
    queries = gist_1000[300:308, :32].copy()
    mesh = S.make_mesh()
    idx = S.ShardedFlatIndex(mesh, base, "l2sqr")
    p = str(tmp_path / "flat.shard.npz")
    idx.save(p)
    idx2 = S.ShardedFlatIndex.load(p, mesh)
    d1, i1 = idx.knn_batch(queries, 6)
    d2, i2 = idx2.knn_batch(queries, 6)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)
    # external-vec-set shape (index_algorithm/mod.rs:143-148)
    p2 = str(tmp_path / "flat.topo.npz")
    idx.save(p2, include_vectors=False)
    idx3 = S.ShardedFlatIndex.load(p2, mesh, external_base=base)
    _, i3 = idx3.knn_batch(queries, 6)
    np.testing.assert_array_equal(i1, i3)
    with pytest.raises(ValueError):
        S.ShardedFlatIndex.load(p2, mesh)  # no vectors, no external base


def test_sharded_ivf_serde_roundtrip_and_mesh_resize(tmp_path, gist_1000):
    """IVF checkpoints store centroids + the (n,) assignment; posting
    segments are rebuilt for the TARGET mesh, so a checkpoint re-places
    onto a different device count."""
    from lab_1806_vec_db.utils.config import IVFConfig

    base = gist_1000[:300, :24].copy()
    queries = gist_1000[400:408, :24].copy()
    mesh = S.make_mesh()
    idx = S.ShardedIVFIndex(mesh, base, "l2sqr", IVFConfig(k=6, k_means_size=128), seed=1)
    p = str(tmp_path / "ivf.shard.npz")
    idx.save(p)
    d1, i1 = idx.knn_batch(queries, 5, n_probes=3)
    idx2 = S.ShardedIVFIndex.load(p, mesh)
    d2, i2 = idx2.knn_batch(queries, 5, n_probes=3)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-4)
    # re-place on a smaller mesh: same probed lists -> same results
    mesh4 = S.make_mesh(4)
    idx3 = S.ShardedIVFIndex.load(p, mesh4)
    d3, i3 = idx3.knn_batch(queries, 5, n_probes=3)
    np.testing.assert_array_equal(i1, i3)


def test_sharded_pq_flat_serde_roundtrip(tmp_path, gist_1000):
    from lab_1806_vec_db.models import PQTable
    from lab_1806_vec_db.utils.config import PQConfig

    base = gist_1000[:300, :48].copy()
    queries = gist_1000[500:506, :48].copy()
    pq = PQTable.train(base, PQConfig(n_bits=4, m=16, dist="l2sqr"), seed=1)
    mesh = S.make_mesh()
    idx = S.ShardedPQFlatIndex(mesh, base, pq, "l2sqr")
    p = str(tmp_path / "pq.shard.npz")
    idx.save(p)
    idx2 = S.ShardedPQFlatIndex.load(p, mesh)
    d1, i1 = idx.knn_batch(queries, 5, ef=40)
    d2, i2 = idx2.knn_batch(queries, 5, ef=40)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-4)


def test_sharded_hnsw_serde_roundtrip(tmp_path, gist_1000):
    from lab_1806_vec_db.utils.config import HNSWConfig

    base = gist_1000[:280, :24].copy()
    queries = gist_1000[400:410, :24].copy()
    mesh = S.make_mesh()
    idx = S.ShardedHNSWIndex(mesh, base, "l2sqr", HNSWConfig(M=6), seed=0)
    d1, i1 = idx.knn_with_ef_batch(queries, 7, ef=24)
    p = str(tmp_path / "hnsw.shard.npz")
    idx.save(p)
    idx2 = S.ShardedHNSWIndex.load(p, mesh)
    d2, i2 = idx2.knn_with_ef_batch(queries, 7, ef=24)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-4)
    # external-vec-set shape
    p2 = str(tmp_path / "hnsw.topo.npz")
    idx.save(p2, include_vectors=False)
    idx3 = S.ShardedHNSWIndex.load(p2, mesh, external_base=base)
    _, i3 = idx3.knn_with_ef_batch(queries, 7, ef=24)
    np.testing.assert_array_equal(i1, i3)
    # topology is per-shard and cannot be re-split, so opening on a
    # DIFFERENT mesh size rebuilds from rows (VERDICT r3 item 6) — same
    # config + seeds, and at exhaustive ef both placements are exact, so
    # results agree
    with pytest.warns(UserWarning, match="rebuild"):
        idx4 = S.ShardedHNSWIndex.load(p, S.make_mesh(4))
    d4, i4 = idx4.knn_with_ef_batch(queries, 7, ef=300)
    dx, ix = idx.knn_with_ef_batch(queries, 7, ef=300)
    np.testing.assert_array_equal(np.asarray(ix), np.asarray(i4))
    # without vectors anywhere, a mesh-size change still refuses
    with pytest.raises(ValueError):
        S.ShardedHNSWIndex.load(p2, S.make_mesh(4))


def test_sharded_hnsw_parallel_build_matches_serial(gist_1000):
    """Per-shard builds dispatched concurrently (one thread per chip, each
    pinned to its own device — the multi-chip analog of rayon add_parallel,
    hnsw_index.rs:399-457) must produce the identical index: per-shard
    seeds are fixed, so parallel == serial bit-for-bit."""
    from lab_1806_vec_db.utils.config import HNSWConfig

    base = gist_1000[:240, :24].copy()
    queries = gist_1000[400:410, :24].copy()
    mesh = S.make_mesh()
    par = S.ShardedHNSWIndex(mesh, base, "l2sqr", HNSWConfig(M=6), seed=0, parallel=True)
    ser = S.ShardedHNSWIndex(mesh, base, "l2sqr", HNSWConfig(M=6), seed=0, parallel=False)
    np.testing.assert_array_equal(np.asarray(par.links0), np.asarray(ser.links0))
    np.testing.assert_array_equal(np.asarray(par.entries), np.asarray(ser.entries))
    d1, i1 = par.knn_with_ef_batch(queries, 7, ef=24)
    d2, i2 = ser.knn_with_ef_batch(queries, 7, ef=24)
    np.testing.assert_array_equal(i1, i2)


def test_harness_mesh_sweep_end_to_end(tmp_path, gist_1000):
    """`mesh = 8` in a bench TOML runs the whole sweep through the sharded
    indexes (VERDICT r2 item 3: multi-chip reachable from the product
    surface)."""
    from lab_1806_vec_db.bench import harness
    from lab_1806_vec_db.cli import gen_gnd
    from lab_1806_vec_db.utils import io
    from lab_1806_vec_db.utils.config import BenchConfig

    base_p, test_p = tmp_path / "base.bin", tmp_path / "test.bin"
    io.save_raw(base_p, gist_1000[:200, :16])
    io.save_raw(test_p, gist_1000[200:220, :16])
    gnd_p = tmp_path / "gnd.npz"
    gen_gnd.main(["-d", "16", "--base", str(base_p), "--test", str(test_p), "-o", str(gnd_p)])
    cache_p = tmp_path / "flat.shard.npz"
    cfg_p = tmp_path / "bench.toml"
    cfg_p.write_text(
        f"""
label = "Flat-mesh8"
dist = "L2Sqr"
mesh = 8
gnd_path = "{gnd_p}"
index_cache = "{cache_p}"
bench_output = "{tmp_path / 'results.toml'}"

[ef]
list = [10]

[algorithm.Flat]

[base]
dim = 16
data_path = "{base_p}"

[test]
dim = 16
data_path = "{test_p}"
"""
    )
    cfg = BenchConfig.load_from_toml_file(cfg_p)
    assert cfg.mesh == 8
    res = harness.run_bench(cfg)
    assert res["recall"][0] == 1.0  # sharded flat is exact
    # the sharded checkpoint was written and a second run loads it
    assert cache_p.exists()
    res2 = harness.run_bench(cfg)
    assert res2["recall"][0] == 1.0
