"""IO, config, serde, CLI, and bench-harness tests."""

import os
import subprocess
import sys

import numpy as np
import pytest

from lab_1806_vec_db.utils import io, serde
from lab_1806_vec_db.utils.candidates import GroundTruth, recall
from lab_1806_vec_db.utils.config import BenchConfig, VecDataConfig


def test_raw_roundtrip(tmp_path, rng):
    vecs = rng.standard_normal((20, 8)).astype(np.float32)
    p = tmp_path / "v.bin"
    io.save_raw(p, vecs)
    loaded = io.load_raw(p, 8, "float32")
    np.testing.assert_array_equal(loaded, vecs)
    limited = io.load_raw(p, 8, "float32", limit=5)
    assert limited.shape == (5, 8)


def test_uint8_raw(tmp_path, rng):
    vecs = rng.integers(0, 256, size=(10, 4)).astype(np.uint8)
    p = tmp_path / "v.bin"
    io.save_raw(p, vecs)
    loaded = io.load_raw(p, 4, "uint8")
    np.testing.assert_array_equal(loaded, vecs)


def test_fvecs(tmp_path, rng):
    vecs = rng.standard_normal((6, 5)).astype(np.float32)
    p = tmp_path / "v.fvecs"
    with open(p, "wb") as f:
        for row in vecs:
            f.write(np.uint32(5).tobytes())
            f.write(row.tobytes())
    loaded = io.load_fvecs(p)
    np.testing.assert_array_equal(loaded, vecs)
    assert io.load_fvecs(p, limit=2).shape == (2, 5)


def test_convert_fvecs_cli(tmp_path, rng):
    from lab_1806_vec_db.cli import convert_fvecs

    vecs = rng.standard_normal((4, 3)).astype(np.float32)
    src = tmp_path / "in.fvecs"
    with open(src, "wb") as f:
        for row in vecs:
            f.write(np.uint32(3).tobytes())
            f.write(row.tobytes())
    dst = tmp_path / "out.bin"
    convert_fvecs.main([str(src), "-o", str(dst), "-l", "3"])
    out = io.load_raw(dst, 3)
    np.testing.assert_array_equal(out, vecs[:3])


def test_gen_gnd_cli(tmp_path, gist_1000):
    from lab_1806_vec_db.cli import gen_gnd

    base_p = tmp_path / "base.bin"
    test_p = tmp_path / "test.bin"
    io.save_raw(base_p, gist_1000[:100, :16])
    io.save_raw(test_p, gist_1000[100:110, :16])
    out_p = tmp_path / "gnd.npz"
    gen_gnd.main(
        ["-d", "16", "--base", str(base_p), "--test", str(test_p), "-o", str(out_p)]
    )
    gt = GroundTruth.load(out_p)
    assert len(gt) == 10 and gt.k == 10


def test_recall():
    assert recall([1, 2, 3, 4], [1, 2, 9, 10]) == 0.5
    assert recall([1], []) == 0.0


def test_ground_truth_roundtrip(tmp_path):
    gt = GroundTruth(np.arange(20).reshape(4, 5))
    p = tmp_path / "gt.npz"
    gt.save(p)
    loaded = GroundTruth.load(p)
    np.testing.assert_array_equal(loaded.rows, gt.rows)
    assert loaded.batch_recall(np.arange(20).reshape(4, 5)) == 1.0


def test_vec_data_config_toml(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text('dim = 960\ndata_type = "float32"\ndata_path = "data/x.bin"\n')
    c = VecDataConfig.load_from_toml_file(p)
    assert c.dim == 960 and c.data_type == "float32"


def test_bench_config_toml(tmp_path):
    p = tmp_path / "b.toml"
    p.write_text(
        """
label = "HNSW"
dist = "L2Sqr"
gnd_path = "gnd.npz"
index_cache = "idx.npz"
bench_output = "out.toml"

[ef.range]
start = 120
end = 200
step = 40

[algorithm.HNSW]
ef_construction = 150

[base]
dim = 16
data_path = "base.bin"

[test]
dim = 16
data_path = "test.bin"
"""
    )
    c = BenchConfig.load_from_toml_file(p)
    assert c.ef == [120, 160, 200]
    assert c.algorithm.name == "HNSW"
    assert c.algorithm.hnsw.ef_construction == 150
    assert c.dist == "l2sqr"


def test_serde_atomic_arrays(tmp_path):
    arrays = {"a": np.arange(6).reshape(2, 3)}
    meta = {"x": 1, "nested": {"y": "z"}}
    p = tmp_path / "ck.npz"
    serde.save_arrays(p, arrays, meta)
    a2, m2 = serde.load_arrays(p)
    np.testing.assert_array_equal(a2["a"], arrays["a"])
    assert m2 == meta


def test_bench_harness_end_to_end(tmp_path, gist_1000):
    """Small end-to-end sweep through the harness (bench.rs parity)."""
    from lab_1806_vec_db.bench import harness
    from lab_1806_vec_db.cli import gen_gnd

    base_p, test_p = tmp_path / "base.bin", tmp_path / "test.bin"
    io.save_raw(base_p, gist_1000[:200, :16])
    io.save_raw(test_p, gist_1000[200:220, :16])
    gnd_p = tmp_path / "gnd.npz"
    gen_gnd.main(["-d", "16", "--base", str(base_p), "--test", str(test_p), "-o", str(gnd_p)])

    cfg_p = tmp_path / "bench.toml"
    cfg_p.write_text(
        f"""
label = "Flat"
dist = "L2Sqr"
gnd_path = "{gnd_p}"
index_cache = ""
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
    res = harness.run_bench(cfg)
    assert res["recall"][0] == 1.0  # flat is exact
    out = harness.ResultList.load(str(tmp_path / "results.toml"))
    assert "Flat" in out.results
    assert os.path.exists(tmp_path / "results.html")
    assert "chained" not in out.results["Flat"]  # wall-clock row: no flag

    # chained device-resident timing mode (VERDICT r4 item 2b): same
    # results, row flagged `chained = true` so the two methodologies are
    # never silently compared
    cfg.chained = True
    res2 = harness.run_bench(cfg)
    assert res2["recall"][0] == 1.0
    out2 = harness.ResultList.load(str(tmp_path / "results.toml"))
    assert out2.results["Flat"].get("chained") is True
    # round-trip through save preserves the flag
    out2.save(str(tmp_path / "results.toml"))
    out3 = harness.ResultList.load(str(tmp_path / "results.toml"))
    assert out3.results["Flat"].get("chained") is True


def test_make_dataset_device_matches_shape():
    """bench.py's on-device dataset generator (runs on any backend)."""
    import sys

    sys.path.insert(0, "/root/repo")
    import bench

    base, queries, n = bench.make_dataset_device(1000, 64, 16, seed=3)
    assert n >= 1000 and base.shape == (n, 64) and queries.shape == (16, 64)
    import numpy as np

    b = np.asarray(base)
    # gist-spectrum data: non-negative (clipped like real Gist), finite,
    # with per-dim scales matched to the real fixture slice
    assert np.isfinite(b).all() and (b >= 0).all() and b.std() > 0.01
    mu, scales, _ = bench.gist_spectrum(64)
    assert abs(b.mean() - mu.mean()) < 0.05
    # deterministic per seed
    base2, queries2, _ = bench.make_dataset_device(1000, 64, 16, seed=3)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(base2))
    np.testing.assert_array_equal(queries, queries2)
