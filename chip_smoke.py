"""Smoke test of the vector database on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]          # one card: every index family
    python3 chip_smoke.py --four-cards        # the sharded paths on four cards

Run from the root of a checkout.  It drives the served path through the
entry points a user calls (`VecDB`, the index classes) at the reference's
Gist1M deployment shape — 1,000,000 x 960 float32 rows, batches of 1,000
queries, k=10 — on Gist-spectrum synthetic data made on the card from
`--seed` (bench/synth.py), and checks every answer against exact f32 ground
truth computed on the card (`topk.knn_scan`, Precision.HIGHEST): recall@10
and returned distances against a float64 recomputation.

Each phase prints one JSON line with the wall time of its first call
(compilation included) apart from its steady calls.  No phase catches its
own failure: any failed check exits non-zero.  The last line is
{"ok": true, "device": {...}} and is printed only if every phase passed.
Without a GPU, or outside a checkout, it exits non-zero before any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time

import numpy as np


@dataclasses.dataclass
class Sizes:
    n_flat: int = 1_000_000  # Flat, IVF, lean tier and the kernel timing
    n_cos: int = 100_000
    n_hnsw: int = 100_000  # HNSW and PQ (the 1M graph build is the benchmark's)
    n_slice: int = 1_000  # exhaustive-oracle slices
    n_kernel: int = 65_536 + 37  # kernel check rows: not a chunk multiple
    n_four: int = 4_000_000  # 3.84 GB per card on four cards
    n_four_small: int = 4_000
    dim: int = 960
    batch: int = 1_000
    k: int = 10
    nlist: int = 256
    pq_m: int = 320


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX's device is {dev.platform!r}, not a GPU")
    return dev


def print_cards() -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(out.stdout.strip(), flush=True)


def clock(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def steady(fn, reps: int = 3) -> float:
    """Median wall seconds of `reps` calls (each returns host data)."""
    times = [clock(fn)[1] for _ in range(reps)]
    return float(np.median(times))


def exact_gt(base_dev, queries, k: int, dist: str):
    """Exact f32 kNN on the card: (dists, ids) host arrays."""
    import jax.numpy as jnp
    from lab_1806_vec_db.ops import distance as D
    from lab_1806_vec_db.ops import topk as T

    d, i = T.knn_scan(
        jnp.asarray(queries), base_dev, D.dist_cache(base_dev, dist),
        jnp.int32(base_dev.shape[0]), k, dist,
    )
    return np.asarray(d), np.asarray(i)


def recall(gt_ids, ids) -> float:
    k = gt_ids.shape[1]
    return float(np.mean([len(set(g) & set(r)) / k for g, r in zip(gt_ids, ids)]))


def dists64(base, queries, ids, dist: str):
    """float64 distances of (B, k) row ids to their queries."""
    x = base[np.asarray(ids)].astype(np.float64)  # (B, k, dim)
    q = np.asarray(queries, np.float64)[:, None, :]
    if dist == "l2sqr":
        return ((x - q) ** 2).sum(-1)
    dots = (x * q).sum(-1)
    return 1.0 - dots / np.maximum(
        np.linalg.norm(x, axis=-1) * np.linalg.norm(q, axis=-1), 1e-10
    )


def ids_match(base, queries, got, want, dist: str = "l2sqr") -> int:
    """Ids equal the exact answer's, position by position, except where
    two rows tie at f32 precision: their float64 distances differ by less
    than the rounding error of the f32 dot-product expansion
    |q|^2 + |x|^2 - 2 q.x (~8 f32 ulps of |q|^2 + |x|^2), so the f32
    oracle may order them either way.  Returns the number of such swaps."""
    got, want = np.asarray(got), np.asarray(want)
    assert (got >= 0).all(), "missing results"
    diff = got != want
    dg = dists64(base, queries, got, dist)
    dw = dists64(base, queries, want, dist)
    scale = (np.asarray(queries, np.float64) ** 2).sum(-1)[:, None] + (
        base[want].astype(np.float64) ** 2).sum(-1) if dist == "l2sqr" else 1.0
    bad = diff & (np.abs(dg - dw) > 1e-6 * scale)
    assert not bad.any(), f"{int(bad.sum())} ids differ from the exact answer"
    return int(diff.sum())


def check_dists(base, queries, ids, d, dist: str) -> float:
    """Returned distances against float64 recomputation of the returned ids
    (rtol 1e-4); returns the largest relative error."""
    assert (np.asarray(ids) >= 0).all(), "missing results"
    want = dists64(base, queries, ids, dist)
    np.testing.assert_allclose(np.asarray(d, np.float64), want, rtol=1e-4, atol=1e-6)
    return float(np.max(np.abs(d - want) / np.maximum(np.abs(want), 1e-12)))


def db_arrays(results):
    """VecDB results (lists of (metadata, dist)) -> (dists, ids) arrays."""
    ids = np.array([[int(m["i"]) for m, _ in row] for row in results])
    d = np.array([[dist for _, dist in row] for row in results])
    return d, ids


def table(db, key):
    """The MetadataVecTable behind a VecDB key (to reach the index object)."""
    return db._inner._table_mgr(key).obj


def make_data(s: Sizes, seed: int):
    from lab_1806_vec_db.bench import synth

    base_dev = synth.make_device(s.n_flat, s.dim, seed)
    queries = np.asarray(synth.make_device(s.batch, s.dim, seed + 1))
    return base_dev, np.asarray(base_dev), queries


# ---------------------------------------------------------------- phases


def phase_flat(s, db, base_dev, base, queries):
    """Phase 1: VecDB Flat tables, exact and two-stage (batch_search
    B=1000 and B=1), the native single-query scan, and cosine at 100k."""
    k = s.k
    meta = [{"i": str(i)} for i in range(s.n_flat)]
    db.create_table_if_not_exists("flat", s.dim, "l2sqr")
    _, load_s = clock(lambda: db.batch_add("flat", base, meta))
    _, gt_i = exact_gt(base_dev, queries, k, "l2sqr")
    res, first_s = clock(lambda: db.batch_search("flat", queries, k))
    d, ids = db_arrays(res)
    rec = recall(gt_i, ids)
    assert rec >= 0.99, f"flat recall@10 {rec}"
    err = check_dists(base, queries, ids, d, "l2sqr")
    steady_s = steady(lambda: db.batch_search("flat", queries, k))
    res1, first1_s = clock(lambda: db.batch_search("flat", queries[:1], k))
    d1, i1 = db_arrays(res1)
    check_dists(base, queries[:1], i1, d1, "l2sqr")
    steady1_s = steady(lambda: db.batch_search("flat", queries[:1], k), reps=5)
    one, native_s = clock(lambda: db.search("flat", queries[0].tolist(), k))
    dn, in_ = db_arrays([one])
    ids_match(base, queries[:1], in_, gt_i[:1])
    check_dists(base, queries[:1], in_, dn, "l2sqr")
    emit({"phase": "flat", "n": s.n_flat, "dim": s.dim, "batch": s.batch,
          "load_s": load_s, "first_s": first_s, "steady_s": steady_s,
          "qps": s.batch / steady_s, "recall_at_10": rec, "max_rel_dist_err": err,
          "b1_first_s": first1_s, "b1_steady_s": steady1_s,
          "b1_recall_at_10": recall(gt_i[:1], i1), "native_search_s": native_s})
    db.delete_table("flat")

    n = s.n_cos
    db.create_table_if_not_exists("cos", s.dim, "cosine")
    db.batch_add("cos", base[:n], meta[:n])
    _, gt_i = exact_gt(base_dev[:n], queries, k, "cosine")
    res, first_s = clock(lambda: db.batch_search("cos", queries, k))
    d, ids = db_arrays(res)
    rec = recall(gt_i, ids)
    assert rec >= 0.99, f"cosine recall@10 {rec}"
    err = check_dists(base, queries, ids, d, "cosine")
    steady_s = steady(lambda: db.batch_search("cos", queries, k))
    emit({"phase": "flat_cosine", "n": n, "first_s": first_s, "steady_s": steady_s,
          "recall_at_10": rec, "max_rel_dist_err": err})
    db.delete_table("cos")


def phase_hnsw(s, db, base_dev, base, queries):
    """Phase 2: VecDB HNSW (M=16, efc=200) at 100k: the auto scan route,
    the XLA graph route, an exhaustive-ef oracle on a slice, and one native
    single-query search."""
    from lab_1806_vec_db.models import HNSWIndex, native
    from lab_1806_vec_db.utils.config import HNSWConfig

    k, n = s.k, s.n_hnsw
    db.create_table_if_not_exists("hnsw", s.dim, "l2sqr")
    db.batch_add("hnsw", base[:n], [{"i": str(i)} for i in range(n)])
    _, build_s = clock(lambda: db.build_hnsw_index("hnsw"))
    _, gt_i = exact_gt(base_dev[:n], queries, k, "l2sqr")
    res, first_s = clock(lambda: db.batch_search("hnsw", queries, k, ef=120))
    d, ids = db_arrays(res)
    rec = recall(gt_i, ids)
    assert rec >= 0.99, f"hnsw scan-route recall@10 {rec}"
    err = check_dists(base, queries, ids, d, "l2sqr")
    steady_s = steady(lambda: db.batch_search("hnsw", queries, k, ef=120))

    index = table(db, "hnsw").inner.inner
    assert isinstance(index, HNSWIndex)
    (dg, ig), graph_first_s = clock(
        lambda: index.knn_with_ef_batch(queries, k, 120, route="graph"))
    check_dists(base, queries, ig, dg, "l2sqr")
    graph_steady_s = steady(lambda: index.knn_with_ef_batch(queries, k, 120, route="graph"))

    m = s.n_slice
    small = HNSWIndex.build(base[:m], "l2sqr", HNSWConfig(M=16, ef_construction=200), seed=0)
    _, is_ = small.knn_with_ef_batch(queries, k, ef=m, route="graph")
    _, si = exact_gt(base_dev[:m], queries, k, "l2sqr")
    slice_ties = ids_match(base, queries, is_, si)

    assert native.available(), "native engine unavailable"
    one, native_s = clock(lambda: db.search("hnsw", queries[0].tolist(), k, ef=120))
    dn, in_ = db_arrays([one])
    check_dists(base, queries[:1], in_, dn, "l2sqr")
    emit({"phase": "hnsw", "n": n, "build_s": build_s, "first_s": first_s,
          "steady_s": steady_s, "recall_at_10": rec, "max_rel_dist_err": err,
          "graph_ef120_recall_at_10": recall(gt_i, ig), "graph_first_s": graph_first_s,
          "graph_steady_s": graph_steady_s, "slice_exhaustive_exact": True,
          "slice_tie_swaps": slice_ties,
          "native_recall_at_10": recall(gt_i[:1], in_), "native_search_s": native_s})
    return gt_i


def phase_pq(s, db, base_dev, base, queries, gt_i):
    """Phase 3: PQ (m=320, 4-bit) on the HNSW table: the auto mirror route,
    a Flat table's XLA ADC scan + exact rerank, and the literal ADC routes."""
    k, n = s.k, s.n_hnsw
    _, train_s = clock(lambda: db.build_pq_table("hnsw", m=s.pq_m))
    res, first_s = clock(lambda: db.batch_search("hnsw", queries, k, ef=120))
    d, ids = db_arrays(res)
    err = check_dists(base, queries, ids, d, "l2sqr")
    rec_mirror = recall(gt_i, ids)
    steady_s = steady(lambda: db.batch_search("hnsw", queries, k, ef=120))
    one = db.search("hnsw", queries[0].tolist(), k, ef=120)
    check_dists(base, queries[:1], *db_arrays([one])[::-1], "l2sqr")

    qb = queries[:100]
    db.create_table_if_not_exists("pqflat", s.dim, "l2sqr")
    db.batch_add("pqflat", base[:n], [{"i": str(i)} for i in range(n)])
    db.build_pq_table("pqflat", m=s.pq_m)
    res, flat_first_s = clock(lambda: db.batch_search("pqflat", qb, k, ef=120))
    df, if_ = db_arrays(res)
    check_dists(base, qb, if_, df, "l2sqr")
    flat_steady_s = steady(lambda: db.batch_search("pqflat", qb, k, ef=120))
    db.delete_table("pqflat")

    t = table(db, "hnsw")
    out = {}
    for route in ("scan", "graph"):
        (dr, ir), sec = clock(lambda r=route: t.inner.inner.knn_pq_batch(qb, k, 120, t.pq, route=r))
        check_dists(base, qb, ir, dr, "l2sqr")
        out[route] = (recall(gt_i[:100], ir), sec)
    emit({"phase": "pq", "n": n, "m": s.pq_m, "train_s": train_s,
          "mirror_first_s": first_s, "mirror_steady_s": steady_s,
          "mirror_recall_at_10": rec_mirror, "max_rel_dist_err": err,
          "flat_adc_b100_first_s": flat_first_s, "flat_adc_b100_steady_s": flat_steady_s,
          "flat_adc_recall_at_10": recall(gt_i[:100], if_),
          "scan_route_recall_at_10": out["scan"][0], "scan_route_s": out["scan"][1],
          "graph_route_recall_at_10": out["graph"][0], "graph_route_s": out["graph"][1]})
    db.delete_table("hnsw")


def phase_ivf(s, base_dev, base, queries):
    """Phase 4: IVF (nlist=256) at 1M through the binned form; on a slice
    with every list probed it equals exact Flat."""
    from lab_1806_vec_db.models import IVFIndex
    from lab_1806_vec_db.utils.config import IVFConfig

    k = s.k
    ivf, build_s = clock(lambda: IVFIndex.from_numpy(
        base, "l2sqr", IVFConfig(k=s.nlist, k_means_max_iter=10), seed=0))
    _, gt_i = exact_gt(base_dev, queries, k, "l2sqr")
    (d, ids), first_s = clock(lambda: ivf.knn_batch(queries, k, n_probes=16))
    err = check_dists(base, queries, ids, d, "l2sqr")
    steady_s = steady(lambda: ivf.knn_batch(queries, k, n_probes=16))
    rec16 = recall(gt_i, ids)
    del ivf

    m = s.n_slice
    small = IVFIndex.from_numpy(base[:m], "l2sqr", IVFConfig(k=16), seed=0)
    _, si = exact_gt(base_dev[:m], queries, k, "l2sqr")
    _, ig = small.knn_batch(queries[:16], k, n_probes=16)  # per-query gather
    slice_ties = ids_match(base, queries[:16], ig, si[:16])
    db_, ib = small.knn_batch(queries[:100], k, n_probes=16)  # binned
    check_dists(base, queries[:100], ib, db_, "l2sqr")
    emit({"phase": "ivf", "n": s.n_flat, "nlist": s.nlist, "build_s": build_s,
          "first_s": first_s, "steady_s": steady_s, "probes16_recall_at_10": rec16,
          "max_rel_dist_err": err, "slice_all_probes_exact": True,
          "slice_tie_swaps": slice_ties,
          "slice_binned_all_probes_recall_at_10": recall(si[:100], ib)})


def phase_lean(s, base_dev, base, queries, seed):
    """Phase 5: the lean tier at 1M (int8 mirror + bf16 rows, no f32 copy)
    with Flat search: bf16 rerank, then exact refinement of the result."""
    from lab_1806_vec_db.bench import synth
    from lab_1806_vec_db.models import FlatIndex
    from lab_1806_vec_db.models.store import VecStore

    k = s.k
    fill = synth.device_fill(s.dim, seed)
    store, ingest_s = clock(lambda: VecStore.from_device_blocks(
        fill, s.n_flat, s.dim, "l2sqr", block_rows=131072))
    flat = FlatIndex.from_store(store)
    _, gt_i = exact_gt(base_dev, queries, k, "l2sqr")
    (d, ids), first_s = clock(lambda: flat.knn_batch(queries, k))
    err = check_dists(base, queries, ids, d, "l2sqr")
    steady_s = steady(lambda: flat.knn_batch(queries, k))
    emit({"phase": "lean", "n": s.n_flat, "ingest_s": ingest_s, "first_s": first_s,
          "steady_s": steady_s, "recall_at_10": recall(gt_i, ids),
          "max_rel_dist_err": err, "device_bytes": store.device_bytes()})


def _mirror(x_dev, dist):
    """Int8 mirror of device rows in the unified channel convention, rows
    padded to a chunk multiple with the losing sentinel."""
    import jax.numpy as jnp
    from lab_1806_vec_db.ops import distance as D
    from lab_1806_vec_db.ops import topk as T

    n, dim = x_dev.shape
    dim_pad = -(-dim // 128) * 128
    n_pad = -(-n // T.CHUNK) * T.CHUNK
    x = jnp.pad(x_dev, ((0, n_pad - n), (0, dim_pad - dim)))
    b8, sc = T.quantize_rows_int8(x)
    cache = D.dist_cache(x, dist)
    valid = jnp.arange(n_pad) < n
    return b8, jnp.where(valid, sc, 0.0), jnp.where(valid, cache, T.BIG)


def phase_kernel(s, base_dev, base, queries, seed):
    """Phase 6: the Triton-route chunk-min kernel against its plain
    reference (dim 960 and 100, B 1 and 1000), then kernel and plain XLA
    timed at 1M: the scan alone and end to end through FlatIndex.knn_batch."""
    import jax
    import jax.numpy as jnp
    from lab_1806_vec_db.bench import synth
    from lab_1806_vec_db.models import FlatIndex
    from lab_1806_vec_db.models.store import VecStore
    from lab_1806_vec_db.ops import backend
    from lab_1806_vec_db.ops import scan_triton as ST
    from lab_1806_vec_db.ops import topk as T

    checks = []
    for dim in (960, 100):
        x = synth.make_device(s.n_kernel, dim, seed + 2)
        b8, sc, cache = _mirror(x, "l2sqr")
        for B in (1, s.batch):
            q = jnp.asarray(np.asarray(synth.make_device(B, dim, seed + 3)))
            q8, qs2, qc = T.int8_queries(q, b8.shape[1], "l2sqr")
            dk, ik = ST.scan_chunkmin_int8(q8, qs2, qc, b8, sc, cache)
            dr, ir = T.scan_chunkmin_int8(q8, qs2, qc, b8, sc, cache)
            dk, ik, dr, ir = (np.asarray(a) for a in (dk, ik, dr, ir))
            np.testing.assert_allclose(dk, dr, rtol=1e-6, atol=1e-6)
            assert ((ik == ir) | (dk == dr)).all(), "survivor ids differ"
            checks.append({"dim": dim, "B": B, "max_rel_err": float(
                np.max(np.abs(dk - dr) / np.maximum(np.abs(dr), 1e-12))),
                "ids_differ": int((ik != ir).sum())})
    emit({"phase": "kernel_check", "rows": s.n_kernel, "cases": checks})

    flat = FlatIndex.from_store(VecStore.from_device(base_dev, "l2sqr"))
    b8, sc, cache, _ = flat.store.device_int8()
    xla_set = backend.KernelSet(accelerated=True, scan="xla")
    out = {}
    for B in (s.batch, 1):
        q = queries[:B]
        qd = jnp.asarray(q)

        def scan_xla():
            return jax.block_until_ready(T.scan_candidates_int8(
                qd, b8, sc, cache, jnp.int32(b8.shape[0]), 40, "l2sqr"))

        def scan_kernel():
            return jax.block_until_ready(ST.scan_candidates_int8(qd, b8, sc, cache, 40, "l2sqr"))

        def scan_plain_chunkmin():
            q8, qs2, qc = T.int8_queries(qd, b8.shape[1], "l2sqr")
            return jax.block_until_ready(
                T.select_survivors(*T.scan_chunkmin_int8(q8, qs2, qc, b8, sc, cache), 40))

        def e2e_xla():
            with backend.forced(xla_set):
                return flat.knn_batch(q, s.k)

        def e2e_kernel():
            return flat.knn_batch(q, s.k)

        row = {}
        for name, fn in (("scan_xla", scan_xla), ("scan_kernel", scan_kernel),
                         ("scan_plain_chunkmin", scan_plain_chunkmin),
                         ("e2e_xla", e2e_xla), ("e2e_kernel", e2e_kernel)):
            _, row[name + "_first_s"] = clock(fn)
        # parent/change alternation: xla, kernel, kernel, xla
        for name, fn in (("scan_xla", scan_xla), ("scan_kernel", scan_kernel),
                         ("scan_kernel", scan_kernel), ("scan_xla", scan_xla),
                         ("e2e_xla", e2e_xla), ("e2e_kernel", e2e_kernel),
                         ("e2e_kernel", e2e_kernel), ("e2e_xla", e2e_xla)):
            row.setdefault(name + "_s", []).append(steady(fn, reps=5))
        row["scan_plain_chunkmin_s"] = steady(scan_plain_chunkmin, reps=5)
        de, ie = e2e_kernel()
        dx, ix = e2e_xla()
        row["recall_kernel_vs_xla"] = recall(ix, ie)
        out[f"B{B}"] = row
    emit({"phase": "kernel_timing", "n": s.n_flat, "dim": s.dim, "r": 40, **out})


def four_cards(s: Sizes, seed: int) -> None:
    """Only the sharded paths: ShardedFlatIndex over four cards against the
    exact scan of the same rows on card 0 alone, VecDB with VECDB_MESH=4,
    and the sharded IVF (all lists probed) and HNSW (exhaustive ef) against
    exact Flat on a small set."""
    import jax
    import jax.numpy as jnp
    from lab_1806_vec_db import VecDB
    from lab_1806_vec_db.bench import synth
    from lab_1806_vec_db.parallel import sharded as S
    from lab_1806_vec_db.utils.config import HNSWConfig, IVFConfig

    devs = jax.devices()
    assert len(devs) == 4, f"--four-cards needs 4 devices, found {len(devs)}"
    k = s.k
    fill = synth.device_fill(s.dim, seed)
    blocks = [np.asarray(fill(r0, min(131072, s.n_four - r0)))
              for r0 in range(0, s.n_four, 131072)]
    base = np.concatenate(blocks)
    del blocks
    queries = np.asarray(synth.make_device(s.batch, s.dim, seed + 1))
    mesh = S.make_mesh(4)

    sf, build_s = clock(lambda: S.ShardedFlatIndex(mesh, base, "l2sqr"))
    (d4, i4), first_s = clock(lambda: sf.knn_batch(queries, k))
    steady_s = steady(lambda: sf.knn_batch(queries, k))
    with jax.default_device(devs[0]):
        one = jax.device_put(base, devs[0])
        d1, i1 = exact_gt(one, queries, k, "l2sqr")
        del one
    ties = ids_match(base, queries, i4, i1)
    np.testing.assert_allclose(d4, d1, rtol=1e-5, atol=1e-5)
    err = check_dists(base, queries, i4, d4, "l2sqr")

    os.environ["VECDB_MESH"] = "4"
    with tempfile.TemporaryDirectory() as tmp:
        db = VecDB(os.path.join(tmp, "db"))
        db.create_table_if_not_exists("t", s.dim, "l2sqr")
        db.batch_add("t", base, [{"i": str(i)} for i in range(s.n_four)])
        res, db_first_s = clock(lambda: db.batch_search("t", queries, k))
        dd, idb = db_arrays(res)
        assert (idb == i4).all(), "VecDB mesh results differ from ShardedFlatIndex"
        db_steady_s = steady(lambda: db.batch_search("t", queries, k))
        db.close()
    del os.environ["VECDB_MESH"]

    m = s.n_four_small
    small = base[:m]
    _, si = exact_gt(jnp.asarray(small), queries, k, "l2sqr")
    ivf = S.ShardedIVFIndex(mesh, small, "l2sqr", IVFConfig(k=16), seed=0)
    _, iv = ivf.knn_batch(queries, k, n_probes=16)
    ids_match(small, queries, iv, si)
    hn = S.ShardedHNSWIndex(mesh, small, "l2sqr", HNSWConfig(M=16, ef_construction=200), seed=0)
    _, ih = hn.knn_with_ef_batch(queries, k, ef=m // 4)
    ids_match(small, queries, ih, si)
    emit({"phase": "four_cards", "n": s.n_four, "rows_per_card": s.n_four // 4,
          "build_s": build_s, "first_s": first_s, "steady_s": steady_s,
          "qps": s.batch / steady_s, "equals_card0_exact": True, "tie_swaps": ties,
          "max_rel_dist_err": err,
          "vecdb_mesh4_first_s": db_first_s, "vecdb_mesh4_steady_s": db_steady_s,
          "vecdb_mesh4_equal": True, "sharded_ivf_all_probes_exact": True,
          "sharded_hnsw_exhaustive_exact": True})


def run(s: Sizes, seed: int, four: bool) -> None:
    dev = require_gpu()
    print_cards()
    import jax

    from lab_1806_vec_db import VecDB

    t_all = time.perf_counter()
    if four:
        four_cards(s, seed)
    else:
        base_dev, base, queries = make_data(s, seed)
        with tempfile.TemporaryDirectory() as tmp:
            db = VecDB(os.path.join(tmp, "db"))
            phase_flat(s, db, base_dev, base, queries)
            gt_i = phase_hnsw(s, db, base_dev, base, queries)
            phase_pq(s, db, base_dev, base, queries, gt_i)
            db.close()
        phase_ivf(s, base_dev, base, queries)
        phase_lean(s, base_dev, base, queries, seed)
        phase_kernel(s, base_dev, base, queries, seed)
    emit({"phase": "total", "wall_s": time.perf_counter() - t_all,
          "peak_bytes_in_use": (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")})
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}),
        flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)
    run(Sizes(), args.seed, args.four_cards)


if __name__ == "__main__":
    main()
