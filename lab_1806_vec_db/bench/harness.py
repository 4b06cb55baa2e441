"""Benchmark harness: TOML-driven ef sweeps with recall@k and ms/query.

Parity target: examples/bench.rs — load base/test sets + exact ground truth,
build-or-load the index (and PQ table) with timing and a disk cache
(bench.rs:171-266), sweep ef (range or list), measure average ms/query and
recall@10, merge results into a cumulative ResultList TOML
(bench.rs:312-368), and emit a recall-vs-throughput HTML plot.

The reference's `-t` multi-threaded query fan-out (bench.rs:414-418) maps to
device query *batching*: all test queries advance through one jitted batched
kernel; ms/query = wall-clock / n_queries.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..models import FlatIndex, HNSWIndex, IVFIndex, PQTable
from ..utils import io
from ..utils.candidates import GroundTruth
from ..utils.config import BenchConfig
from ..utils.serde import atomic_write_bytes


def _fmt_floats(xs) -> str:
    inner = ",\n    ".join(repr(float(x)) for x in xs)
    return "[\n    " + inner + ",\n]"


class ResultList:
    """Cumulative results TOML (bench.rs:312-368): one [[results]] block per
    label, replaced wholesale when re-run."""

    def __init__(self, title: str = ""):
        self.title = title
        self.results: dict[str, dict] = {}

    @classmethod
    def load(cls, path: str) -> "ResultList":
        import tomllib

        self = cls()
        if os.path.exists(path):
            with open(path, "rb") as f:
                d = tomllib.load(f)
            self.title = d.get("title", "")
            for r in d.get("results", []):
                self.results[r["label"]] = r
        return self

    def update(
        self,
        label: str,
        ef: list[int],
        search_time: list[float],
        recall: list[float],
        search_time_median: list[float] | None = None,
        build_seconds: float | None = None,
        index_device_bytes: int | None = None,
        chained: bool = False,
    ):
        """One row per label.  Beyond the reference's ef/search_time/recall
        (bench.rs:312-368) rows carry the BASELINE-mandated fields: per-ef
        median ms/query (shared-chip honesty), build wall-clock (the
        reference prints but does not commit it, bench.rs:199-206), and the
        index's device-memory footprint (the BASELINE.md "equal index memory"
        clause needs it committed)."""
        row = {
            "label": label,
            "ef": list(ef),
            "search_time": [float(x) for x in search_time],
            "recall": [float(x) for x in recall],
        }
        if search_time_median is not None:
            row["search_time_median"] = [float(x) for x in search_time_median]
        if build_seconds is not None:
            row["build_seconds"] = round(float(build_seconds), 2)
        if index_device_bytes is not None:
            row["index_device_bytes"] = int(index_device_bytes)
        if chained:
            # per-row methodology flag (VERDICT r4 weak-3): chained rows
            # time the device-resident step (bench.py's methodology);
            # rows without the flag are wall-clock incl. host conversion
            # + per-call sync
            row["chained"] = True
        self.results[label] = row

    def save(self, path: str) -> None:
        lines = [f'title = "{self.title}"', ""]
        for r in self.results.values():
            lines.append("[[results]]")
            lines.append(f'label = "{r["label"]}"')
            lines.append(f'ef = {list(r["ef"])}')
            if r.get("chained"):
                lines.append("chained = true")
            if "build_seconds" in r:
                lines.append(f'build_seconds = {r["build_seconds"]!r}')
            if "index_device_bytes" in r:
                lines.append(f'index_device_bytes = {r["index_device_bytes"]}')
            lines.append(f'search_time = {_fmt_floats(r["search_time"])}')
            if "search_time_median" in r:
                lines.append(f'search_time_median = {_fmt_floats(r["search_time_median"])}')
            lines.append(f'recall = {_fmt_floats(r["recall"])}')
            lines.append("")
        atomic_write_bytes(path, "\n".join(lines).encode())

    def plot_html(self, path: str) -> None:
        """Recall-vs-QPS scatter (bench.rs:334-358).  Self-contained HTML via
        a tiny inline SVG — no plotting dependency required."""
        series = []
        colors = ["#4269d0", "#efb118", "#ff725c", "#6cc5b0", "#3ca951", "#ff8ab7"]
        for idx, r in enumerate(self.results.values()):
            qps = [1000.0 / max(t, 1e-9) for t in r["search_time"]]
            series.append((r["label"], r["recall"], qps, colors[idx % len(colors)]))
        if not series:
            atomic_write_bytes(path, b"<html><body>No results</body></html>")
            return
        all_q = [q for _, _, qs, _ in series for q in qs]
        all_r = [x for _, rs, _, _ in series for x in rs]
        qmin, qmax = min(all_q) * 0.8, max(all_q) * 1.2
        rmin, rmax = min(all_r) - 0.02, min(1.0, max(all_r) + 0.02)
        W, H, PAD = 720, 480, 60

        def sx(r):
            return PAD + (r - rmin) / max(rmax - rmin, 1e-9) * (W - 2 * PAD)

        def sy(q):
            import math

            lo, hi = math.log10(qmin), math.log10(qmax)
            return H - PAD - (math.log10(q) - lo) / max(hi - lo, 1e-9) * (H - 2 * PAD)

        parts = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" font-family="sans-serif">',
            f'<text x="{W/2}" y="20" text-anchor="middle" font-size="14">{self.title}</text>',
            f'<text x="{W/2}" y="{H-10}" text-anchor="middle" font-size="12">recall@10</text>',
            f'<text x="15" y="{H/2}" transform="rotate(-90 15 {H/2})" text-anchor="middle" font-size="12">QPS (log)</text>',
        ]
        for li, (label, rs, qs, color) in enumerate(series):
            pts = " ".join(f"{sx(r):.1f},{sy(q):.1f}" for r, q in zip(rs, qs))
            parts.append(
                f'<polyline fill="none" stroke="{color}" stroke-width="2" points="{pts}"/>'
            )
            for r, q in zip(rs, qs):
                parts.append(
                    f'<circle cx="{sx(r):.1f}" cy="{sy(q):.1f}" r="3" fill="{color}"/>'
                )
            parts.append(
                f'<text x="{W-PAD}" y="{PAD + 16*li}" text-anchor="end" fill="{color}" font-size="12">{label}</text>'
            )
        parts.append("</svg>")
        html = "<html><body>" + "".join(parts) + "</body></html>"
        atomic_write_bytes(path, html.encode())


def load_or_build_sharded(config: BenchConfig, base: np.ndarray, seed: int = 42):
    """Mesh-sharded build-or-load (the `mesh = N` config key): the sharded
    counterpart of `load_or_build_index`, over the first N devices."""
    from ..parallel import sharded as S

    mesh = S.make_mesh(config.mesh)
    algo = config.algorithm.name
    cache = config.index_cache
    cls = {
        "Flat": S.ShardedFlatIndex,
        "HNSW": S.ShardedHNSWIndex,
        "IVF": S.ShardedIVFIndex,
    }[algo]
    if config.pq is not None:
        if algo != "Flat":
            raise ValueError("mesh sweeps support PQ on Flat only")
        cls = S.ShardedPQFlatIndex
    if cache and os.path.exists(cache):
        t0 = time.perf_counter()
        index = cls.load(cache, mesh, external_base=base)
        print(f"Loaded sharded {algo} index from {cache} in {time.perf_counter()-t0:.2f}s")
        return index, None
    t0 = time.perf_counter()
    if algo == "Flat":
        if config.pq is not None:
            pq, _ = load_or_build_pq(config, base, seed)
            index = S.ShardedPQFlatIndex(mesh, base, pq, config.dist)
        else:
            index = S.ShardedFlatIndex(mesh, base, config.dist)
    elif algo == "HNSW":
        index = S.ShardedHNSWIndex(mesh, base, config.dist, config.algorithm.hnsw, seed=seed)
    else:
        index = S.ShardedIVFIndex(mesh, base, config.dist, config.algorithm.ivf, seed=seed)
    build_s = time.perf_counter() - t0
    print(f"Built sharded {algo} index over {config.mesh} devices in {build_s:.2f}s")
    if cache:
        index.save(cache, include_vectors=False)
    return index, build_s


def load_or_build_index(config: BenchConfig, base: np.ndarray, seed: int = 42):
    """Disk-cached index build with timing (bench.rs:208-266)."""
    algo = config.algorithm.name
    cache = config.index_cache
    if cache and os.path.exists(cache):
        t0 = time.perf_counter()
        cls = {"Flat": FlatIndex, "HNSW": HNSWIndex, "IVF": IVFIndex}[algo]
        index = cls.load(cache, external_vectors=base) if algo != "Flat" else FlatIndex.from_numpy(base, config.dist)
        print(f"Loaded index from {cache} in {time.perf_counter()-t0:.2f}s")
        return index, None
    t0 = time.perf_counter()
    if algo == "Flat":
        index = FlatIndex.from_numpy(base, config.dist)
    elif algo == "HNSW":
        index = HNSWIndex.build(base, config.dist, config.algorithm.hnsw, seed=seed)
    elif algo == "IVF":
        index = IVFIndex.from_numpy(base, config.dist, config.algorithm.ivf, seed=seed)
    else:
        raise ValueError(algo)
    build_s = time.perf_counter() - t0
    print(f"Built {algo} index in {build_s:.2f}s")
    if cache and algo != "Flat":
        index.save(cache, include_vectors=False)
    return index, build_s


def load_or_build_pq(config: BenchConfig, base: np.ndarray, seed: int = 42):
    if config.pq is None:
        return None, None
    cache = config.pq_cache
    if cache and os.path.exists(cache):
        t0 = time.perf_counter()
        pq = PQTable.load(cache)
        print(f"Loaded PQ table from {cache} in {time.perf_counter()-t0:.2f}s")
        return pq, None
    t0 = time.perf_counter()
    pq = PQTable.train(base, config.pq, seed=seed)
    build_s = time.perf_counter() - t0
    print(f"Trained PQ table in {build_s:.2f}s")
    if cache:
        pq.save(cache)
    return pq, build_s


def _device_step(index, pq, k: int):
    """Device-in/device-out search step for the chained timing mode.

    Performs the SAME computation the public batched API dispatches for
    this (index, pq) combination on the current backend — minus the host
    numpy conversion and the per-call device sync, which the chained
    methodology deliberately excludes (declared per-row via
    `chained = true`).  Returns
    `step(q_dev, ef) -> (d_dev, i_dev)` or None when no device-resident
    path exists (the caller then falls back to wall-clock timing)."""
    from ..ops import backend
    from ..ops import topk as T

    accelerated = backend.accelerated()
    if pq is not None:
        if isinstance(index, HNSWIndex):
            store = index.store
            if accelerated and getattr(store, "_mirror_layout", "scan") == "scan":
                # knn_pq_batch's auto route with an accelerator: the int8
                # mirror scan
                fi = FlatIndex.from_store(store)
                return lambda q, ef: fi._knn_device(q, k, rerank_depth=ef)
            return None  # graph/scan ADC routes return host arrays
        if isinstance(index, FlatIndex):
            # the literal ADC scan + exact rerank (flat_index.rs:84-104)
            store = index.store
            pq.warn_if_unreliable("bench chained step (ADC ordering)")
            if not accelerated:
                return None

            def step(q, ef):
                lookup, q_norms = pq.create_lookup(q)
                _, cand = pq.adc_scan(lookup, q_norms, max(ef, k))
                d, i = T.exact_distances_sorted(
                    q, store.device_rerank(), cand, index.dist)
                return d[:, :k], i[:, :k]

            return step
        return None
    if isinstance(index, HNSWIndex):
        store = index.store
        if accelerated and getattr(store, "_mirror_layout", "scan") == "scan":
            # knn_with_ef_batch's auto route with an accelerator: scan +
            # exact rerank
            fi = FlatIndex.from_store(store)
            return lambda q, ef: fi._knn_device(q, k, rerank_depth=ef)
        return None
    if isinstance(index, IVFIndex):
        return lambda q, ef: index._knn_device_binned(q, k, n_probes=ef)
    if isinstance(index, FlatIndex):
        return lambda q, ef: index._knn_device(q, k)
    return None


def run_bench(
    config: BenchConfig,
    repeat: int = 1,
    batch: int = 0,
    out_title: str | None = None,
) -> dict:
    base = io.load_raw(config.base.data_path, config.base.dim, config.base.data_type, config.base.limit).astype(np.float32)
    test = io.load_raw(config.test.data_path, config.test.dim, config.test.data_type, config.test.limit).astype(np.float32)
    print(f"Loaded base ({len(base)}) and test ({len(test)}) sets.")

    gt = GroundTruth.load(config.gnd_path)
    k = gt.k

    if config.mesh > 0:
        from ..parallel import sharded as S

        index, build_s = load_or_build_sharded(config, base)
        pq = None  # ShardedPQFlatIndex carries its table internally

        def search_all(ef: int) -> np.ndarray:
            B = batch or len(test)
            out = []
            for s in range(0, len(test), B):
                q = test[s : s + B]
                if isinstance(index, S.ShardedHNSWIndex):
                    _, ids = index.knn_with_ef_batch(q, k, ef)
                elif isinstance(index, S.ShardedIVFIndex):
                    _, ids = index.knn_batch(q, k, n_probes=ef)
                elif isinstance(index, S.ShardedPQFlatIndex):
                    _, ids = index.knn_batch(q, k, ef=ef)
                else:
                    _, ids = index.knn_batch(q, k)
                out.append(ids)
            return np.concatenate(out, axis=0)

    else:
        index, build_s = load_or_build_index(config, base)
        pq, pq_build_s = load_or_build_pq(config, base)
        if pq_build_s is not None:
            build_s = (build_s or 0.0) + pq_build_s

        def search_all(ef: int) -> np.ndarray:
            B = batch or len(test)
            out = []
            for s in range(0, len(test), B):
                q = test[s : s + B]
                if pq is not None:
                    _, ids = index.knn_pq_batch(q, k, ef, pq)
                elif isinstance(index, HNSWIndex):
                    _, ids = index.knn_with_ef_batch(q, k, ef)
                elif isinstance(index, IVFIndex):
                    _, ids = index.knn_batch(q, k, n_probes=ef)
                else:
                    _, ids = index.knn_batch(q, k)
                out.append(ids)
            return np.concatenate(out, axis=0)

    step = None
    if config.chained and config.mesh == 0:
        step = _device_step(index, pq, k)
        if step is None:
            print("chained = true requested but no device-resident step "
                  "exists for this configuration; falling back to "
                  "wall-clock timing (row will NOT carry the flag)")

    efs, times, medians, recalls = [], [], [], []
    for ef in config.ef:
        if step is not None:
            import jax.numpy as jnp

            q_dev = jnp.asarray(test)
            d0, ids_dev = step(q_dev, ef)  # warm-up/compile + recall ids
            ids = np.asarray(ids_dev)
            # chained rounds: batches linked through a scalar data
            # dependency so every dispatch must execute; best of rounds
            # reported, median alongside
            reps = max(repeat, 4)
            rounds = 4
            rep_times = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                s = jnp.float32(0.0)
                for _ in range(reps):
                    d_out, _ = step(q_dev + s * 1e-30, ef)
                    s = s + d_out[0, 0] * 1e-30
                np.asarray(s)
                rep_times.append((time.perf_counter() - t0) / reps)
            scale = 1000.0 / len(test)
            ms_per_query = min(rep_times) * scale
            ms_median = float(np.median(rep_times)) * scale
        else:
            search_all(ef)  # warm-up/compile
            rep_times = []
            for _ in range(repeat):
                t0 = time.perf_counter()
                ids = search_all(ef)
                rep_times.append(time.perf_counter() - t0)
            scale = 1000.0 / len(test)
            ms_per_query = sum(rep_times) / len(rep_times) * scale
            ms_median = float(np.median(rep_times)) * scale
        recall = gt.batch_recall(ids)
        print(f"ef: {ef}, Average Search Time: {ms_per_query:.4f}ms, Average recall: {recall:.4f}")
        efs.append(ef)
        times.append(ms_per_query)
        medians.append(ms_median)
        recalls.append(recall)

    # device-memory footprint AFTER the sweep (mirrors/caches materialize
    # lazily on first search)
    index_bytes = None
    if hasattr(index, "index_bytes"):
        try:
            index_bytes = int(index.index_bytes())
            if pq is not None:
                index_bytes += int(pq.device_bytes())
        except Exception:
            index_bytes = None

    if config.bench_output:
        rl = ResultList.load(config.bench_output)
        if out_title:
            rl.title = out_title
        elif not rl.title:
            rl.title = f"Bench (N={len(base)}, dim={base.shape[1]}, device-batched)"
        rl.update(config.label, efs, times, recalls,
                  search_time_median=medians, build_seconds=build_s,
                  index_device_bytes=index_bytes, chained=step is not None)
        rl.save(config.bench_output)
        rl.plot_html(os.path.splitext(config.bench_output)[0] + ".html")
        print(f"Results merged into {config.bench_output}")
    return {"label": config.label, "ef": efs, "search_time": times,
            "search_time_median": medians, "recall": recalls,
            "build_seconds": build_s, "index_device_bytes": index_bytes}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Index benchmark (examples/bench.rs parity)")
    ap.add_argument("config", help="Path to the bench TOML config")
    ap.add_argument("-r", "--repeat", type=int, default=1)
    ap.add_argument("-b", "--batch", type=int, default=0, help="query batch size (0 = all)")
    ap.add_argument("--chained", action="store_true",
                    help="device-resident chained timing (see BenchConfig.chained)")
    args = ap.parse_args(argv)
    config = BenchConfig.load_from_toml_file(args.config)
    if args.chained:
        config.chained = True
    run_bench(config, repeat=args.repeat, batch=args.batch)


if __name__ == "__main__":
    main()
