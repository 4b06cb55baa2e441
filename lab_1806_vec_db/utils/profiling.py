"""Tracing / profiling seams.

The reference has no tracing infrastructure — only Instant spans in the
bench harness and an indicatif progress bar for bulk build (SURVEY.md §5).
The framework exposes:
- `trace(dir)`: context manager around `jax.profiler.trace` producing a
  TensorBoard-loadable XLA trace of every kernel in scope;
- `span(name)`: lightweight wall-clock span accumulator (the AvgRecorder
  equivalent, examples/bench.rs AvgRecorder);
- progress callbacks on bulk build (`HNSWIndex.batch_add(progress=...)`),
  mirroring batch_add_process (hnsw_index.rs:576-594).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


@contextlib.contextmanager
def trace(log_dir: str):
    """XLA device trace; view with TensorBoard or xprof."""
    import jax

    with jax.profiler.trace(log_dir):
        yield


class Spans:
    """Named wall-clock accumulators."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def avg(self, name: str) -> float:
        c = self.count[name]
        return self.total[name] / c if c else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self.total):
            lines.append(
                f"{name}: total={self.total[name]:.3f}s n={self.count[name]} avg={self.avg(name)*1000:.2f}ms"
            )
        return "\n".join(lines)


def progress_bar(total: int, label: str = "build"):
    """Simple stderr progress callback factory (indicatif-equivalent)."""
    import sys

    start = time.perf_counter()

    def cb(cur: int, n: int | None = None):
        n = n or total
        elapsed = time.perf_counter() - start
        rate = cur / max(elapsed, 1e-9)
        eta = (n - cur) / max(rate, 1e-9)
        sys.stderr.write(
            f"\r[{label}] {cur}/{n} ({100*cur/max(n,1):.0f}%) {rate:.0f}/s ETA {eta:.0f}s "
        )
        sys.stderr.flush()
        if cur >= n:
            sys.stderr.write("\n")

    return cb
