"""lab_1806_vec_db — a vector index-and-query engine on JAX/XLA.

A from-scratch JAX re-design with the capabilities of the Rust reference
`pku-lab-1806-llm/lab-1806-vec-db` (v0.8.1): four search paths (Flat
brute-force, HNSW, IVF, PQ-accelerated ADC over Flat/HNSW) plus a
thread-safe, auto-saving, multi-table database layer with string-keyed
metadata filtering.  It runs on an NVIDIA GPU (and on CPU for tests).

Design stance (batched device work, not a port):
- distance = batched GEMM (`ops/distance.py`)
- top-k = blocked running top-k over distance tiles (`ops/topk.py`)
- stage-1 int8 scan = the platform's kernel (`ops/backend.py`)
- HNSW traversal = batched lock-step beam search with gathered neighbor
  blocks (`ops/beam.py`), not pointer chasing
- IVF = centroid GEMM + padded posting-list gather + masked scan
- PQ ADC = lookup-table gather-accumulate
- several devices = `jax.sharding.Mesh` + `shard_map`, per-shard top-k and
  all-gather merge (`parallel/`)

Public API parity contract: the reference's Python stub
`lab_1806_vec_db.pyi` (VecDB + calc_dist).
"""

from .utils import jit_cache as _jit_cache

_jit_cache.enable()

__version__ = "0.1.0"

__all__ = ["VecDB", "calc_dist", "__version__"]


def __getattr__(name):
    # Lazy import: keep `import lab_1806_vec_db.ops` cheap for kernel-only
    # users while exposing the reference-parity API at the top level.
    if name in ("VecDB", "calc_dist"):
        from .db import api

        return getattr(api, name)
    raise AttributeError(name)
