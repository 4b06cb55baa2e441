"""The platform's kernel set: the one place that asks JAX which device it
runs on.

Every accelerated route reads its choice here.  `accelerated` keeps the
planners' meaning ("an accelerator is present": HNSW and HNSW+PQ serve
batches from the int8 scan mirror, IVF bins large batches); `scan` names
the stage-1 int8 chunk scan.  A platform with no entry is an error, not a
default.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax


@dataclasses.dataclass(frozen=True)
class KernelSet:
    accelerated: bool
    # "xla": plain jnp (ops/topk.scan_candidates_int8); "triton": the Pallas
    # chunk-min kernel on the Triton route (ops/scan_triton.py)
    scan: str


KERNEL_SETS = {
    "cpu": KernelSet(accelerated=False, scan="xla"),
    "gpu": KernelSet(accelerated=True, scan="triton"),
}

_forced: KernelSet | None = None


def kernel_set(platform: str | None = None) -> KernelSet:
    """The kernel set of `platform` (default: JAX's default backend)."""
    if platform is None:
        if _forced is not None:
            return _forced
        platform = jax.default_backend()
    try:
        return KERNEL_SETS[platform]
    except KeyError:
        raise RuntimeError(
            f"no kernel set for platform {platform!r} "
            f"(known: {sorted(KERNEL_SETS)})"
        ) from None


def accelerated() -> bool:
    return kernel_set().accelerated


@contextlib.contextmanager
def forced(ks: KernelSet):
    """Run the enclosed calls with another kernel set: how a measurement
    times one stage-1 kernel against another through the same entry point."""
    global _forced
    prev, _forced = _forced, ks
    try:
        yield
    finally:
        _forced = prev


def scan_candidates_int8(queries, base_i8, base_scale, base_cache, r: int, dist: str):
    """Stage-1 int8 candidates ((B, r) dists, (B, r) mirror rows) through
    this platform's scan kernel.  Validity rides the cache channel: invalid
    mirror rows carry the +BIG sentinel (store.device_int8)."""
    from . import topk as T

    if kernel_set().scan == "triton":
        from . import scan_triton as ST

        return ST.scan_candidates_int8(queries, base_i8, base_scale, base_cache, r, dist)
    n = jax.numpy.int32(base_i8.shape[0])
    return T.scan_candidates_int8(queries, base_i8, base_scale, base_cache, n, r, dist)
