"""Generate exact ground truth for a test set with the Flat index.

Parity target: src/bin/gen_gnd.rs (k=10 exact kNN for every test query).
The rayon-parallel per-query loop (gen_gnd.rs:65-68) becomes one batched
blocked GEMM scan on the device.

Usage: python -m lab_1806_vec_db.cli.gen_gnd --base BASE --test TEST -o OUT
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models import FlatIndex
from ..utils import io
from ..utils.candidates import GroundTruth


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Generate ground truth by FlatIndex")
    ap.add_argument("-d", "--dim", type=int, default=960)
    ap.add_argument("--base", default="data/gist.local.bin")
    ap.add_argument("--test", default="data/gist_test.bin")
    ap.add_argument("-o", "--out", default="data/gnd.local.npz")
    ap.add_argument("--dist-fn", default="L2Sqr", choices=["L2Sqr", "Cosine"])
    ap.add_argument("-k", type=int, default=10)
    args = ap.parse_args(argv)

    dist = args.dist_fn.lower()
    base = io.load_raw(args.base, args.dim, "float32")
    print(f"Loaded base set (size: {len(base)}).")
    test = io.load_raw(args.test, args.dim, "float32")
    print(f"Loaded test set (size: {len(test)}).")

    index = FlatIndex.from_numpy(base, dist)
    print("Generating ground truth...")
    # batch queries through the device scan
    rows = []
    B = 256
    for s in range(0, len(test), B):
        # exact=True: ground truth must be the exact f32 scan, not the
        # two-stage selection path (gen_gnd.rs parity: exact FlatIndex kNN)
        _, ids = index.knn_batch(test[s : s + B], args.k, exact=True)
        rows.append(ids)
    gt = GroundTruth(np.concatenate(rows, axis=0))
    print(f"Saving ground truth to {args.out}...")
    gt.save(args.out)


if __name__ == "__main__":
    main()
