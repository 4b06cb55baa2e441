"""Behavioral contract of the `VecDB` Python API.

Exercises the index-lifecycle invariants documented in the reference README
(reference: src/database/metadata_vec_table.rs:64-187 — writes keep HNSW but
clear PQ, deletes clear HNSW and PQ) plus upper-bound-filtered search, in an
original walkthrough structure.

Run: python examples/test_pyo3.py
"""

import shutil
import tempfile

try:
    from lab_1806_vec_db import VecDB
except ModuleNotFoundError:  # clean checkout, package not installed: run in place
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from lab_1806_vec_db import VecDB

TABLE = "fruits"
DIM = 4

ROWS = [
    ([1.0, 0.0, 0.0, 0.0], {"name": "apple"}),
    ([0.0, 1.0, 0.0, 0.0], {"name": "banana"}),
    ([0.0, 0.0, 1.0, 0.0], {"name": "cherry"}),
    ([0.5, 0.5, 0.5, 0.5], {"name": "durian", "status": "stale"}),
]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"contract violated: {what}")


def main() -> None:
    workdir = tempfile.mkdtemp(prefix="vecdb_api_")
    db = VecDB(workdir)
    try:
        check(db.get_all_keys() == [], "fresh directory starts with no tables")

        db.create_table_if_not_exists(TABLE, DIM)
        vec0, meta0 = ROWS[0]
        vec1, meta1 = ROWS[1]
        db.add(TABLE, vec0, meta0)
        db.add(TABLE, vec1, meta1)

        # building on a 2-row table, then appending: adds must NOT drop the
        # graph (the reference re-links incrementally instead)
        db.build_hnsw_index(TABLE)
        for vec, meta in ROWS[2:]:
            db.add(TABLE, vec, meta)
        check(db.has_hnsw_index(TABLE), "incremental add preserves the HNSW index")
        check(db.get_len(TABLE) == len(ROWS), "row count tracks adds")

        # deleting by metadata pattern removes the row AND invalidates the
        # graph (swap_remove renumbers rows, so HNSW cannot survive)
        db.delete(TABLE, {"status": "stale"})
        check(db.get_len(TABLE) == len(ROWS) - 1, "pattern delete removed one row")
        check(not db.has_hnsw_index(TABLE), "delete clears the HNSW index")

        # rebuild both acceleration structures, then search with a distance
        # ceiling tight enough that only the identical row qualifies
        db.build_hnsw_index(TABLE)
        db.build_pq_table(TABLE)
        hits = db.search(TABLE, vec0, k=3, ef=None, upper_bound=0.5)
        print(hits)
        check(len(hits) == 1, "upper_bound=0.5 admits exactly the exact match")
        metadata, dist = hits[0]
        check(metadata["name"] == "apple", "nearest row is the identical vector")
        check(dist == 0.0, "self-distance is zero")
    finally:
        db.close()
        shutil.rmtree(workdir, ignore_errors=True)
    print("Test passed")


if __name__ == "__main__":
    main()
