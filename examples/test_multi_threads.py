"""Concurrent search demo (parity with reference examples/test_multi_threads.py).

Four threads issue overlapping searches; the device calls release the GIL so
the wall-clock should be far below 4x the serial time once warm.
"""

import shutil
import threading
import time

import numpy as np

try:
    from lab_1806_vec_db import VecDB
except ModuleNotFoundError:  # clean checkout, package not installed: run in place
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from lab_1806_vec_db import VecDB

shutil.rmtree("./tmp/mt_db", ignore_errors=True)
db = VecDB("./tmp/mt_db")
db.create_table_if_not_exists("t", 64)
rng = np.random.default_rng(0)
vecs = rng.standard_normal((2000, 64)).astype(np.float32)
db.batch_add("t", vecs.tolist(), [{"i": str(i)} for i in range(len(vecs))])
db.build_hnsw_index("t")

# warm up
db.search("t", vecs[0].tolist(), 5, 50)


def worker(tid: int, n: int = 25):
    for i in range(n):
        res = db.search("t", vecs[(tid * 31 + i) % len(vecs)].tolist(), 5, 50)
        assert len(res) == 5


t0 = time.perf_counter()
threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
for t in threads:
    t.start()
for t in threads:
    t.join()
elapsed = time.perf_counter() - t0
print(f"4 threads x 25 searches in {elapsed:.2f}s")
db.close()
print("Test passed")
