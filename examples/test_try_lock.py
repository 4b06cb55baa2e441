"""Exclusive-lock demo (parity with reference examples/test_try_lock.py).

Opening the same database directory twice must fail.
"""

import shutil

try:
    from lab_1806_vec_db import VecDB
except ModuleNotFoundError:  # clean checkout, package not installed: run in place
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from lab_1806_vec_db import VecDB

shutil.rmtree("./tmp/lock_db", ignore_errors=True)
db = VecDB("./tmp/lock_db")
try:
    VecDB("./tmp/lock_db")
    raise AssertionError("second open must fail")
except RuntimeError as e:
    print(f"Expected failure: {e}")
db.close()
print("Test passed")
