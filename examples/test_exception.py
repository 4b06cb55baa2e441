"""Crash-safety demo (parity with reference examples/test_exception.py).

Data written before an exception must reach disk: the auto-saver flushes
dirty state periodically and `close()`/atexit flush the rest.
"""

import shutil

try:
    from lab_1806_vec_db import VecDB
except ModuleNotFoundError:  # clean checkout, package not installed: run in place
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from lab_1806_vec_db import VecDB

shutil.rmtree("./tmp/exc_db", ignore_errors=True)

try:
    db = VecDB("./tmp/exc_db")
    db.create_table_if_not_exists("t", 4)
    db.add("t", [1.0, 0.0, 0.0, 0.0], {"name": "a"})
    raise KeyboardInterrupt("simulated interrupt")
except KeyboardInterrupt as e:
    print(f"Interrupted: {e}")
    # the manager is still alive; Drop-equivalent flush happens on close/atexit
    db.close()

db2 = VecDB("./tmp/exc_db")
assert db2.get_len("t") == 1, "data must survive the interrupt"
res = db2.search("t", [1.0, 0.0, 0.0, 0.0], 1)
assert res[0][0]["name"] == "a"
db2.close()
print("Test passed")
