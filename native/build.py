"""Build the native extension in-place.

Usage: python native/build.py
Produces lab_1806_vec_db/_vecdb_native.<abi>.so with g++ (no
pybind11/setuptools dependency at runtime; this is a single-TU extension).
The package also builds it by itself at first use.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from lab_1806_vec_db.models import native

    print(f"Built {native.build()}")
    print("Import OK:", native.available())
