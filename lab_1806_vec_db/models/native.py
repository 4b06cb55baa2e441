"""Loader + wrappers for the native (C++) query engine.

The extension is built from `native/hnsw_native.cpp` on the host that runs
it, at first use (or ahead of time by `python native/build.py`), into the
package directory (listed in .gitignore).  Single-query searches route
through the serial C++ engine (no device dispatch); without a C++ compiler
everything falls back to the batched device kernels.  Both paths traverse
the *same* dense link arrays — there is one index format.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import sysconfig
import tempfile
import time

import numpy as np

DIST_CODE = {"l2sqr": 0, "cosine": 1}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "hnsw_native.cpp")
_native = None
_tried = False


def build(out_dir: str = _PKG_DIR) -> str:
    """Compile the extension with g++ and return its path.  Portable flags:
    the build host's ISA is not baked in, so the library runs on any x86-64
    host with this Python ABI.  Writes to a temp name, then renames, so a
    concurrent importer never loads a half-written file."""
    out = os.path.join(out_dir, "_vecdb_native" + sysconfig.get_config_var("EXT_SUFFIX"))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden",
        "-funroll-loops", f"-I{sysconfig.get_paths()['include']}", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    """Import the extension, building it first if it is missing.  A build
    lock serialises concurrent first users (e.g. parallel test workers)."""
    global _native, _tried
    if _tried:
        return _native
    _tried = True
    name = f"{__package__.rsplit('.', 1)[0]}._vecdb_native"
    try:
        _native = importlib.import_module(name)
        return _native
    except ImportError:
        pass
    if not os.path.exists(_SRC):
        return None
    import fcntl

    with open(os.path.join(_PKG_DIR, ".native_build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            _native = importlib.import_module(name)  # built while we waited
            return _native
        except ImportError:
            pass
        t0 = time.perf_counter()
        try:
            build()
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            print(f"[vecdb] native engine build failed; single queries use the "
                  f"device path: {detail.strip()[:500]}", file=sys.stderr)
            return None
        print(f"[vecdb] set-up: built the native engine in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        importlib.invalidate_caches()
        _native = importlib.import_module(name)
    return _native


def available() -> bool:
    return _load() is not None


def hnsw_knn_single(index, query: np.ndarray, k: int, ef: int):
    """Serial native HNSW search. Returns (ids, dists) lists or None if the
    native module is unavailable."""
    native = _load()
    if native is None or index.entry_point is None:
        return None
    query = np.ascontiguousarray(query, dtype=np.float32)
    vecs = index.store._host()  # materializes device-born stores
    if vecs.dtype != np.float32:
        return None
    n = len(index.store)
    upper = []
    for ul in index.upper[: (index.enter_level or 0)]:
        upper.append((ul.pos, ul.links[: max(ul.n, 1)]))
    ids, dists = native.hnsw_knn(
        vecs,
        index.links0,
        upper,
        int(index.entry_point),
        query,
        int(k),
        int(max(ef, k)),
        DIST_CODE[index.dist],
        n,
    )
    return ids, dists


def flat_knn_single(store, query: np.ndarray, k: int):
    """Serial native exact scan. Returns (ids, dists) lists or None."""
    native = _load()
    if native is None or store.tier == "lean":
        return None
    if store._host().dtype != np.float32:
        return None
    query = np.ascontiguousarray(query, dtype=np.float32)
    ids, dists = native.flat_knn(
        store._host(), query, len(store), int(k), DIST_CODE[store.dist]
    )
    return ids, dists
