"""Raw vector file IO.

Capability parity with the reference's binary formats:
- headerless raw binary of `len x dim` scalars, row-major
  (reference: src/scalar.rs:89-105, src/vec_set.rs:168-192)
- fvecs records: `u32 dim` followed by `dim` f32 values per vector
  (reference: src/bin/convert_fvecs.rs:29-48)

On the device the storage substrate is a padded `(N_pad, dim)` device array with an
explicit row count; loaders here produce host numpy arrays that the index
layer pads and uploads.
"""

from __future__ import annotations

import os

import numpy as np

# dtype mapping mirrors the reference's DataType enum {float32, uint8}
# (reference: src/config.rs:20-27)
_DTYPES = {
    "float32": np.float32,
    "uint8": np.uint8,
}


def dtype_from_name(name: str) -> np.dtype:
    try:
        return np.dtype(_DTYPES[name])
    except KeyError:
        raise ValueError(f"Unsupported data_type: {name!r} (expected one of {sorted(_DTYPES)})")


def dtype_to_name(dtype) -> str:
    dtype = np.dtype(dtype)
    for name, dt in _DTYPES.items():
        if np.dtype(dt) == dtype:
            return name
    raise ValueError(f"Unsupported dtype: {dtype}")


def load_raw(path: str | os.PathLike, dim: int, dtype="float32", limit: int | None = None) -> np.ndarray:
    """Load a headerless raw binary file of vectors as an (n, dim) array.

    Mirrors `VecSet::load_raw_file` (reference: src/vec_set.rs:168-182) with
    the optional `limit` row cap of `VecDataConfig` (src/config.rs:31-40).
    """
    if dim <= 0:
        raise ValueError("dim must be positive")
    dt = np.dtype(dtype) if not isinstance(dtype, str) else dtype_from_name(dtype)
    count = -1
    if limit is not None:
        count = limit * dim
    data = np.fromfile(os.fspath(path), dtype=dt, count=count)
    n = len(data) // dim
    if n * dim != len(data) and limit is None:
        raise ValueError(
            f"File size {len(data)} elements is not a multiple of dim={dim}"
        )
    return data[: n * dim].reshape(n, dim)


def save_raw(path: str | os.PathLike, vectors: np.ndarray) -> None:
    """Save vectors as a headerless raw binary file.

    Mirrors `VecSet::save_raw_file` (reference: src/vec_set.rs:184-192).
    """
    arr = np.ascontiguousarray(vectors)
    arr.tofile(os.fspath(path))


def load_fvecs(path: str | os.PathLike, limit: int | None = None) -> np.ndarray:
    """Load an fvecs file: records of (u32 dim, f32 x dim).

    Mirrors the input side of convert_fvecs (reference:
    src/bin/convert_fvecs.rs:29-48). All records must share one dim.
    """
    raw = np.fromfile(os.fspath(path), dtype=np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=np.float32)
    dim = int(np.frombuffer(raw[:4].tobytes(), dtype=np.uint32)[0])
    record = 4 + 4 * dim
    n = raw.size // record
    if n * record != raw.size:
        raise ValueError("fvecs file size is not a multiple of the record size")
    if limit is not None:
        n = min(n, limit)
    recs = raw[: n * record].reshape(n, record)
    dims = recs[:, :4].copy().view(np.uint32).reshape(n)
    if not np.all(dims == dim):
        raise ValueError("fvecs records have inconsistent dims")
    vecs = recs[:, 4:].copy().view(np.float32).reshape(n, dim)
    return vecs
