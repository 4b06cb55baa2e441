"""Stage-1 int8 chunk-min scan as a Pallas kernel on the Triton route.

One block computes the int8 x int8 -> int32 dot of a query tile against one
CHUNK-row base tile on the tensor cores, applies the per-row dequant and
cache epilogue in f32 (the unified channel formula, `topk.query_channels`),
and reduces the chunk to its (min, argmin) per query.  Blocks run in
parallel over (query tile, base chunk) and carry nothing between them, so
the (B, N) distance matrix never reaches device memory: the plain XLA form
(`topk.scan_candidates_int8`) writes it and reads it back for selection.

The survivor contract is exactly `topk.scan_chunkmin_int8`'s, the plain
reference this kernel is tested against; both feed `topk.select_survivors`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import topk as T

_BK = 128  # contraction tile (the int8 mirror pads dim to a multiple of 128)
# Rows per kernel call: keeps every element offset inside int32 at any N.
_SEG_BYTES = (1 << 31) - 1


def _query_tile(B: int) -> int:
    return 16 if B <= 16 else 32 if B <= 32 else 64


def _kernel(q_ref, qs2_ref, qc_ref, base_ref, scale_ref, cache_ref,
            dmin_ref, imin_ref, *, bq: int, dim_pad: int):
    qt = pl.program_id(0)
    c = pl.program_id(1)

    def body(kk, acc):
        cols = pl.ds(pl.multiple_of(kk * _BK, _BK), _BK)
        q = q_ref[pl.ds(pl.multiple_of(qt * bq, bq), bq), cols]  # (bq, BK)
        b = base_ref[pl.ds(pl.multiple_of(c * T.CHUNK, T.CHUNK), T.CHUNK), cols]
        return acc + jax.lax.dot_general(
            q, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
        )

    acc = jax.lax.fori_loop(
        0, dim_pad // _BK, body, jnp.zeros((bq, T.CHUNK), jnp.int32)
    )
    d = (cache_ref[...][None, :] + qc_ref[...][:, None]) - acc.astype(
        jnp.float32
    ) * (scale_ref[...][None, :] * qs2_ref[...][:, None])
    dmin_ref[...] = jnp.min(d, axis=1)
    imin_ref[...] = c * T.CHUNK + jnp.argmin(d, axis=1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("interpret",))
def scan_chunkmin_int8(
    q8: jax.Array,  # (B, dim_pad) int8
    qs2: jax.Array,  # (B,) f32
    qc: jax.Array,  # (B,) f32
    base_i8: jax.Array,  # (N_pad, dim_pad) int8
    base_scale: jax.Array,  # (N_pad,) f32
    base_cache: jax.Array,  # (N_pad,) f32, +BIG on invalid rows
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Chunk-min survivors ((B, S) f32, (B, S) int32), S = ceil(N_pad /
    CHUNK): the kernel form of `topk.scan_chunkmin_int8`.  Rows padded up
    to a CHUNK multiple carry the losing sentinel."""
    B, dim_pad = q8.shape
    if dim_pad % _BK:
        raise ValueError(f"dim_pad={dim_pad} must be a multiple of {_BK}")
    n_pad = base_i8.shape[0]
    n_chunks = -(-n_pad // T.CHUNK)
    if n_chunks * T.CHUNK != n_pad:
        extra = n_chunks * T.CHUNK - n_pad
        base_i8 = jnp.pad(base_i8, ((0, extra), (0, 0)))
        base_scale = jnp.pad(base_scale, (0, extra))
        base_cache = jnp.pad(base_cache, (0, extra), constant_values=T.BIG)
    bq = _query_tile(B)
    b_pad = -(-B // bq) * bq
    if b_pad != B:
        q8 = jnp.pad(q8, ((0, b_pad - B), (0, 0)))
        qs2 = jnp.pad(qs2, (0, b_pad - B))
        qc = jnp.pad(qc, (0, b_pad - B))
    seg_chunks = max(1, _SEG_BYTES // (dim_pad * T.CHUNK))
    kernel = functools.partial(_kernel, bq=bq, dim_pad=dim_pad)
    parts_d, parts_i = [], []
    for c0 in range(0, n_chunks, seg_chunks):
        s = min(seg_chunks, n_chunks - c0)
        rows = slice(c0 * T.CHUNK, (c0 + s) * T.CHUNK)
        dm, im = pl.pallas_call(
            kernel,
            grid=(b_pad // bq, s),
            in_specs=[
                # whole arrays: the block loads its own tiles (a K loop)
                pl.BlockSpec((b_pad, dim_pad), lambda i, c: (0, 0)),
                pl.BlockSpec((bq,), lambda i, c: (i,)),
                pl.BlockSpec((bq,), lambda i, c: (i,)),
                pl.BlockSpec((s * T.CHUNK, dim_pad), lambda i, c: (0, 0)),
                pl.BlockSpec((T.CHUNK,), lambda i, c: (c,)),
                pl.BlockSpec((T.CHUNK,), lambda i, c: (c,)),
            ],
            out_specs=[
                pl.BlockSpec((None, bq), lambda i, c: (c, i)),
                pl.BlockSpec((None, bq), lambda i, c: (c, i)),
            ],
            out_shape=[
                jax.ShapeDtypeStruct((s, b_pad), jnp.float32),
                jax.ShapeDtypeStruct((s, b_pad), jnp.int32),
            ],
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=3),
            interpret=interpret,
            name="int8_chunkmin_scan",
        )(
            q8, qs2.astype(jnp.float32), qc.astype(jnp.float32),
            base_i8[rows], base_scale[rows].astype(jnp.float32),
            base_cache[rows].astype(jnp.float32),
        )
        parts_d.append(dm)
        parts_i.append(im + c0 * T.CHUNK)
    dmin = jnp.concatenate(parts_d, axis=0).T[:B]
    imin = jnp.concatenate(parts_i, axis=0).T[:B]
    return dmin, imin


@functools.partial(jax.jit, static_argnames=("r", "dist", "interpret"))
def scan_candidates_int8(
    queries: jax.Array,  # (B, dim) f32
    base_i8: jax.Array,  # (N_pad, dim_pad) int8
    base_scale: jax.Array,  # (N_pad,) f32
    base_cache: jax.Array,  # (N_pad,) f32
    r: int,
    dist: str,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Stage-1 candidates through the kernel: the best `r` chunk survivors
    ((B, r) selection-grade dists ascending, (B, r) mirror row ids, -1
    padded).  Validity rides the cache channel (store.device_int8)."""
    q8, qs2, qc = T.int8_queries(queries, base_i8.shape[1], dist)
    dmin, imin = scan_chunkmin_int8(
        q8, qs2, qc, base_i8, base_scale, base_cache, interpret=interpret
    )
    return T.select_survivors(dmin, imin, r)
