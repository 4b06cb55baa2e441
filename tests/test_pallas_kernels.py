"""The stage-1 scan (the Pallas kernel on the Triton route, in interpret
mode on CPU, and its plain chunk-min reference) and the plain XLA rerank
(`topk.exact_distances_sorted`, `knn_gathered`, `knn_gathered_blocked`)
against numpy oracles of the same arithmetic."""

import numpy as np
import jax.numpy as jnp
import pytest

from lab_1806_vec_db.ops import distance as D
from lab_1806_vec_db.ops import scan_triton as ST
from lab_1806_vec_db.ops import topk as T


def _make(dist, n=3000, dim=48, b=8, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((b, dim)).astype(np.float32)
    return base, qs


def _mirror(base, dist, n_valid=None):
    """Int8 mirror in the unified channel convention (store.device_int8),
    columns padded to 128, rows to a CHUNK multiple; invalid rows carry the
    sentinel."""
    n, dim = base.shape
    n_valid = n if n_valid is None else n_valid
    dim_pad = -(-dim // 128) * 128
    n_pad = -(-n // T.CHUNK) * T.CHUNK
    x = np.zeros((n_pad, dim_pad), np.float32)
    x[:n, :dim] = base
    b8, sc = T.quantize_rows_int8(jnp.asarray(x))
    cache = D.dist_cache(jnp.asarray(x), dist)
    if dist == "cosine":
        sc = sc / jnp.maximum(cache, 1e-20)
        cache = jnp.zeros_like(cache)
    valid = jnp.arange(n_pad) < n_valid
    return b8, jnp.where(valid, sc, 0.0), jnp.where(valid, cache, T.BIG)


def _oracle_chunkmin(qs, b8, sc, cache, dist):
    """numpy chunk-min survivors of the unified f32 epilogue."""
    q8, qs2, qc = (np.asarray(a) for a in T.int8_queries(jnp.asarray(qs), b8.shape[1], dist))
    dots = q8.astype(np.float32) @ np.asarray(b8, np.float32).T
    dm = (np.asarray(cache)[None, :] + qc[:, None]) - dots * (
        np.asarray(sc)[None, :] * qs2[:, None]
    )
    B, n_pad = dm.shape
    ch = dm.reshape(B, n_pad // T.CHUNK, T.CHUNK)
    return ch.min(2), ch.argmin(2) + np.arange(0, n_pad, T.CHUNK)[None]


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_scan_chunkmin_matches_oracle(dist):
    """The plain chunk-min reference (topk.scan_chunkmin_int8) against numpy
    with identical arithmetic: exact int32 dots, f32 epilogue."""
    base, qs = _make(dist, 3000, 48, 8)
    b8, sc, cache = _mirror(base, dist)
    q8, qs2, qc = T.int8_queries(jnp.asarray(qs), b8.shape[1], dist)
    dm, im = T.scan_chunkmin_int8(q8, qs2, qc, b8, sc, cache, block=512)
    od, oi = _oracle_chunkmin(qs, b8, sc, cache, dist)
    np.testing.assert_allclose(np.asarray(dm), od, rtol=1e-5, atol=1e-5)
    # ids equal except on exact distance ties
    assert not ((np.asarray(im) != oi) & ~np.isclose(np.asarray(dm), od, rtol=1e-6)).any()


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_gather_dists_and_rerank(dist):
    N, dim, B, r, k = 500, 70, 6, 16, 5
    base, qs = _make(dist, N, dim, B)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, N, size=(B, r)).astype(np.int32)
    ids[0, -1] = -1  # exercise padding

    if dist == "l2sqr":
        dm = ((qs[:, None, :] - base[None]) ** 2).sum(-1)
    else:
        dm = 1 - (qs @ base.T) / np.maximum(
            np.linalg.norm(qs, axis=1)[:, None] * np.linalg.norm(base, axis=1)[None],
            1e-10,
        )
    oracle = np.where(ids >= 0, np.take_along_axis(dm, np.maximum(ids, 0), axis=1), np.inf)
    gd, gi = T.exact_distances_sorted(jnp.asarray(qs), jnp.asarray(base), jnp.asarray(ids), dist)
    np.testing.assert_allclose(np.asarray(gd), np.sort(oracle, axis=1), rtol=2e-4, atol=2e-5)
    gi = np.asarray(gi)
    assert ((gi >= 0) == np.isfinite(np.sort(oracle, axis=1))).all()

    bd, bi = T.knn_gathered(jnp.asarray(qs), jnp.asarray(base), jnp.asarray(ids), k, dist)
    bd, bi = np.asarray(bd), np.asarray(bi)
    assert (np.diff(bd, axis=1) >= -1e-6).all()
    # top-1 of the candidate set must match the oracle's best candidate
    np.testing.assert_allclose(bd[:, 0], oracle.min(1), rtol=2e-4)


def test_rerank_topk_blocked_matches_unblocked():
    rng = np.random.default_rng(2)
    N, dim, B, C, k = 400, 70, 5, 150, 8
    base = rng.standard_normal((N, dim)).astype(np.float32)
    qs = rng.standard_normal((B, dim)).astype(np.float32)
    ids = rng.permutation(N)[:C]  # unique candidates
    ids = np.broadcast_to(ids, (B, C)).astype(np.int32).copy()
    ids[0, -3:] = -1
    d1, i1 = T.exact_distances_sorted(jnp.asarray(qs), jnp.asarray(base), jnp.asarray(ids), "l2sqr")
    d2, i2 = T.knn_gathered_blocked(
        jnp.asarray(qs), jnp.asarray(base), jnp.asarray(ids), k, "l2sqr", block=64
    )
    np.testing.assert_allclose(np.asarray(d1)[:, :k], np.asarray(d2), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(i1)[:, :k], np.asarray(i2))


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_scan_dist_int8_matches_xla(dist):
    """The kernel's survivors against the plain XLA int8 scan: the best row
    agrees, and every survivor's distance matches the XLA scan's
    selection-grade distance of the same row (bf16 epilogue there)."""
    N, dim, B, r = 3000, 48, 8, 16
    base, qs = _make(dist, N, dim, B)
    b8, sc, cache = _mirror(base, dist)
    bd1, bi1 = T.scan_candidates_int8(
        jnp.asarray(qs), b8, sc, cache, jnp.int32(N), b8.shape[0], dist
    )  # every row, sorted
    bd2, bi2 = ST.scan_candidates_int8(jnp.asarray(qs), b8, sc, cache, r, dist, interpret=True)
    bd1, bi1, bd2, bi2 = (np.asarray(a) for a in (bd1, bi1, bd2, bi2))
    np.testing.assert_allclose(bd2[:, 0], bd1[:, 0], rtol=2e-2, atol=1e-3)
    for b in range(B):
        xla_d = dict(zip(bi1[b].tolist(), bd1[b].tolist()))
        got = np.array([xla_d[i] for i in bi2[b]])
        np.testing.assert_allclose(bd2[b], got, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_scan_packed_matches_oracle(dist):
    """The kernel's candidate wrapper vs a numpy oracle of the chunk-min
    survivors followed by top-r."""
    N, dim, B, r = 4200, 32, 8, 12
    base, qs = _make(dist, N, dim, B)
    b8, sc, cache = _mirror(base, dist)
    bd, bi = ST.scan_candidates_int8(jnp.asarray(qs), b8, sc, cache, r, dist, interpret=True)
    bd, bi = np.asarray(bd), np.asarray(bi)
    cmin, cargmin = _oracle_chunkmin(qs, b8, sc, cache, dist)
    order = np.argsort(cmin, axis=1, kind="stable")[:, :r]
    od = np.take_along_axis(cmin, order, axis=1)
    oi = np.take_along_axis(cargmin, order, axis=1)
    np.testing.assert_allclose(bd, od, rtol=1e-5, atol=1e-5)
    assert not ((bi != oi) & ~np.isclose(bd, od, rtol=1e-6)).any()


@pytest.mark.parametrize("n_valid", [4200, 4096, 100])
def test_scan_packed_validity_boundary(n_valid):
    """Invalid rows must never be selected.  The kernel has NO positional
    masking: validity rides the cache channel as +BIG sentinels (the
    store.device_int8 contract), and chunk padding gets the same."""
    N, dim, B, r = 4200, 32, 4, 12
    base, qs = _make("l2sqr", N, dim, B, seed=3)
    # make the tail rows the closest to every query: if the sentinels fail
    # to suppress them, they win every min
    base[n_valid:] = qs[0] if n_valid < N else base[n_valid:]
    b8, sc, cache = _mirror(base, "l2sqr", n_valid)
    _, bi = ST.scan_candidates_int8(jnp.asarray(qs), b8, sc, cache, r, "l2sqr", interpret=True)
    bi = np.asarray(bi)
    assert (bi[bi >= 0] < n_valid).all()
    assert ((bi >= 0).sum(1) == min(r, -(-n_valid // T.CHUNK))).all()


def test_gather_dists_bf16_slab():
    """bf16 rows (memory-lean tier): distances match the f32 oracle to bf16
    input precision (~1e-2 relative)."""
    N, dim, B, r = 400, 70, 4, 12
    base, qs = _make("l2sqr", N, dim, B, seed=9)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, N, size=(B, r)).astype(np.int32)
    ids[1, 0] = -1

    rows = jnp.asarray(base).astype(jnp.bfloat16)
    gd, gi = T.exact_distances_sorted(jnp.asarray(qs), rows, jnp.asarray(ids), "l2sqr")
    gd, gi = np.asarray(gd), np.asarray(gi)
    dm = ((qs[:, None, :] - base[None]) ** 2).sum(-1)
    want = np.take_along_axis(dm, np.maximum(gi, 0), axis=1)
    finite = gi >= 0
    np.testing.assert_allclose(gd[finite], want[finite], rtol=3e-2, atol=1e-2)
    assert np.isinf(gd[~finite]).all() and (~finite).sum() == 1


def test_scan_packed_blocked_channels_ab():
    """The plain chunk-min reference blocked two ways in ONE process (one
    chunk per block vs the default ~1 GB block): identical survivors and
    distances — blocking is a memory bound, never a numerical change."""
    N, dim, B = 4200, 32, 8
    base, qs = _make("l2sqr", N, dim, B)
    b8, sc, cache = _mirror(base, "l2sqr")
    q8, qs2, qc = T.int8_queries(jnp.asarray(qs), b8.shape[1], "l2sqr")
    d1, i1 = T.scan_chunkmin_int8(q8, qs2, qc, b8, sc, cache, block=T.CHUNK)
    d2, i2 = T.scan_chunkmin_int8(q8, qs2, qc, b8, sc, cache)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-6, atol=1e-7)
