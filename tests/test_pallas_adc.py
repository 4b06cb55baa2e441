"""The XLA ADC forms (ops/pq.py adc_scan, the PQTable scan route and the
HNSW+PQ per-id frontier distances) against numpy references of the
reference's scalar accumulation (pq_table.rs:252-299)."""

import numpy as np
import jax.numpy as jnp
import pytest

from lab_1806_vec_db.models import PQTable
from lab_1806_vec_db.models.hnsw import _make_adc_node_dist
from lab_1806_vec_db.ops import pq as P
from lab_1806_vec_db.utils.config import PQConfig


def _fixture(dist, gist_1000, n_bits=4):
    vecs = gist_1000[:200, :24].copy()
    queries = gist_1000[200:210, :24].copy()
    cfg = PQConfig(n_bits=n_bits, m=8, dist=dist, k_means_size=100)
    pq = PQTable.train(vecs, cfg, seed=0)
    q_dev = jnp.asarray(queries)
    lookup, q_norms = pq.create_lookup(q_dev)
    return pq, lookup, q_norms, len(vecs)


def _adc_numpy(pq, lookup, q_norms, codes, dist):
    """(B, N) ADC distances, accumulated row by row in float64."""
    lut = np.asarray(lookup, np.float64)  # (B, m, k)
    m = lut.shape[1]
    s = lut[:, np.arange(m)[None, :], codes.astype(np.int64)]  # (B, N, m)
    s = s.sum(-1)
    if dist == "l2sqr":
        return s
    cb_sq = np.asarray(pq.device()[2], np.float64)
    norm0 = np.sqrt(cb_sq[np.arange(m)[None, :], codes.astype(np.int64)].sum(-1))
    return 1.0 - s / np.maximum(norm0[None, :] * np.asarray(q_norms)[:, None], 1e-10)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_pallas_adc_matches_xla(dist, gist_1000):
    """ops/pq.py adc_scan against the numpy accumulation: same distances
    and the same top-10 ids."""
    pq, lookup, q_norms, n = _fixture(dist, gist_1000)
    _, _, cb_sq = pq.device()
    d_ref = _adc_numpy(pq, lookup, q_norms, pq.codes, dist)
    d, i = P.adc_scan(lookup, jnp.asarray(pq.codes), jnp.int32(n), cb_sq, q_norms, 10, dist)
    want_i = np.argsort(d_ref, axis=1, kind="stable")[:, :10]
    np.testing.assert_allclose(
        np.asarray(d), np.take_along_axis(d_ref, want_i, axis=1), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(i), want_i)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_pallas_adc_packed_nibbles(dist, gist_1000):
    """PQTable.adc_scan over the nibble-packed device codes (4-bit,
    pq_table.rs:66-91 layout; unpacked on device) must equal the scan over
    the unpacked codes."""
    pq, lookup, q_norms, n = _fixture(dist, gist_1000)
    codes_dev, _, cb_sq = pq.device()
    assert pq.packed and codes_dev.shape[1] == 4  # (N, ceil(8/2)) bytes

    d_u, i_u = P.adc_scan(
        lookup, jnp.asarray(pq.codes), jnp.int32(n), cb_sq, q_norms, 10, dist
    )
    d_p, i_p = pq.adc_scan(lookup, q_norms, 10)
    np.testing.assert_allclose(np.asarray(d_p), np.asarray(d_u), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(i_p), np.asarray(i_u))


def test_unpack_codes_4bit_dev_roundtrip(rng):
    codes = rng.integers(0, 16, size=(13, 7)).astype(np.uint8)
    packed = P.pack_codes_4bit(codes)
    out = np.asarray(P.unpack_codes_4bit_dev(jnp.asarray(packed), 7))
    np.testing.assert_array_equal(out, codes)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("packed", [False, True])
def test_adc_dists_for_ids_matches_xla(dist, packed, gist_1000):
    """Per-query candidate ADC (the HNSW+PQ traversal's frontier distances)
    vs the numpy accumulation, incl. -1 masking and nibble-packed codes."""
    pq, lookup, q_norms, n = _fixture(dist, gist_1000)
    _, _, cb_sq = pq.device()
    rng = np.random.default_rng(0)
    B = int(lookup.shape[0])
    C = 13  # deliberately unaligned
    ids = rng.integers(0, n, size=(B, C)).astype(np.int32)
    ids[0, 3] = -1
    ids[5, :] = -1  # fully-converged query
    if packed:
        codes_dev = jnp.asarray(P.pack_codes_4bit(pq.codes))
    else:
        codes_dev = jnp.asarray(pq.codes)
    nd = _make_adc_node_dist(
        lookup, q_norms, codes_dev, cb_sq, dist, pq.config.m,
        pq.config.m if packed else None,
    )
    got = np.asarray(nd(jnp.asarray(ids)))
    full = _adc_numpy(pq, lookup, q_norms, pq.codes, dist)
    want = np.where(ids >= 0, np.take_along_axis(full, np.maximum(ids, 0), axis=1), np.inf)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("block", [128, 1000])
def test_adc_scan_chunkmin_matches_dense(dist, block, rng):
    """The blocked full ADC scan (running top-k merged block by block) must
    equal the single-block scan on a 4096-row set: blocking bounds the
    (B, block, m) gather, it never changes the answer."""
    n, dim, m, nb = 4096, 32, 8, 4
    vecs = np.abs(rng.standard_normal((n, dim))).astype(np.float32)
    queries = np.abs(rng.standard_normal((16, dim))).astype(np.float32)
    cfg = PQConfig(n_bits=nb, m=m, dist=dist, k_means_size=512)
    pq = PQTable.train(vecs, cfg, seed=0)
    lookup, q_norms = pq.create_lookup(jnp.asarray(queries))
    _, _, cb_sq = pq.device()
    codes = jnp.asarray(pq.codes)

    d_ref, i_ref = P.adc_scan(lookup, codes, jnp.int32(n), cb_sq, q_norms, 10, dist, block=n)
    d_b, i_b = P.adc_scan(lookup, codes, jnp.int32(n), cb_sq, q_norms, 10, dist, block=block)
    np.testing.assert_allclose(np.asarray(d_b), np.asarray(d_ref), rtol=1e-6, atol=1e-7)
    a, e = np.asarray(i_b), np.asarray(i_ref)
    assert not ((a != e) & ~np.isclose(np.asarray(d_b), np.asarray(d_ref), rtol=1e-6)).any()
