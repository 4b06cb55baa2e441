"""The backend seam (ops/backend.py), the stage-1 kernel against its plain
chunk-min reference, the blocked plain int8 scan, and the XLA graph route
against exact Flat."""

import numpy as np
import jax.numpy as jnp
import pytest

from lab_1806_vec_db.models import FlatIndex, HNSWIndex
from lab_1806_vec_db.ops import backend
from lab_1806_vec_db.ops import distance as D
from lab_1806_vec_db.ops import scan_triton as ST
from lab_1806_vec_db.ops import topk as T
from lab_1806_vec_db.utils.config import HNSWConfig


def _mirror(base, dist):
    n, dim = base.shape
    dim_pad = -(-dim // 128) * 128
    x = np.zeros((n, dim_pad), np.float32)
    x[:, :dim] = base
    b8, sc = T.quantize_rows_int8(jnp.asarray(x))
    cache = D.dist_cache(jnp.asarray(x), dist)
    if dist == "cosine":
        sc = sc / jnp.maximum(cache, 1e-20)
        cache = jnp.zeros_like(cache)
    return b8, sc, cache


@pytest.mark.parametrize(
    "platform,accelerated,scan",
    [("cpu", False, "xla"), ("gpu", True, "triton"), ("rocm", None, None)],
)
def test_kernel_set_choice(platform, accelerated, scan):
    """Each platform names its kernel set; one without an entry is an
    error, never a silent default."""
    if accelerated is None:
        with pytest.raises(RuntimeError, match="no kernel set"):
            backend.kernel_set(platform)
        return
    ks = backend.kernel_set(platform)
    assert (ks.accelerated, ks.scan) == (accelerated, scan)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_seam_routes_flat_stage1(platform, dist, monkeypatch):
    """FlatIndex's two-stage plan takes its stage-1 scan from the kernel
    set (spied), and either kernel gives exact-grade results after the
    rerank.  The Triton kernel runs in interpret mode here."""
    import lab_1806_vec_db.models.flat as flat_mod

    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)
    calls = []
    real_kernel, real_xla = ST.scan_candidates_int8, T.scan_candidates_int8

    def kernel_spy(*a, **kw):
        calls.append("triton")
        return real_kernel(*a, **kw, interpret=True)

    def xla_spy(*a, **kw):
        calls.append("xla")
        return real_xla(*a, **kw)

    monkeypatch.setattr(ST, "scan_candidates_int8", kernel_spy)
    monkeypatch.setattr(T, "scan_candidates_int8", xla_spy)
    rng = np.random.default_rng(5)
    # enough 128-row chunks that the kernel's one-survivor-per-chunk cap
    # rarely costs a true neighbor
    base = rng.standard_normal((32768, 40)).astype(np.float32)
    qs = rng.standard_normal((12, 40)).astype(np.float32)
    index = FlatIndex.from_numpy(base, dist)
    d_gt, gt = index.knn_batch(qs, 10, exact=True)
    ks = backend.kernel_set(platform)
    with backend.forced(ks):
        d, ids = index.knn_batch(qs, 10)
    assert calls == [ks.scan]
    recall = np.mean([len(set(gt[q]) & set(ids[q])) / 10 for q in range(len(qs))])
    assert recall >= 0.95
    hit = ids == gt
    np.testing.assert_allclose(d[hit], d_gt[hit], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B", [1, 7, 130])
@pytest.mark.parametrize("dim", [960, 100])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_kernel_matches_plain_chunkmin(dist, dim, B):
    """The Triton-route kernel (interpret mode) against the plain chunk-min
    reference on a row count that is not a multiple of the chunk: the same
    survivor ids except at exact ties, distances within 1e-6 relative (the
    int32 dots are exact and both epilogues run in f32)."""
    rng = np.random.default_rng(dim + B)
    n = 3 * T.CHUNK + 37
    base = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((B, dim)).astype(np.float32)
    b8, sc, cache = _mirror(base, dist)
    n_pad = -(-n // T.CHUNK) * T.CHUNK
    b8p = jnp.pad(b8, ((0, n_pad - n), (0, 0)))
    scp = jnp.pad(sc, (0, n_pad - n))
    cap = jnp.pad(cache, (0, n_pad - n), constant_values=T.BIG)
    q8, qs2, qc = T.int8_queries(jnp.asarray(qs), b8.shape[1], dist)
    dk, ik = ST.scan_chunkmin_int8(q8, qs2, qc, b8, sc, cache, interpret=True)
    dr, ir = T.scan_chunkmin_int8(q8, qs2, qc, b8p, scp, cap)
    dk, ik, dr, ir = (np.asarray(a) for a in (dk, ik, dr, ir))
    assert dk.shape == dr.shape == (B, n_pad // T.CHUNK)
    np.testing.assert_allclose(dk, dr, rtol=1e-6, atol=1e-6)
    tie = np.isclose(dk, dr, rtol=0, atol=0)
    assert ((ik == ir) | tie).all()
    assert (ik < n).all()  # the padded tail never wins a chunk


@pytest.mark.parametrize("block", [0, 256, 1000])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_scan_candidates_int8_blocked_matches_numpy(dist, block):
    """The plain int8 scan, blocked over N (full blocks + a tail), returns
    the same top-r as numpy over the same int8 arithmetic (bf16-rounded
    distances, as the scan keeps them)."""
    rng = np.random.default_rng(11)
    n, dim, B, r = 2300, 64, 6, 24
    base = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((B, dim)).astype(np.float32)
    b8, sc, cache = _mirror(base, dist)
    bd, bi = T.scan_candidates_int8(
        jnp.asarray(qs), b8, sc, cache, jnp.int32(n), r, dist, block=block
    )
    q8, qs2, qc = (np.asarray(a) for a in T.int8_queries(jnp.asarray(qs), b8.shape[1], dist))
    dots = q8.astype(np.float32) @ np.asarray(b8, np.float32).T
    dm = (np.asarray(cache)[None, :] + qc[:, None]) - dots * (
        np.asarray(sc)[None, :] * qs2[:, None]
    )
    dm = np.asarray(jnp.asarray(dm).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.sort(dm, axis=1)[:, :r]
    np.testing.assert_allclose(np.asarray(bd), want, rtol=1e-6, atol=1e-6)
    got = np.take_along_axis(dm, np.asarray(bi), axis=1)
    np.testing.assert_array_equal(got, np.asarray(bd))


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("n", [200, 600])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_graph_route_exhaustive_ef_is_exact(dist, n, B, gist_1000):
    """route="graph" (the XLA lock-step beam, the card's graph route too)
    at ef >= N visits the whole graph: its ids equal exact Flat's and its
    distances are exact f32."""
    vecs = gist_1000[:n, :32].copy()
    qs = gist_1000[900:900 + B, :32].copy()
    index = HNSWIndex.build(vecs, dist, HNSWConfig(M=8, ef_construction=64), seed=1)
    d_f, i_f = FlatIndex.from_numpy(vecs, dist).knn_batch(qs, 10, exact=True)
    d_g, i_g = index.knn_with_ef_batch(qs, 10, ef=n, route="graph")
    np.testing.assert_array_equal(i_g, i_f)
    np.testing.assert_allclose(d_g, d_f, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_compiled_matches_plain(gpu):
    """The kernel as compiled for the card (no interpret mode) against the
    plain chunk-min reference at dim 960."""
    rng = np.random.default_rng(0)
    n, dim, B = 20 * T.CHUNK, 960, 64
    base = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((B, dim)).astype(np.float32)
    b8, sc, cache = _mirror(base, "l2sqr")
    q8, qs2, qc = T.int8_queries(jnp.asarray(qs), b8.shape[1], "l2sqr")
    dk, ik = ST.scan_chunkmin_int8(q8, qs2, qc, b8, sc, cache)
    dr, ir = T.scan_chunkmin_int8(q8, qs2, qc, b8, sc, cache)
    np.testing.assert_allclose(np.asarray(dk), np.asarray(dr), rtol=1e-6, atol=1e-6)
    assert ((np.asarray(ik) == np.asarray(ir)) | (np.asarray(dk) == np.asarray(dr))).all()
