"""cldrd_tpu_torch.index / run writer against the JAX package: quantizer
bytes, padding and per-query rescue, stores each package writes for the
other, and run files."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cldrd_tpu.index import FlatIPIndex as JaxIndex
from cldrd_tpu.index import flat_index as jflat
from cldrd_tpu.index import persistence as jpersist
from cldrd_tpu.search import run_writer as jrun
from cldrd_tpu_torch.index import FlatIPIndex, flat_index, persistence
from cldrd_tpu_torch.search import run_writer


def test_quantize_rows_byte_equal():
    rng = np.random.default_rng(0)
    c = rng.standard_normal((300, 48)).astype(np.float32)
    c[5] = 0.0  # zero row -> scale 1
    c[7] *= 1e-30
    # exact halves exercise round-half-to-even
    c[9] = np.arange(48, dtype=np.float32) - 23.5
    rc, rs = jflat.quantize_rows(c, xp=np)
    for codes, scales in (flat_index.quantize_rows(c),
                          [x.numpy() for x in
                           flat_index.quantize_rows(torch.from_numpy(c))]):
        assert codes.dtype == np.int8 and scales.dtype == np.float32
        assert codes.tobytes() == rc.tobytes()
        assert scales.tobytes() == rs.tobytes()


def _adversarial_corpus(n, d, n_planted, rng):
    c = rng.standard_normal((n, d)).astype(np.float32) * 0.01
    u = rng.standard_normal(d).astype(np.float32)
    u /= np.linalg.norm(u)
    c[:n_planted] = (5.0 + np.linspace(1.0, 0.0, n_planted,
                                       dtype=np.float32))[:, None] * u[None]
    return c, u


def test_per_query_rescue(monkeypatch):
    """One query fails the certificate: search() re-scans exactly that one
    (pad rows replicate q[0] and are never rescued) and every row is exact
    (tests/test_index_search.py::test_flat_index_recovers_per_query)."""
    rng = np.random.default_rng(2)
    n, d, k = 4096, 32, 20
    c, u = _adversarial_corpus(n, d, k, rng)
    ext = rng.permutation(np.arange(7_000, 7_000 + n)).astype(np.int64)
    q = rng.standard_normal((8, d)).astype(np.float32) * 0.01
    q -= (q @ u)[:, None] * u[None, :]
    q[5] = u
    index = FlatIPIndex.build(c, ext, dtype=torch.float32, block_rows=512,
                              device="cpu")
    calls = []
    orig = FlatIPIndex._rescan_exact

    def spy(self, qs, kk):
        calls.append(len(qs))
        return orig(self, qs, kk)

    monkeypatch.setattr(FlatIPIndex, "_rescan_exact", spy)
    s, i = index.search(q, k=k)
    ref = q @ c.T
    ref_p = np.argsort(-ref, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(i, ext[ref_p])
    np.testing.assert_allclose(s, np.take_along_axis(ref, ref_p, 1),
                               rtol=1e-5)
    assert calls == [1] and index.rescued_queries == 1
    calls.clear()
    index.search(np.delete(q, 5, axis=0), k=k)
    assert calls == []
    # the JAX index agrees on the ids
    jidx = JaxIndex.build(c, ext, dtype=jnp.float32, block_rows=512)
    _, ji = jidx.search(q, k=k)
    np.testing.assert_array_equal(i, ji)


def test_ragged_batch_pads_by_repeating_the_first_query(monkeypatch):
    rng = np.random.default_rng(3)
    n, d, k = 4096, 16, 10
    c = rng.integers(-4, 5, (n, d)).astype(np.float32)
    q = rng.integers(-4, 5, (89, d)).astype(np.float32)
    index = FlatIPIndex.build(c, np.arange(n), dtype=torch.float32,
                              device="cpu")
    seen = []
    orig = FlatIPIndex._search_device

    def spy(self, qd, kk):
        seen.append(qd.clone())
        return orig(self, qd, kk)

    monkeypatch.setattr(FlatIPIndex, "_search_device", spy)
    s, i = index.search(q, k)
    assert s.shape == (89, k) and i.shape == (89, k)
    (qd,) = seen
    assert qd.shape == (128, d)
    assert torch.equal(qd[89:], torch.from_numpy(q[:1]).expand(39, d))
    # the same rows searched inside another batch give the same answer
    s2, i2 = index.search(np.concatenate([q, q[::-1]]), k)
    np.testing.assert_array_equal(i2[:89], i)
    np.testing.assert_array_equal(s2[:89], s)
    # search_batched: ragged final batch, same results
    bs, bi = index.search_batched(q, k, batch_size=64)
    np.testing.assert_array_equal(bi, i)
    np.testing.assert_array_equal(bs, s)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_each_package_loads_the_others_store(tmp_path, dtype):
    rng = np.random.default_rng(4)
    n, d, k = 700, 16, 15
    embs = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.permutation(np.arange(100, 100 + n)).astype(np.int64)
    q = rng.standard_normal((12, d)).astype(np.float32)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpersist.write_embeddings(jdir, embs, ids, rows_per_shard=256,
                              dtype=dtype)
    persistence.write_embeddings(tdir, embs, ids, rows_per_shard=256,
                                 dtype=dtype)
    for name in sorted(__import__("os").listdir(jdir)):
        assert open(f"{jdir}/{name}", "rb").read() == \
            open(f"{tdir}/{name}", "rb").read(), name
    e1, i1 = persistence.read_embeddings(jdir)
    e2, i2 = jpersist.read_embeddings(tdir)
    np.testing.assert_array_equal(e1, e2)
    np.testing.assert_array_equal(i1, i2)
    hbm_t = torch.int8 if dtype == "int8" else torch.float32
    hbm_j = jnp.int8 if dtype == "int8" else jnp.float32
    tidx = persistence.load_index(jdir, dtype=hbm_t, block_rows=512,
                                  device="cpu")
    jidx = jpersist.load_index(tdir, dtype=hbm_j, block_rows=512)
    assert tidx.n_vectors == jidx.n_vectors == n
    ts, ti = tidx.search(q, k)
    js, ji = jidx.search(q, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5)


def test_write_run_file_byte_identical(tmp_path):
    rng = np.random.default_rng(5)
    qids = np.array([3, 1, 400], np.int64)
    ids = rng.integers(0, 10**6, (3, 7)).astype(np.int64)
    ids[1, 4:] = -1  # beyond the corpus: skipped
    scores = rng.standard_normal((3, 7)).astype(np.float32)
    a, b = str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")
    jrun.write_run_file(a, qids, ids, scores)
    run_writer.write_run_file(b, qids, ids, scores)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_device_resolution_never_falls_back_quietly():
    from cldrd_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            FlatIPIndex.build(np.zeros((4, 16), np.float32), np.arange(4))
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_from_tensors_adopts_device_arrays():
    rng = np.random.default_rng(6)
    codes = torch.from_numpy(rng.integers(-127, 128, (2048, 16))
                             .astype(np.int8))
    scales = torch.rand(2048)
    ids = torch.arange(2048, dtype=torch.int32)
    ids[2000:] = -1
    index = FlatIPIndex.from_tensors(codes, ids, scales, block_rows=1024)
    ref = FlatIPIndex.build_quantized(codes.numpy()[:2000],
                                      scales.numpy()[:2000],
                                      np.arange(2000), block_rows=1024,
                                      device="cpu")
    q = rng.standard_normal((5, 16)).astype(np.float32)
    np.testing.assert_array_equal(index.search(q, 7)[1], ref.search(q, 7)[1])
    with pytest.raises(ValueError):
        FlatIPIndex.from_tensors(codes, ids, None, block_rows=1024)
