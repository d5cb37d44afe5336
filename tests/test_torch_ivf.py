"""The IVF tier of cldrd_tpu_torch against the JAX package, on the CPU:
the probe kernel's plain version (K6) against the Pallas kernel in
interpret mode and its XLA twin, k-means, PQ/OPQ, IVFIndex build / search
/ add / remove / save / load (directories cross between the packages in
both directions), the flat index's add/remove/save, the refine tier and
the index CLI's IVF build.

Integer-valued inputs make every dot product exact, so results that
depend only on dots must be EQUAL; elsewhere values agree within 1e-5 of
the largest magnitude (fp32 sums in another order) and trained
centroids/codebooks within 1e-4."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cldrd_tpu.index import IVFIndex as JIVF
from cldrd_tpu.index import FlatIPIndex as JFlat
import cldrd_tpu.index.kmeans  # noqa: F401  (the module, not the function)
from cldrd_tpu.index import pq as jpq
from cldrd_tpu.index import refine as jrefine
from cldrd_tpu.index import persistence as jpersist
from cldrd_tpu.ops import ivf_probe as jprobe
from cldrd_tpu_torch.index import FlatIPIndex, IVFIndex, ivf_exists
import cldrd_tpu_torch.index.kmeans  # noqa: F401
from cldrd_tpu_torch.index import ivf_index, pq as tpq
from cldrd_tpu_torch.index import persistence, refine
from cldrd_tpu_torch.ops import ivf_probe

import sys  # noqa: E402

jkm = sys.modules["cldrd_tpu.index.kmeans"]
tkm = sys.modules["cldrd_tpu_torch.index.kmeans"]

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "int8": torch.int8}


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------------- K6


def _probe_inputs(store, scaled, integer, nb=16, slot=64, d=128, b=4, p=5,
                  seed=0):
    rng = np.random.default_rng(seed)
    if store == "int8":
        rows = rng.integers(-127, 128, (nb * slot, d)).astype(np.int8)
    elif integer:
        rows = rng.integers(-8, 9, (nb * slot, d)).astype(np.float32)
    else:
        rows = rng.normal(size=(nb * slot, d)).astype(np.float32)
    q = (rng.integers(-4, 5, (b, d)) if integer
         else rng.normal(size=(b, d))).astype(np.float32)
    probe = rng.integers(0, nb, (b, p)).astype(np.int32)
    scales = (rng.uniform(0.9, 1.1, (nb, slot)).astype(np.float32)
              if scaled else None)
    return q, rows, probe, scales, slot


def _probe_both(q, rows, probe, scales, slot, q_dtype="bfloat16"):
    """(port's probe_scores on the CPU, Pallas kernel, XLA twin)."""
    store = "int8" if rows.dtype == np.int8 else "bfloat16"
    tq = torch.from_numpy(q).to(_TDT[q_dtype])
    trows = torch.from_numpy(rows).to(_TDT[store])
    tsc = None if scales is None else torch.from_numpy(scales)
    got = ivf_probe.probe_scores(tq, trows, torch.from_numpy(probe), tsc,
                                 slot=slot).numpy()
    jq = jnp.asarray(q, _JDT[q_dtype])
    jrows = jnp.asarray(rows, _JDT[store])
    jsc = None if scales is None else jnp.asarray(scales)
    jpr = jnp.asarray(probe)
    kern = np.asarray(jprobe.probe_scores(jq, jrows, jpr, jsc, slot=slot))
    twin = np.asarray(jprobe.probe_scores_reference(jq, jrows, jpr, jsc,
                                                    slot=slot))
    return got, kern, twin


@pytest.mark.parametrize("store,scaled", [("bfloat16", False),
                                          ("bfloat16", True),
                                          ("int8", True)])
@pytest.mark.parametrize("integer", [True, False])
def test_probe_scores_match_pallas_kernel_and_twin(store, scaled, integer):
    q, rows, probe, scales, slot = _probe_inputs(
        "int8" if store == "int8" else "bf16", scaled, integer)
    if store == "bfloat16":  # values the bf16 store holds exactly
        rows = np.asarray(torch.from_numpy(rows).bfloat16().float())
    got, kern, twin = _probe_both(q, rows, probe, scales, slot)
    assert got.shape == (4, 5 * slot) and got.dtype == np.float32
    if integer:
        np.testing.assert_array_equal(got, kern)
        np.testing.assert_array_equal(got, twin)
    else:
        assert _rel_err(got, kern) <= 1e-5
        assert _rel_err(got, twin) <= 1e-5


def test_probe_scores_duplicate_probes_fp32_query_and_dtypes():
    q, rows, _, scales, slot = _probe_inputs("int8", True, True)
    probe = np.asarray([[0, 0, 3, 3, 15]] * 4, np.int32)  # repeats
    got, kern, twin = _probe_both(q, rows, probe, scales, slot)
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(got[:, :slot], got[:, slot:2 * slot])
    # an fp32 query is taken in bf16, as the Pallas kernel takes it
    q, rows, probe, scales, slot = _probe_inputs("int8", True, False, seed=1)
    got, kern, _ = _probe_both(q, rows, probe, scales, slot, "float32")
    assert _rel_err(got, kern) <= 1e-5
    # a [nb, 0] scale array means none (the JAX index passes one)
    tq = torch.from_numpy(q).bfloat16()
    tr = torch.from_numpy(rows)
    tp = torch.from_numpy(probe)
    assert torch.equal(
        ivf_probe.probe_scores(tq, tr, tp, torch.zeros(16, 0), slot=slot),
        ivf_probe.probe_scores(tq, tr, tp, None, slot=slot))
    for bad in (torch.float32, torch.float16):
        with pytest.raises(TypeError):
            ivf_probe.probe_scores(tq, tr.to(bad), tp, None, slot=slot)
    with pytest.raises(ValueError):
        ivf_probe.probe_scores(tq, tr, tp.long(), None, slot=slot)


def test_probe_kernel_eligible_is_false_on_the_cpu():
    store = torch.zeros(128, 16, dtype=torch.int8)
    assert not ivf_index._probe_kernel_eligible(store, "default")
    assert not ivf_index._probe_kernel_eligible(store.bfloat16(), "default")
    assert not ivf_index._probe_kernel_eligible(store.float(), "highest")


# --------------------------------------------------------- k-means, PQ


def _blobs(n_clusters=12, per=80, d=16, seed=0, spread=0.1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 4.0
    x = (centers[np.repeat(np.arange(n_clusters), per)]
         + rng.normal(size=(n_clusters * per, d)) * spread)
    return x.astype(np.float32)


def test_kmeans_and_assign_match_jax():
    x = _blobs()
    # max_points_per_centroid 64 subsamples: the numpy draws agree
    for kw in ({}, {"max_points_per_centroid": 64}):
        jc = jkm.kmeans(x, 12, iters=10, seed=3, **kw)
        tc = tkm.kmeans(x, 12, iters=10, seed=3, device="cpu", **kw)
        np.testing.assert_allclose(tc, jc, atol=1e-4)
        counts = np.bincount(tkm.assign_clusters(x, tc, device="cpu"),
                             minlength=12)
        assert counts.min() > 0  # no cluster emptied: no reseed happened
    rng = np.random.default_rng(1)
    c = rng.normal(size=(13, 16)).astype(np.float32)
    xr = rng.normal(size=(700, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        tkm.assign_clusters(xr, c, block=128, chunk_rows=300, device="cpu"),
        jkm.assign_clusters(xr, c, block=128))
    with pytest.raises(ValueError):
        tkm.kmeans(np.zeros((4, 8), np.float32), 5, device="cpu")


def test_kmeans_empty_cluster_reseeds_finitely():
    """Duplicate rows empty clusters; the port's jitter comes from its own
    seeded generator (a documented difference), deterministically."""
    x = np.ones((256, 8), np.float32)
    a = tkm.kmeans(x, 16, iters=5, seed=0, device="cpu")
    b = tkm.kmeans(x, 16, iters=5, seed=0, device="cpu")
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_pq_training_coding_and_scoring_match_jax():
    rng = np.random.default_rng(2)
    x = _blobs(n_clusters=8, per=64, d=16, seed=2, spread=1.0)
    jcb = jpq.train_pq(x, 4, 16, iters=8, seed=5)
    tcb = tpq.train_pq(x, 4, 16, iters=8, seed=5, device="cpu")
    np.testing.assert_allclose(tcb, jcb, atol=1e-4)
    jcodes = jpq.encode_pq(x, jcb, block=100)
    tcodes = tpq.encode_pq(x, jcb, block=100, chunk_rows=300, device="cpu")
    np.testing.assert_array_equal(tcodes, jcodes)
    assert tcodes.dtype == np.uint8
    np.testing.assert_array_equal(tpq.decode_pq(tcodes, jcb),
                                  jpq.decode_pq(jcodes, jcb))
    packed = tpq.pack_codes4(tcodes)
    np.testing.assert_array_equal(packed, jpq.pack_codes4(jcodes))
    np.testing.assert_array_equal(tpq.unpack_codes4(packed),
                                  jpq.unpack_codes4(packed))
    np.testing.assert_array_equal(
        tpq.unpack_codes4(torch.from_numpy(packed)).numpy(),
        jpq.unpack_codes4(packed))
    q = rng.normal(size=(3, 16)).astype(np.float32)
    jl = np.asarray(jpq.pq_lut(jnp.asarray(q), jnp.asarray(jcb)))
    tl = tpq.pq_lut(torch.from_numpy(q), torch.from_numpy(jcb)).numpy()
    assert _rel_err(tl, jl) <= 1e-5
    codes = rng.integers(0, 16, (3, 50, 4)).astype(np.int32)
    js = np.asarray(jpq.pq_scores_from_codes(jnp.asarray(codes),
                                             jnp.asarray(jl)))
    ts = tpq.pq_scores_from_codes(torch.from_numpy(codes),
                                  torch.from_numpy(jl.copy())).numpy()
    assert _rel_err(ts, js) <= 1e-5
    with pytest.raises(ValueError):
        tpq.train_pq(x, 3, device="cpu")


def test_opq_matches_jax():
    x = _blobs(n_clusters=8, per=48, d=16, seed=4, spread=1.0)
    jr, jcb = jpq.train_opq(x, 4, 16, iters=2, pq_iters=4, seed=1)
    tr, tcb = tpq.train_opq(x, 4, 16, iters=2, pq_iters=4, seed=1,
                            device="cpu")
    np.testing.assert_allclose(tr, jr, atol=1e-4)
    np.testing.assert_allclose(tcb, jcb, atol=1e-4)


# ------------------------------------------------------------- IVFIndex


def _ivf_data(n=1800, d=16, nl=6, seed=0, nq=7):
    """Integer-valued rows around integer centroids, integer queries."""
    rng = np.random.default_rng(seed)
    cents = rng.integers(-12, 13, (nl, d)).astype(np.float32)
    x = cents[rng.integers(0, nl, n)] + rng.integers(-3, 4, (n, d))
    ids = (rng.permutation(n) + 100).astype(np.int64)
    q = rng.integers(-4, 5, (nq, d)).astype(np.float32)
    return x.astype(np.float32), ids, cents, q


def _pair(x, ids, cents, dtype, slot=128, **kw):
    j = JIVF.build(x, ids, len(cents), slot=slot, dtype=_JDT[dtype],
                   centroids=cents, **kw)
    t = IVFIndex.build(x, ids, len(cents), slot=slot, dtype=_TDT[dtype],
                       centroids=cents, device="cpu", **kw)
    return j, t


def _same_search(j, t, q, k, nprobe, exact=True):
    js, ji = j.search(q, k, nprobe=nprobe)
    ts, ti = t.search(q, k, nprobe=nprobe)
    assert ts.dtype == np.float32 and ti.dtype == np.int32
    assert ti.shape == ji.shape == (len(q), k)
    if exact:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
    else:
        np.testing.assert_array_equal(ti, ji)
        fin = np.isfinite(js)
        np.testing.assert_array_equal(fin, np.isfinite(ts))
        assert _rel_err(ts[fin], js[fin]) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_ivf_build_and_search_match_jax(dtype):
    x, ids, cents, q = _ivf_data()
    j, t = _pair(x, ids, cents, dtype)
    np.testing.assert_array_equal(t.bucket_ids.numpy(),
                                  np.asarray(j.bucket_ids))
    np.testing.assert_array_equal(t.bucket_cluster, j.bucket_cluster)
    np.testing.assert_array_equal(t.buckets.float().numpy(),
                                  np.asarray(j.buckets.astype(jnp.float32)))
    if dtype == "int8":
        np.testing.assert_array_equal(t.bucket_scales.numpy(),
                                      np.asarray(j.bucket_scales))
    for nprobe in (1, 3, t.n_buckets):
        _same_search(j, t, q, 40, nprobe, exact=dtype != "int8")
    # int8 scores are (q . c8) * s: exact dots, one rounding of the scale
    # product in each package, so ids EQUAL and values within 1e-5 above


@pytest.mark.parametrize("bits,opq", [(4, False), (8, False), (4, True),
                                      (8, True)])
def test_ivfpq_build_and_search_match_jax(bits, opq, tmp_path):
    x, ids, cents, q = _ivf_data(n=1200, seed=1)
    j, t = _pair(x, ids, cents, "float32", pq_m=4, pq_bits=bits, opq=opq)
    np.testing.assert_array_equal(t.bucket_ids.numpy(),
                                  np.asarray(j.bucket_ids))
    np.testing.assert_allclose(t.codebooks.numpy(), np.asarray(j.codebooks),
                               atol=1e-4)
    assert t._pq_packed == j._pq_packed == (bits == 4)
    # searches over the SAME codes and codebooks: the port loads the JAX
    # package's directory (LUT sums in another order: 1e-5)
    j.save(str(tmp_path / "j"))
    tj = IVFIndex.load(str(tmp_path / "j"), device="cpu")
    for nprobe in (2, tj.n_buckets):
        _same_search(j, tj, q, 30, nprobe, exact=False)


def test_ivf_full_probe_equals_flat_index_and_ragged_batches():
    x, ids, cents, q = _ivf_data(seed=2, nq=20)
    # ids in row order: both indexes then break score ties alike (the
    # flat index toward the smaller row, the IVF toward the smaller id)
    ids = np.sort(ids)
    t = IVFIndex.build(x, ids, len(cents), slot=128, dtype=torch.float32,
                       centroids=cents, device="cpu")
    flat = FlatIPIndex.build(x, ids, dtype=torch.float32, block_rows=512,
                             device="cpu")
    ts, ti = t.search(q, 25, nprobe=10**6)      # clamps: exact
    fs, fi = flat.search(q, 25)
    np.testing.assert_array_equal(ti, fi)
    np.testing.assert_array_equal(ts, fs)
    # ragged batches pad to a power of two >= 8 by repeating row 0; every
    # row answers as it does alone
    for b in (1, 3, 9, 17):
        s, i = t.search(q[:b], 25, nprobe=2)
        s1 = np.stack([t.search(q[r:r + 1], 25, nprobe=2)[0][0]
                       for r in range(b)])
        np.testing.assert_array_equal(s, s1)
        assert i.shape == (b, 25)
    assert t.warmup_batch_sizes(128) == [8, 16, 32, 64, 128]
    assert t.warmup_batch_sizes(20) == [8, 16, 20]
    e_s, e_i = t.search(q[:0], 5)
    assert e_s.shape == e_i.shape == (0, 5)


def test_ivf_search_rejects_what_the_reference_rejects():
    x, ids, cents, q = _ivf_data(n=600, seed=3)
    t = IVFIndex.build(x, ids, len(cents), slot=128, centroids=cents,
                       device="cpu")
    j = JIVF.build(x, ids, len(cents), slot=128, centroids=cents)
    for idx in (t, j):
        with pytest.raises(ValueError, match="nprobe\\*slot"):
            idx.search(q, 129, nprobe=1)
        with pytest.raises(ValueError, match="nprobe must be >= 1"):
            idx.search(q, 5, nprobe=0)
    # k beyond every row at full probe pads with (-inf, -1) in both
    _same_search(j, t, q, 700, t.n_buckets)


@pytest.mark.parametrize("dtype,pq", [("float32", None), ("int8", None),
                                      ("float32", 4)])
def test_ivf_add_remove_match_jax(dtype, pq, tmp_path):
    x, ids, cents, q = _ivf_data(n=900, seed=4)
    j, t = _pair(x[:700], ids[:700], cents, dtype,
                 **({} if pq is None else {"pq_m": pq}))
    if pq is not None:  # one set of codebooks and codes for both
        j.save(str(tmp_path / "pq"))
        t = IVFIndex.load(str(tmp_path / "pq"), device="cpu")
    steps = [("remove", ids[:40]), ("add", (x[700:760], ids[700:760])),
             ("add", (x[760:], ids[760:])),           # overflows clusters
             ("remove", ids[700:720]), ("add", (x[:30], ids[:30]))]
    for op, arg in steps:
        if op == "add":
            j = j.add(*arg)
            t = t.add(*arg)
        else:
            j = j.remove(arg)
            t = t.remove(arg)
        np.testing.assert_array_equal(t._host_ids(), j._host_ids())
        assert t.n_vectors == j.n_vectors
        np.testing.assert_array_equal(t.bucket_cluster, j.bucket_cluster)
    assert t.n_buckets > 6  # the overflow appended buckets
    _same_search(j, t, q, 30, 3, exact=dtype == "float32" and pq is None)
    _same_search(j, t, q, 30, t.n_buckets,
                 exact=dtype == "float32" and pq is None)


@pytest.mark.parametrize("dtype,pq", [("float32", None), ("int8", None),
                                      ("float32", 4)])
def test_ivf_directories_cross_between_packages(dtype, pq, tmp_path):
    x, ids, cents, q = _ivf_data(n=800, seed=5)
    kw = {} if pq is None else {"pq_m": pq, "pq_bits": 8}
    j, t = _pair(x, ids, cents, dtype, **kw)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    j.save(jd)
    t.save(td)
    assert ivf_exists(jd) and ivf_exists(td)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    if pq is None:  # same centroids, same rows: byte-identical files
        for name in os.listdir(jd):
            assert open(os.path.join(jd, name), "rb").read() == \
                open(os.path.join(td, name), "rb").read(), name
    load_dt = {"int8": (torch.int8, jnp.int8)}.get(
        dtype, (None, None) if pq else (torch.float32, jnp.float32))
    t_from_j = IVFIndex.load(jd, dtype=load_dt[0], device="cpu")
    j_from_t = JIVF.load(td, dtype=load_dt[1])
    exact = dtype == "float32" and pq is None
    _same_search(j, t_from_j, q, 30, 3, exact=exact)
    _same_search(j_from_t, t, q, 30, 3, exact=exact)
    with open(os.path.join(td, "ivf_meta.json")) as f:
        assert json.load(f)["format_version"] == 1


def test_ivf_load_dtype_rules(tmp_path):
    x, ids, cents, q = _ivf_data(n=500, seed=6)
    j = JIVF.build(x, ids, len(cents), slot=128, dtype=jnp.int8,
                   centroids=cents)
    j.save(str(tmp_path / "i8"))
    deq = IVFIndex.load(str(tmp_path / "i8"), dtype=torch.float32,
                        device="cpu")
    jdeq = JIVF.load(str(tmp_path / "i8"), dtype=jnp.float32)
    _same_search(jdeq, deq, q, 20, 3, exact=False)
    jf = JIVF.build(x, ids, len(cents), slot=128, dtype=jnp.float32,
                    centroids=cents)
    jf.save(str(tmp_path / "f"))
    with pytest.raises(ValueError, match="int8"):
        IVFIndex.load(str(tmp_path / "f"), dtype=torch.int8, device="cpu")
    assert IVFIndex.load(str(tmp_path / "f"), device="cpu").buckets.dtype \
        == torch.bfloat16


# ------------------------------------------------- flat index, refine


def test_flat_add_remove_save_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    n, d = 700, 16
    x = rng.integers(-5, 6, (n + 900, d)).astype(np.float32)
    ids = (rng.permutation(n + 900) + 1).astype(np.int64)
    q = rng.integers(-3, 4, (6, d)).astype(np.float32)
    for dtype in ("float32", "int8"):
        j = JFlat.build(x[:n], ids[:n], dtype=_JDT[dtype], block_rows=512)
        t = FlatIPIndex.build(x[:n], ids[:n], dtype=_TDT[dtype],
                              block_rows=512, device="cpu")
        # fills the padding tail, then overflows into a new slab
        for op, arg in (("add", (x[n:n + 200], ids[n:n + 200])),
                        ("remove", ids[:50]),
                        ("add", (x[n + 200:], ids[n + 200:]))):
            j = getattr(j, op)(*arg) if op == "add" else j.remove(arg)
            t = getattr(t, op)(*arg) if op == "add" else t.remove(arg)
            np.testing.assert_array_equal(t._host_ids(), j._host_ids())
            js, ji = j.search(q, 20)
            ts, ti = t.search(q, 20)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_allclose(ts, js, rtol=1e-6)
        assert t.embeddings.shape[0] == 2048
        jd, td = str(tmp_path / f"j{dtype}"), str(tmp_path / f"t{dtype}")
        j.save(jd, rows_per_shard=400)
        t.save(td, rows_per_shard=400)
        for name in sorted(os.listdir(jd)):
            assert open(os.path.join(jd, name), "rb").read() == \
                open(os.path.join(td, name), "rb").read(), name
    assert t.warmup_batch_sizes(300) == [128, 256, 300]


def test_refine_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    n, d = 900, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    ids = (rng.permutation(n) + 5).astype(np.int64)
    q = rng.normal(size=(5, d)).astype(np.float32)
    for dtype in ("float32", "int8"):
        store = str(tmp_path / dtype)
        jpersist.write_embeddings(store, x, ids, rows_per_shard=300,
                                  dtype=dtype)
        cand = np.concatenate([ids[rng.integers(0, n, (5, 30))],
                               np.full((5, 3), -1), np.full((5, 2), 99999)],
                              1)
        tr = refine.DiskRefiner(store).rescore(q, cand)
        jr = jrefine.DiskRefiner(store).rescore(q, cand)
        np.testing.assert_array_equal(tr, jr)
    cents = jkm.kmeans(x, 6, iters=5, seed=0)
    j = JIVF.build(x, ids, 6, slot=256, centroids=cents, pq_m=4)
    j.save(str(tmp_path / "pq"))
    t = IVFIndex.load(str(tmp_path / "pq"), device="cpu")
    jref = jrefine.RefinedIndex(j, jrefine.DiskRefiner(store), factor=3)
    tref = refine.RefinedIndex(t, refine.DiskRefiner(store), factor=3)
    js, ji = jref.search(q, 10, nprobe=2)
    ts, ti = tref.search(torch.from_numpy(q), 10, nprobe=2)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    assert tref.n_vectors == n and tref.slot == 256
    with pytest.raises(ValueError):
        refine.RefinedIndex(t, refine.DiskRefiner(store), factor=0)


# ----------------------------------------------------------- index CLI


def test_cli_index_builds_ivf_the_jax_package_reads(tmp_path):
    from cldrd_tpu_torch.cli import index as t_index

    rng = np.random.default_rng(9)
    n, d = 600, 32
    x = rng.normal(size=(n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64) + 3
    q = rng.normal(size=(4, d)).astype(np.float32)
    out = str(tmp_path / "store")
    persistence.write_embeddings(out, x, ids, dtype="int8")
    base = ["--collection", "unused.tsv", "--out", out, "--device", "cpu",
            "--ivf-only", "--ivf-nlist", "4", "--ivf-slot", "128"]
    assert t_index.main([*base, "--ivf-nprobe", "2"]) == 0
    j = JIVF.load(os.path.join(out, "ivf"), dtype=jnp.int8)
    t = IVFIndex.load(os.path.join(out, "ivf"), dtype=torch.int8,
                      device="cpu")
    assert j.nprobe == 2 and j.bucket_scales is not None
    _same_search(j, t, q, 10, 2, exact=False)
    # at full probe the IVF companion equals the flat store's exact search
    flat = JFlat.build(*jpersist.read_embeddings(out), dtype=jnp.float32,
                       precision="highest")
    _, fi = flat.search(q, 10)
    jf = JIVF.load(os.path.join(out, "ivf"), dtype=jnp.float32,
                   precision="highest")
    np.testing.assert_array_equal(jf.search(q, 10, nprobe=100)[1], fi)
    assert t_index.main([*base, "--pq-m", "8"]) == 0
    jpq_idx = JIVF.load(os.path.join(out, "ivf"))
    tpq_idx = IVFIndex.load(os.path.join(out, "ivf"), device="cpu")
    assert jpq_idx.is_pq and jpq_idx.codebooks.shape == (8, 16, 4)
    _same_search(jpq_idx, tpq_idx, q, 10, 4, exact=False)
    for argv in (["--pq-m", "8"], ["--opq"], ["--ivf-only"]):
        with pytest.raises(SystemExit):
            t_index.main(["--collection", "c", "--out", out,
                          "--device", "cpu", *argv])
    with pytest.raises(SystemExit):  # no flat store there
        t_index.main(["--collection", "c", "--out", str(tmp_path / "none"),
                      "--ivf-only", "--ivf-nlist", "4", "--device", "cpu"])
