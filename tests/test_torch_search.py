"""cldrd_tpu_torch.search.mips and its two kernels' plain versions, held to
the JAX package on the same numpy-seeded inputs.

The JAX side runs the extract kernel in Pallas interpret mode (as
tests/test_index_search.py does); the fused scores+bin-max kernel has no
interpret flag, so its XLA twin in ``_scores_and_binmax`` is the reference
there. Integer-valued inputs make every dot product exact in both
frameworks, so values, positions and ``ok`` flags must be EQUAL."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cldrd_tpu.search import mips as jmips
from cldrd_tpu_torch.ops import extract_topk as k1
from cldrd_tpu_torch.ops import fused_binmax as k2
from cldrd_tpu_torch.search import mips


def _int_data(rng, bz, n, d, lo=-4, hi=5):
    q = rng.integers(lo, hi, (bz, d)).astype(np.float32)
    c = rng.integers(lo, hi, (n, d)).astype(np.float32)
    return q, c


def _jax_topk(q, c, ids, k, q_dtype, scales=None, **kw):
    out = jmips.topk_binmax(
        jnp.asarray(q, q_dtype), jnp.asarray(c), jnp.asarray(ids), k,
        row_scales=None if scales is None else jnp.asarray(scales), **kw)
    return [np.asarray(x) for x in out]


def _torch_topk(q, c, ids, k, q_dtype, scales=None, **kw):
    out = mips.topk_binmax(
        torch.from_numpy(q).to(q_dtype), torch.from_numpy(c),
        torch.from_numpy(ids), k,
        row_scales=None if scales is None else torch.from_numpy(scales),
        **kw)
    return [x.numpy() for x in out]


def _oracle(q, c, k, ids=None, scales=None):
    """numpy exact top-k: ties to the lower row (stable sort)."""
    s = q.astype(np.float64) @ c.astype(np.float64).T
    s = s.astype(np.float32)
    if scales is not None:
        s = s * scales[None, :]
    if ids is not None:
        s = np.where(ids[None, :] >= 0, s, -np.inf)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, 1), order


@pytest.mark.parametrize("store", ["float32", "bfloat16", "int8"])
def test_extract_route_matches_jax_interpret_kernel(store, monkeypatch):
    """The extract route (plain K1 on the CPU) against the Pallas kernel in
    interpret mode: equal values, positions and ok flags."""
    monkeypatch.setattr(jmips, "_INTERPRET", True)
    rng = np.random.default_rng({"float32": 0, "bfloat16": 1, "int8": 2}[store])
    bz, d, k = 128, 32, 20
    n = 8192 if store == "int8" else 4096
    q, c = _int_data(rng, bz, n, d)
    ids = np.arange(n, dtype=np.int32)
    ids[-300:] = -1  # padding rows
    scales = None
    if store == "int8":
        c = rng.integers(-127, 128, (n, d)).astype(np.int8)
        scales = rng.uniform(0.5, 1.5, n).astype(np.float32)
        jq, tq, jc, tc = jnp.bfloat16, torch.bfloat16, c, c
    elif store == "bfloat16":
        jq, tq = jnp.bfloat16, torch.bfloat16
        jc = jnp.asarray(c, jnp.bfloat16)
        tc = c
    else:
        jq, tq, jc, tc = jnp.float32, torch.float32, c, c
    assert mips._extract_eligible(bz, n, 128)
    kw = dict(return_positions=True, on_miss="flag")
    jv, jp, jok = _jax_topk(q, jc, ids, k, jq, scales, **kw)
    tc_t = torch.from_numpy(np.asarray(tc))
    if store == "bfloat16":
        tc_t = tc_t.to(torch.bfloat16)
    tv, tp, tok = [x.numpy() for x in mips.topk_binmax(
        torch.from_numpy(q).to(tq), tc_t, torch.from_numpy(ids), k,
        row_scales=None if scales is None else torch.from_numpy(scales),
        **kw)]
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tok, jok)
    assert tok.any()


def test_extract_kernel_outputs_match_jax_kernel(monkeypatch):
    """K1's plain version against the Pallas kernel's raw outputs (the
    kernel's [nsup, R2, B] / [nsup, 8, B] layouts transposed to B-major)."""
    from jax.experimental import pallas as pl

    captured = {}
    real = pl.pallas_call

    def spy(*a, **kw):
        fn = real(*a, **kw)

        def run(*ops):
            out = fn(*ops)
            captured["out"] = [np.asarray(x) for x in out]
            return out
        return run

    monkeypatch.setattr(jmips, "_INTERPRET", True)
    monkeypatch.setattr(pl, "pallas_call", spy)
    rng = np.random.default_rng(5)
    bz, n, d, k = 128, 4096, 32, 20
    q, c = _int_data(rng, bz, n, d)
    ids = np.arange(n, dtype=np.int32)
    ids[100:140] = -1
    jmips._binmax_segment_extract(jnp.asarray(q), jnp.asarray(c),
                                  jnp.asarray(ids), k, 128, on_miss="flag")
    sup_v, sup_p, rem1 = captured["out"]
    nsup = n // 2048
    R = mips._extract_rounds(n, bz, k, 128)
    R2 = sup_v.shape[1]
    tv, tp, tr = k1.extract_topk(torch.from_numpy(q), torch.from_numpy(c),
                                 torch.from_numpy(ids), R, R2)
    np.testing.assert_array_equal(tv.numpy(), sup_v.transpose(2, 0, 1))
    np.testing.assert_array_equal(tp.numpy(), sup_p.transpose(2, 0, 1))
    np.testing.assert_array_equal(tr.numpy(), rem1.max(1).T)
    assert tv.shape == (bz, nsup, R2)


@pytest.mark.parametrize("bin_rows", [64, 256])
def test_extract_kernel_outputs_match_jax_kernel_at_other_bins(
        bin_rows, monkeypatch):
    """K1's plain version at the other bin sizes the extract route admits
    (64 and 256 at batch 128) against the Pallas kernel's raw outputs."""
    from jax.experimental import pallas as pl

    captured = {}
    real = pl.pallas_call

    def spy(*a, **kw):
        fn = real(*a, **kw)

        def run(*ops):
            out = fn(*ops)
            captured["out"] = [np.asarray(x) for x in out]
            return out
        return run

    monkeypatch.setattr(jmips, "_INTERPRET", True)
    monkeypatch.setattr(pl, "pallas_call", spy)
    rng = np.random.default_rng(6)
    bz, n, d, k = 128, 4096, 32, 20
    assert mips._extract_eligible(bz, n, bin_rows)
    q, c = _int_data(rng, bz, n, d)
    ids = np.arange(n, dtype=np.int32)
    ids[100:140] = -1
    jmips._binmax_segment_extract(jnp.asarray(q), jnp.asarray(c),
                                  jnp.asarray(ids), k, bin_rows,
                                  on_miss="flag")
    sup_v, sup_p, rem1 = captured["out"]
    R = mips._extract_rounds(n, bz, k, bin_rows)
    tv, tp, tr = k1.extract_topk(torch.from_numpy(q), torch.from_numpy(c),
                                 torch.from_numpy(ids), R, sup_v.shape[1],
                                 bin_rows)
    np.testing.assert_array_equal(tv.numpy(), sup_v.transpose(2, 0, 1))
    np.testing.assert_array_equal(tp.numpy(), sup_p.transpose(2, 0, 1))
    np.testing.assert_array_equal(tr.numpy(), rem1.max(1).T)


class TestAdversarial:
    """The clustered corpora of tests/test_index_search.py:216 and :961."""

    @staticmethod
    def _adversarial_corpus(n, d, n_planted, rng):
        c = rng.standard_normal((n, d)).astype(np.float32) * 0.01
        u = rng.standard_normal(d).astype(np.float32)
        u /= np.linalg.norm(u)
        scales = 5.0 + np.linspace(1.0, 0.0, n_planted, dtype=np.float32)
        c[:n_planted] = scales[:, None] * u[None, :]
        return c, u

    def test_extract_route_flags_match(self, monkeypatch):
        monkeypatch.setattr(jmips, "_INTERPRET", True)
        rng = np.random.default_rng(1)
        bz, n, d, k = 128, 4096, 32, 20
        c, u = self._adversarial_corpus(n, d, n_planted=k, rng=rng)
        q = rng.standard_normal((bz, d)).astype(np.float32) * 0.01
        q[3] = u
        ids = np.arange(n, dtype=np.int32)
        kw = dict(return_positions=True, on_miss="flag")
        jv, jp, jok = _jax_topk(q, c, ids, k, jnp.float32, **kw)
        tv, tp, tok = _torch_topk(q, c, ids, k, torch.float32, **kw)
        assert not tok[3]
        np.testing.assert_array_equal(tok, jok)
        ref_v, ref_p = _oracle(q, c, k)
        for r in np.nonzero(tok)[0]:
            np.testing.assert_array_equal(tp[r], ref_p[r])
            np.testing.assert_allclose(tv[r], ref_v[r], rtol=1e-5)
        # 'fallback' re-scans in the graph: every row exact
        fv, fp = _torch_topk(q, c, ids, k, torch.float32,
                             return_positions=True)
        np.testing.assert_array_equal(fp, ref_p)

    def test_portable_route_clustered_fallback(self):
        rng = np.random.default_rng(1)
        n, d, k, L = 1024, 32, 24, 16
        c = rng.standard_normal((n, d)).astype(np.float32) * 0.01
        q = rng.standard_normal((2, d)).astype(np.float32)
        boost = (q[0] + q[1]) / np.linalg.norm(q[0] + q[1])
        c[64:80] = boost[None, :] * np.linspace(5.0, 6.0, 16)[:, None]
        ids = np.arange(n, dtype=np.int32)
        tv, tp, tok = _torch_topk(q, c, ids, k, torch.float32, bin_rows=L,
                                  extract=2, on_miss="flag")
        jv, jp, jok = _jax_topk(q, c, ids, k, jnp.float32, bin_rows=L,
                                extract=2, on_miss="flag")
        np.testing.assert_array_equal(tok, jok)
        assert not tok.all()
        v, i = _torch_topk(q, c, ids, k, torch.float32, bin_rows=L,
                           extract=2)
        ref_v, ref_p = _oracle(q, c, k)
        np.testing.assert_array_equal(i, ref_p)
        np.testing.assert_allclose(v, ref_v, rtol=1e-5)


@pytest.mark.parametrize("scaled", [False, True])
def test_fused_binmax_plain_matches_xla_twin(scaled):
    """K2's plain version against the reference's XLA twin at bz=136 (a
    batch the extract route does not take)."""
    rng = np.random.default_rng(3)
    bz, n, d, L = 136, 4096, 32, 128
    q, c = _int_data(rng, bz, n, d)
    ids = np.arange(n, dtype=np.int32)
    ids[::7] = -1
    scales = rng.uniform(0.5, 1.5, n).astype(np.float32) if scaled else None
    if scaled:
        c = rng.integers(-127, 128, (n, d)).astype(np.int8)
        jc, tc = jnp.asarray(c), torch.from_numpy(c)
    else:
        jc = jnp.asarray(c, jnp.bfloat16)
        tc = torch.from_numpy(c).to(torch.bfloat16)
    js, jb = jmips._scores_and_binmax(
        jnp.asarray(q, jnp.bfloat16), jc, jnp.asarray(ids), L,
        seg_scales=None if scales is None else jnp.asarray(scales))
    ts, tb = k2.fused_binmax(
        torch.from_numpy(q).to(torch.bfloat16), tc, torch.from_numpy(ids), L,
        None if scales is None else torch.from_numpy(scales))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # the whole portable route agrees too, ok flags included
    jv, jp, jok = [np.asarray(x) for x in jmips.topk_binmax(
        jnp.asarray(q, jnp.bfloat16), jc, jnp.asarray(ids), 50,
        return_positions=True, on_miss="flag",
        row_scales=None if scales is None else jnp.asarray(scales))]
    tv, tp, tok = [x.numpy() for x in mips.topk_binmax(
        torch.from_numpy(q).to(torch.bfloat16), tc, torch.from_numpy(ids), 50,
        return_positions=True, on_miss="flag",
        row_scales=None if scales is None else torch.from_numpy(scales))]
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tok, jok)


def test_topk_with_payload_tie_order():
    """Exact ties break toward the smaller payload, whatever the layout."""
    rng = np.random.default_rng(4)
    v = rng.integers(0, 6, (4, 300)).astype(np.float32)
    p = np.stack([rng.permutation(300) for _ in range(4)]).astype(np.int32)
    jv, jp = jmips._topk_with_payload(jnp.asarray(v), jnp.asarray(p), 40)
    tv, tp = mips._topk_with_payload(torch.from_numpy(v),
                                     torch.from_numpy(p), 40)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # chunked selection over a wide row keeps the same order
    w = rng.integers(0, 50, (2, 20_000)).astype(np.float32)
    wp = np.stack([rng.permutation(20_000) for _ in range(2)]).astype(np.int32)
    jv, jp = jmips.topk_with_payload_chunked(jnp.asarray(w), jnp.asarray(wp),
                                             300)
    tv, tp = mips.topk_with_payload_chunked(torch.from_numpy(w),
                                            torch.from_numpy(wp), 300)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_dense_top_k_tie_order_matches_lax_top_k():
    x = np.array([[0.0, -0.0, 1.0, -0.0, 0.0, 1.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = mips._top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("route", ["dense", "streaming", "portable",
                                   "segmented", "extract", "flat_index",
                                   "flat_index_stream"])
def test_routes_match_numpy_oracle(route):
    """Every route is exact against the numpy oracle, ties included
    (integer-valued inputs: scores are exact in every framework)."""
    from cldrd_tpu_torch.index import FlatIPIndex

    rng = np.random.default_rng(7)
    bz = 128 if route == "extract" else 8
    n, d, k = 4096, 16, 30
    q, c = _int_data(rng, bz, n, d)
    ids = np.arange(n, dtype=np.int32)
    ref_v, ref_p = _oracle(q, c, k)
    tq, tc, ti = map(torch.from_numpy, (q, c, ids))
    if route == "dense":
        v, p = mips.topk_dense(tq, tc, ti, k)
    elif route == "streaming":
        v, p = mips.topk_streaming(tq, tc, ti, k, block_rows=1024)
    elif route == "portable":
        v, p = mips.topk_binmax(tq, tc, ti, k, bin_rows=32, extract=4)
    elif route == "segmented":
        v, p = mips.topk_binmax(tq, tc, ti, k, bin_rows=16, extract=4,
                                segment_rows=1024)
    elif route == "extract":
        assert mips._extract_eligible(bz, n, 128)
        v, p = mips.topk_binmax(tq, tc, ti, k)
    else:
        method = "stream" if route == "flat_index_stream" else "binmax"
        ext = np.arange(10_000, 10_000 + n, dtype=np.int64)
        index = FlatIPIndex.build(c, ext, dtype=torch.float32,
                                  block_rows=1024, method=method,
                                  device="cpu")
        v, p = index.search(q, k)
        np.testing.assert_array_equal(p, ext[ref_p])
        np.testing.assert_array_equal(v, ref_v)
        return
    np.testing.assert_array_equal(p.numpy(), ref_p)
    np.testing.assert_array_equal(v.numpy(), ref_v)


def test_kernel_wrappers_take_plain_version_only_on_cpu():
    """On the CPU the wrappers run the plain versions and count no launch;
    on any other device they never fall back."""
    rng = np.random.default_rng(8)
    q, c = _int_data(rng, 128, 2048, 16)
    ids = torch.arange(2048, dtype=torch.int32)
    before = (k1.LAUNCHES, k2.LAUNCHES)
    a = k1.extract_topk(torch.from_numpy(q), torch.from_numpy(c), ids, 3, 8)
    b = k1.extract_topk_plain(torch.from_numpy(q), torch.from_numpy(c), ids,
                              3, 8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    k2.fused_binmax(torch.from_numpy(q), torch.from_numpy(c), ids, 128)
    assert (k1.LAUNCHES, k2.LAUNCHES) == before
    meta = torch.empty((128, 16), device="meta")
    with pytest.raises(ValueError):
        k1.extract_topk(meta, meta, ids, 3, 8)
    with pytest.raises(ValueError):
        k2.fused_binmax(meta, meta, ids, 128)


@pytest.mark.parametrize("q_dtype,c_dtype,bz,d,bin_rows,route", [
    (torch.bfloat16, torch.int8, 512, 768, 128, "sm90"),   # 8.8M int8
    (torch.bfloat16, torch.bfloat16, 512, 768, 128, "sm90"),
    (torch.bfloat16, torch.int8, 64, 768, 128, "sm90"),
    (torch.bfloat16, torch.bfloat16, 1024, 128, 128, "sm90"),
    (torch.bfloat16, torch.int8, 128, 768, 32, "generic"),
    (torch.bfloat16, torch.int8, 512, 768, 64, "generic"),  # other bins
    (torch.bfloat16, torch.int8, 512, 768, 256, "generic"),
    (torch.bfloat16, torch.float32, 512, 768, 128, "generic"),
    (torch.float32, torch.float32, 512, 768, 128, "generic"),
    (torch.float32, torch.int8, 512, 768, 128, "generic"),
    (torch.bfloat16, torch.int8, 512, 832, 128, "generic"),  # D % 128
    (torch.bfloat16, torch.int8, 512, 896, 128, "generic"),  # D > 768
    (torch.bfloat16, torch.int8, 512, 32, 128, "generic"),
])
def test_k1_kernel_route_by_dtype_and_shape(q_dtype, c_dtype, bz, d,
                                            bin_rows, route):
    """Which K1 kernel a launch of batch ``bz`` takes is a function of
    dtypes, width and bin size alone, pinned here without a card."""
    assert bz % 64 == 0  # every batch extract_topk launches
    assert k1.kernel_route(q_dtype, c_dtype, d, bin_rows) == route


@pytest.mark.parametrize("hbm_dtype,n,nq,batch", [
    (torch.int8, 8_847_360, 512, 512),      # the search phase, int8
    (torch.bfloat16, 1_048_576, 512, 512),  # the search phase, bf16
    (torch.bfloat16, 32_768, 1024, 512),    # the pipeline's retrieve
    (torch.int8, 32_768, 1000, 512),        # a ragged last batch
    (torch.int8, 1_048_576, 5, 128),        # a flat daemon's request
])
def test_every_main_path_k1_launch_takes_sm90(hbm_dtype, n, nq, batch):
    """The batches FlatIPIndex makes (padded to multiples of 128) at the
    main path's widths and stores reach the extract route and, through
    it, the sm90 kernel: the query dtype is the index's, the bin size is
    the one topk_binmax settles on."""
    from cldrd_tpu_torch.index.flat_index import query_dtype_for

    q_dtype = query_dtype_for(hbm_dtype, "default")
    bin_rows = 128
    while bin_rows > 8 and n % bin_rows:
        bin_rows //= 2
    batch = -(-batch // 128) * 128
    for b in range(0, nq, batch):
        bz = -(-min(batch, nq - b) // 128) * 128
        assert mips._extract_eligible(bz, n, bin_rows)
        assert bz % 64 == 0
        assert k1.kernel_route(q_dtype, hbm_dtype, 768, bin_rows) == "sm90"
