"""The port's multi-device paths held to cldrd_tpu on the CPU: corpus
sharded search (``sharded_topk``, the sharded flat index, its on-device
build and ``load_index(mesh=)``), the sharded IVF / IVFPQ store, the
CLIs' ``--shards`` / ``--devices``, data-parallel training over a gloo
group, and the multi-process bring-up.

The JAX side shards over the virtual CPU devices of ``tests/conftest.py``;
the port's CPU mesh repeats the CPU device. Integer-valued inputs make
every dot exact, so sharded results must EQUAL the reference's (values,
ids, positions, certificates) and saved stores must be byte-identical.
Training runs fp32 at dropout 0 on two gloo ranks (``torch_dp_worker``,
JAX-free, spawned) against ``JaxTrainer(mesh=make_mesh(2))`` with the
Trainer parity tolerances of ``tests/test_torch_train.py``: step losses
to 1e-4 relative, final params to 1e-4 relative in norm.
"""
import contextlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cldrd_tpu.cli import retrieve as j_retrieve
from cldrd_tpu.data.nway_dataset import NwayDataset as JaxDataset
from cldrd_tpu.data.sequence_dataset import SequenceDataset as JSeq
from cldrd_tpu.data.tokenization import HashTokenizer as JaxTokenizer
from cldrd_tpu.index import FlatIPIndex as JFlat
from cldrd_tpu.index import IVFIndex as JIVF
from cldrd_tpu.index import builder as jbuilder
from cldrd_tpu.models import DistilBertConfig as JaxConfig
from cldrd_tpu.parallel import CORPUS_AXIS as J_CORPUS
from cldrd_tpu.parallel import make_mesh as jmake_mesh
from cldrd_tpu.search import mips as jmips
from cldrd_tpu.train import TrainConfig as JaxTrainConfig
from cldrd_tpu.train import Trainer as JaxTrainer
from cldrd_tpu_torch.cli import index as t_index
from cldrd_tpu_torch.cli import retrieve as t_retrieve
from cldrd_tpu_torch.cli import serve as t_serve
from cldrd_tpu_torch.data import HashTokenizer
from cldrd_tpu_torch.data.sequence_dataset import SequenceDataset as TSeq
from cldrd_tpu_torch.index import FlatIPIndex, IVFIndex, load_index
from cldrd_tpu_torch.index import builder as tbuilder
from cldrd_tpu_torch.models import params_from_flax
from cldrd_tpu_torch.parallel import (
    CORPUS_AXIS,
    Mesh,
    Sharded,
    make_mesh,
    multihost,
    shard_rows,
)
from cldrd_tpu_torch.search import mips as tmips

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dp_worker  # noqa: E402
from test_torch_pipeline import _checkpoint, _corpus, _run_rows  # noqa: E402
from test_torch_train import _write_corpus  # noqa: E402


def _cpu_mesh(n):
    return make_mesh(n, CORPUS_AXIS, "cpu")


def _int_corpus(n, d, nq, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(-4, 5, (n, d)).astype(np.float32)
    ids = (rng.permutation(10 * n)[:n] + 7).astype(np.int64)
    q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    return q, c, ids


# ---------------------------------------------------------------- devices


def test_make_mesh_and_sharded_rows():
    mesh = make_mesh(3, CORPUS_AXIS, "cpu")
    assert mesh.size == 3 and mesh.axis_name == CORPUS_AXIS
    assert make_mesh(None, device="cpu").size == 1   # the one CPU
    assert make_mesh(0, device="cpu").size == 1
    with pytest.raises(ValueError):
        make_mesh(-1, device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError):   # more GPUs than are visible
            make_mesh(torch.cuda.device_count() + 1)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(1)                  # the CUDA default never falls back
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    s = shard_rows(x, mesh, torch.bfloat16)
    assert isinstance(s, Sharded) and s.part_rows == 4
    assert tuple(s.shape) == (12, 2) and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(s.cpu().float().numpy(), x)
    np.testing.assert_array_equal(s.take(np.array([11, 0, 5])).float(),
                                  x[[11, 0, 5]])
    with pytest.raises(ValueError):
        shard_rows(x[:10], mesh)
    with pytest.raises(ValueError):
        Mesh(())


# ------------------------------------------------------------ sharded_topk


@pytest.mark.parametrize("method,positions,flag", [
    ("binmax", False, False), ("binmax", True, False),
    ("binmax", True, True), ("stream", False, False),
    ("stream", True, True)])
def test_sharded_topk_equals_reference(monkeypatch, method, positions,
                                       flag):
    """4 shards, integer data: values, ids or global positions, and the
    AND of the shards' certificates EQUAL the reference's shard_map."""
    monkeypatch.setattr(jmips, "_INTERPRET", True)
    q, c, ids = _int_corpus(4 * 1024, 32, 64, seed=0)
    ids[5::97] = -1                 # padding rows never surface
    k, block = 24, 256
    kw = dict(block_rows=block, method=method, return_positions=positions,
              on_miss="flag" if flag else "fallback")
    ref = jmips.sharded_topk(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(ids, jnp.int32), k,
        jmake_mesh(4, J_CORPUS), J_CORPUS, **kw)
    mesh = _cpu_mesh(4)
    got = tmips.sharded_topk(
        torch.from_numpy(q), shard_rows(c, mesh),
        shard_rows(ids.astype(np.int32), mesh), k, mesh, **kw)
    assert len(got) == len(ref) == (3 if flag else 2)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if positions:
        assert int(got[1].max()) >= 1024    # shard offsets were added


def test_sharded_topk_int8_scales(monkeypatch):
    monkeypatch.setattr(jmips, "_INTERPRET", True)
    q, c, ids = _int_corpus(4 * 1024, 32, 64, seed=1)
    codes = c.astype(np.int8)
    scales = np.random.default_rng(2).choice(
        [0.5, 1.0, 2.0, 0.25], len(c)).astype(np.float32)
    ref = jmips.sharded_topk(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(codes),
        jnp.asarray(ids, jnp.int32), 16, jmake_mesh(4, J_CORPUS), J_CORPUS,
        return_positions=True, on_miss="flag",
        row_scales=jnp.asarray(scales))
    mesh = _cpu_mesh(4)
    got = tmips.sharded_topk(
        torch.from_numpy(q).bfloat16(), shard_rows(codes, mesh),
        shard_rows(ids.astype(np.int32), mesh), 16, mesh,
        return_positions=True, on_miss="flag",
        row_scales=shard_rows(scales, mesh))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ----------------------------------------------------------- flat index


@pytest.mark.parametrize("store", ["float32", "int8"])
def test_sharded_flat_index_matches_reference(monkeypatch, tmp_path,
                                              store):
    """8 shards (the reference's 8-device cases): results EQUAL the
    reference's sharded index and the port's one-device index, padding
    never surfaces, the stream method agrees, the saved store is
    byte-identical and ``load_index(mesh=)`` loads it back into shards;
    add/remove raise."""
    monkeypatch.setattr(jmips, "_INTERPRET", True)
    q, c, ids = _int_corpus(3000, 32, 8, seed=3)   # 3000 rows: padded
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "int8": (jnp.int8, torch.int8)}[store]
    mesh = _cpu_mesh(8)
    ref = JFlat.build(c, ids, mesh=jmake_mesh(8, J_CORPUS), dtype=jdt,
                      block_rows=128)
    ours = FlatIPIndex.build(c, ids, dtype=tdt, block_rows=128, mesh=mesh)
    one = FlatIPIndex.build(c, ids, dtype=tdt, block_rows=128, device="cpu")
    assert tuple(ours.embeddings.shape) == tuple(ref.embeddings.shape)
    assert len(ours.embeddings.parts) == 8
    js, ji = ref.search(q, 25)
    ts, ti = ours.search(q, 25)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti, one.search(q, 25)[1])
    assert (ti >= 7).all() and ours.n_vectors == 3000
    stream = FlatIPIndex(ours.embeddings, ours.row_ids, 128, "stream",
                         "default", ours.row_scales, mesh)
    np.testing.assert_array_equal(stream.search(q, 25)[1], ti)
    np.testing.assert_allclose(ours.reconstruct(ids[:9]),
                               one.reconstruct(ids[:9]))
    ref.save(str(tmp_path / "j"))
    ours.save(str(tmp_path / "t"))
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    back = load_index(str(tmp_path / "t"), dtype=tdt, block_rows=128,
                      mesh=mesh)
    assert back.mesh is mesh and isinstance(back.embeddings, Sharded)
    np.testing.assert_array_equal(back.search(q, 25)[1], ti)
    with pytest.raises(NotImplementedError):
        ours.add(c[:2], np.array([1, 2]))
    with pytest.raises(NotImplementedError):
        ours.remove([int(ids[0])])


def test_sharded_flat_index_recovers_per_query(monkeypatch):
    """The reference's recovery case: a query whose top-k all sit in one
    bin of shard 0 fails the certificate there; the sharded index
    re-scans it through the sharded streaming path and answers exactly."""
    monkeypatch.setattr(jmips, "_INTERPRET", True)
    rng = np.random.default_rng(5)
    n, d, k = 4 * 8192, 32, 20
    c = rng.integers(-2, 3, (n, d)).astype(np.float32)
    u = np.zeros(d, np.float32)
    u[0] = 1.0
    c[:k] = (40 + np.arange(k, 0, -1, dtype=np.float32))[:, None] * u
    ids = rng.permutation(np.arange(9_000, 9_000 + n)).astype(np.int64)
    q = rng.integers(-1, 2, (6, d)).astype(np.float32)
    q[:, 0] = 0
    q[2] = 8 * u
    mesh = _cpu_mesh(4)
    ours = FlatIPIndex.build(c, ids, dtype=torch.float32, block_rows=1024,
                             mesh=mesh)
    ref = JFlat.build(c, ids, mesh=jmake_mesh(4, J_CORPUS),
                      dtype=jnp.float32, block_rows=1024)
    ts, ti = ours.search(q, k)
    js, ji = ref.search(q, k)
    assert ours.rescued_queries >= 1
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti[2], ids[:k])


# ------------------------------------------------------- on-device build


def _toy_encoders():
    """A passage encoder computed alike in numpy, JAX and torch: the sum
    over real tokens of a small-integer row per token id (exact)."""
    w = np.random.default_rng(7).integers(-3, 4, (512, 16)).astype(
        np.float32)

    def emb(tokens):
        m = np.asarray(tokens["attention_mask"]).astype(np.float32)
        ids = np.asarray(tokens["input_ids"]).astype(np.int64)
        return (w[ids] * m[..., None]).sum(1)

    return emb


def _collection(path, n=101):
    rng = np.random.default_rng(9)
    with open(path, "w") as f:
        for i in range(n):
            words = " ".join(f"w{rng.integers(60)}"
                             for _ in range(rng.integers(1, 14)))
            f.write(f"{i + 50}\t{words}\n")
    return str(path)


@pytest.mark.parametrize("store,ladder", [("float32", None), ("int8", None),
                                          ("float32", ())])
def test_sharded_build_matches_reference(tmp_path, store, ladder):
    """``build_index_on_device(mesh=)`` (8 devices, 101 rows: a ragged
    final batch) against the reference's sharded build: the ids buffer
    EQUAL, the rows within 1e-5, and the same search results."""
    emb = _toy_encoders()
    path = _collection(tmp_path / "c.tsv")
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "int8": (jnp.int8, torch.int8)}[store]
    jmesh = jmake_mesh(8, J_CORPUS)
    mesh = _cpu_mesh(8)

    def jenc(tokens):
        return jax.device_put(jnp.asarray(emb(tokens)),
                              jax.sharding.NamedSharding(
                                  jmesh, jax.sharding.PartitionSpec(
                                      J_CORPUS)))

    def tenc(tokens):
        return shard_rows(emb(tokens), mesh)

    tenc.mesh = mesh
    kw = dict(block_rows=16, bucket_lengths=ladder)
    ref = jbuilder.build_index_on_device(
        jenc, JSeq.create_from_seqs_file(path, JaxTokenizer(512), 16,
                                         is_query=False),
        16, 16, dtype=jdt, mesh=jmesh, axis_name=J_CORPUS, **kw)
    ours = tbuilder.build_index_on_device(
        tenc, TSeq.create_from_seqs_file(path, HashTokenizer(512), 16,
                                         is_query=False),
        16, 16, dtype=tdt, mesh=mesh, **kw)
    np.testing.assert_array_equal(ours.row_ids.cpu().numpy(),
                                  np.asarray(ref.row_ids))
    te = ours.embeddings.cpu().float().numpy()
    je = np.asarray(ref.embeddings, np.float32)
    if store == "int8":
        # the reference quantizes inside a fused jit and rounds a rare
        # code the other way from its numpy quantizer (as in its
        # one-device build, tests/test_torch_host_runtime.py); the port's
        # codes are the numpy quantizer's of the same rows
        np.testing.assert_allclose(ours.row_scales.cpu().numpy(),
                                   np.asarray(ref.row_scales), rtol=2e-7)
        assert np.abs(te - je).max() <= 1 and (te != je).mean() < 2e-3
        from cldrd_tpu.index.flat_index import quantize_rows as jq

        rows = np.zeros_like(te)
        ids_host = ours.row_ids.cpu().numpy()
        ds = TSeq.create_from_seqs_file(path, HashTokenizer(512), 16,
                                        is_query=False)
        by_id = {int(i): r for i, r in zip(*tbuilder.encode_dataset(
            lambda t: torch.from_numpy(emb(t)), ds, 16)[::-1])}
        for j, i in enumerate(ids_host):
            if i >= 0:
                rows[j] = by_id[int(i)]
        codes, _ = jq(rows[ids_host >= 0], xp=np)
        np.testing.assert_array_equal(te[ids_host >= 0], codes)
    else:
        np.testing.assert_allclose(te, je, atol=1e-5, rtol=0)
    q = np.random.default_rng(1).integers(-2, 3, (4, 16)).astype(np.float32)
    ts, ti = ours.search(q, 7)
    js, ji = ref.search(q, 7)
    np.testing.assert_array_equal(ti, ji)


def test_data_parallel_encode_equals_one_device(tmp_path):
    """``make_encode_fn(mesh=)`` + ``encode_dataset``: the same embeddings
    and ids as the one-device encode, flat and bucketed."""
    from cldrd_tpu_torch.models import DistilBertConfig, NwayDualEncoder

    model = NwayDualEncoder(DistilBertConfig.tiny()).reset_parameters(seed=3)
    ds = TSeq.create_from_seqs_file(_collection(tmp_path / "c.tsv"),
                                    HashTokenizer(512), 16, is_query=False)
    one = tbuilder.make_encode_fn(model, "passage_embs")
    dp = tbuilder.make_encode_fn(model, "passage_embs", mesh=_cpu_mesh(4))
    for ladder in (None, ()):
        e1, i1 = tbuilder.encode_dataset(one, ds, 16, bucket_lengths=ladder,
                                         batch_multiple=4)
        e2, i2 = tbuilder.encode_dataset(dp, ds, 16, bucket_lengths=ladder)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(e2, e1, atol=1e-6)
    with pytest.raises(ValueError):
        tbuilder.encode_dataset(dp, ds, 18)


# -------------------------------------------------------------- IVF tier


def _ivf_data(n=2400, d=16, nl=7, seed=0, nq=9):
    rng = np.random.default_rng(seed)
    cents = rng.integers(-12, 13, (nl, d)).astype(np.float32)
    x = cents[rng.integers(0, nl, n)] + rng.integers(-3, 4, (n, d))
    ids = (rng.permutation(n) + 100).astype(np.int64)
    q = rng.integers(-4, 5, (nq, d)).astype(np.float32)
    return x.astype(np.float32), ids, cents, q


_IVF_CASES = {
    "fp32": dict(dtype="float32"), "int8": dict(dtype="int8"),
    "pq8": dict(dtype="float32", pq_m=4, pq_bits=8),
    "opq4": dict(dtype="float32", pq_m=4, pq_bits=4, opq=True)}


@pytest.mark.parametrize("case", sorted(_IVF_CASES))
def test_sharded_ivf_matches_reference(case, tmp_path):
    """The reference's sharded IVF cases on 8 shards, on shared
    centroids: the bucket count pads to the mesh, partial and full probes
    EQUAL the reference's sharded search (values within 1e-5 for the PQ
    tables' sums) and the port's one-device search, pads never persist
    (byte-identical to the reference's directory) and the store reloads
    onto any shard count; add/remove raise."""
    x, ids, cents, q = _ivf_data(seed=len(case))
    kw = dict(_IVF_CASES[case])
    dtype = kw.pop("dtype")
    jdt = {"float32": jnp.float32, "int8": jnp.int8}[dtype]
    tdt = {"float32": torch.float32, "int8": torch.int8}[dtype]
    ref = JIVF.build(x, ids, len(cents), slot=128, dtype=jdt,
                     centroids=cents, mesh=jmake_mesh(8, J_CORPUS), **kw)
    ours = IVFIndex.build(x, ids, len(cents), slot=128, dtype=tdt,
                          centroids=cents, mesh=_cpu_mesh(8), **kw)
    one = IVFIndex.build(x, ids, len(cents), slot=128, dtype=tdt,
                         centroids=cents, device="cpu", **kw)
    assert ours.n_buckets % 8 == 0 and ours.n_buckets == ref.n_buckets
    assert ours.n_real == ref.n_real == one.n_buckets
    np.testing.assert_array_equal(ours._host_ids(), ref._host_ids())
    exact = "pq" not in case
    if not exact:
        # LUT sums differ in order: search both over the reference's codes
        ref.save(str(tmp_path / "jp"))
        ours = IVFIndex.load(str(tmp_path / "jp"), mesh=_cpu_mesh(8))
        one = IVFIndex.load(str(tmp_path / "jp"), device="cpu")
    for nprobe in (3, ours.n_real):
        js, ji = ref.search(q, 30, nprobe=nprobe)
        ts, ti = ours.search(q, 30, nprobe=nprobe)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ti, one.search(q, 30,
                                                     nprobe=nprobe)[1])
        if exact and case != "int8":
            np.testing.assert_array_equal(ts, js)
        else:
            np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    ref.save(str(tmp_path / "j"))
    ours.save(str(tmp_path / "t"))
    meta = json.load(open(tmp_path / "t" / "ivf_meta.json"))
    assert meta["n_buckets"] == ours.n_real
    if exact:
        for name in sorted(os.listdir(tmp_path / "j")):
            assert (tmp_path / "t" / name).read_bytes() == \
                (tmp_path / "j" / name).read_bytes(), name
    back3 = IVFIndex.load(str(tmp_path / "t"), dtype=None if not exact
                          else tdt, mesh=_cpu_mesh(3))
    assert back3.n_buckets % 3 == 0 and back3.n_real == ours.n_real
    np.testing.assert_array_equal(back3.search(q, 30, nprobe=3)[1],
                                  ours.search(q, 30, nprobe=3)[1])
    with pytest.raises(NotImplementedError):
        ours.add(x[:2], np.array([1, 2]))
    with pytest.raises(NotImplementedError):
        ours.remove([int(ids[0])])


# ------------------------------------------------------------------- CLIs


def test_cli_retrieve_shards_and_index_devices(tmp_path, monkeypatch):
    """``index --devices 2`` writes the store of ``--devices 1``;
    ``retrieve --shards 2`` writes the run file of ``--shards 1`` byte for
    byte, and the JAX CLI's ``--shards 2`` run in (qid, pid, rank) with
    scores to 1e-5 (the two encoders differ in the last ulp)."""
    monkeypatch.setattr(jmips, "_INTERPRET", True)
    f = _corpus(tmp_path)
    ckpt = str(tmp_path / "checkpoint_1.pth.tar")
    _checkpoint(ckpt)
    common = ["--checkpoint", ckpt, "--model-size", "tiny",
              "--tokenizer", "hash", "--compute-dtype", "float32"]
    for devices in ("1", "2"):
        assert t_index.main([
            "--collection", f["passages"], "--out",
            str(tmp_path / f"idx{devices}"), "--max-length", "16",
            "--batch-size", "32", "--devices", devices, "--device", "cpu",
            *common]) == 0
    for name in sorted(os.listdir(tmp_path / "idx1")):
        assert (tmp_path / "idx1" / name).read_bytes() == \
            (tmp_path / "idx2" / name).read_bytes(), name
    with pytest.raises(SystemExit):
        t_index.main(["--collection", f["passages"], "--out",
                      str(tmp_path / "bad"), "--batch-size", "33",
                      "--devices", "2", "--device", "cpu", *common])
    runs = {}
    for name, cli, shards, extra in (
            ("t1", t_retrieve, "1", ["--device", "cpu"]),
            ("t2", t_retrieve, "2", ["--device", "cpu"]),
            ("t0", t_retrieve, "0", ["--device", "cpu"]),
            ("j2", j_retrieve, "2", [])):
        runs[name] = str(tmp_path / f"{name}.run.tsv")
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main([
                "--index", str(tmp_path / "idx1"), "--queries",
                f["queries"], "--run", runs[name], "--max-length", "12",
                "--topk", "20", "--hbm-dtype", "float32",
                "--encode-batch-size", "32", "--search-batch-size", "8",
                "--shards", shards, *common, *extra]) == 0
    t1 = open(runs["t1"], "rb").read()
    assert open(runs["t2"], "rb").read() == t1
    assert open(runs["t0"], "rb").read() == t1
    j_rows, j_scores = _run_rows(runs["j2"])
    t_rows, t_scores = _run_rows(runs["t2"])
    assert len(t_rows) == 16 * 20 and t_rows == j_rows
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-5)


_QUERIES = ["find subject3 info", "find subject7 info"]


def test_cli_serve_shards(tmp_path):
    """``serve --shards 2`` in flat, IVF and IVFPQ modes: every answer
    EQUALS the unsharded index's search of the service's own query
    embeddings; live /add is refused with 400 on the sharded store."""
    import threading
    import urllib.error
    import urllib.request

    f = _corpus(tmp_path)
    ckpt = str(tmp_path / "checkpoint_1.pth.tar")
    _checkpoint(ckpt)
    common = ["--collection", f["passages"], "--checkpoint", ckpt,
              "--model-size", "tiny", "--tokenizer", "hash",
              "--max-length", "16", "--batch-size", "32",
              "--compute-dtype", "float32", "--device", "cpu",
              "--ivf-nlist", "5", "--ivf-slot", "128", "--ivf-nprobe", "2"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert t_index.main([*common, "--out", str(tmp_path / "flat")]) == 0
        assert t_index.main([*common, "--out", str(tmp_path / "pq"),
                             "--pq-m", "8"]) == 0
    http = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def post(url, path, payload):
        req = urllib.request.Request(
            url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with http.open(req, timeout=120) as r:
            return json.loads(r.read())

    for store, extra in (("flat", []), ("flat", ["--ivf"]),
                         ("pq", ["--ivf", "--nprobe", "3"])):
        args = t_serve.build_parser().parse_args([
            "--index", str(tmp_path / store), "--port", "0",
            "--checkpoint", ckpt, "--model-size", "tiny", "--tokenizer",
            "hash", "--max-length", "12", "--passage-max-length", "16",
            "--encode-batch-size", "8",
            "--topk", "5", "--device", "cpu", "--hbm-dtype", "float32",
            "--shards", "2", *extra])
        httpd = t_serve.serve(args)
        svc = httpd.RequestHandlerClass.service
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            index = svc.index
            assert index.mesh is not None and index.mesh.size == 2
            got = post(url, "/search", {"queries": _QUERIES})["results"]
            tokens = svc._pad(svc.tokenizer(_QUERIES, svc.max_length),
                              svc.encode_batch)
            embs = svc.encode_fn(tokens)[:2].float().numpy()
            if "--ivf" in extra:
                unsharded = IVFIndex.load(
                    str(tmp_path / store / "ivf"), device="cpu",
                    dtype=None if store == "pq" else torch.float32)
                s, i = unsharded.search(embs, 5, nprobe=index.nprobe)
            else:
                s, i = load_index(str(tmp_path / store),
                                  dtype=torch.float32,
                                  device="cpu").search(embs, 5)
            for r, ranked in enumerate(got):
                valid = i[r] >= 0
                assert [h["id"] for h in ranked] == i[r][valid].tolist()
                assert [h["score"] for h in ranked] == \
                    [float(v) for v in s[r][valid]]
            with pytest.raises(urllib.error.HTTPError) as err:
                post(url, "/add", {"ids": [9100], "texts": ["find emu"]})
            assert err.value.code == 400
        finally:
            svc.close()
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=30)


# --------------------------------------------------------------- training


def _train_kw(tmp_path, **overrides):
    kw = dict(label_mode="1", batch_size=8, num_train_epochs=2,
              learning_rate=1e-4, warmup_steps=1, logging_steps=1,
              evaluate_steps=100, max_query_len=12, max_passage_len=16,
              compute_dtype="float32", seed=0, run_folder=str(tmp_path),
              pack_passages=False)
    kw.update(overrides)
    return kw


# tensors whose gradient is zero in exact arithmetic (test_torch_train.py)
_ZERO_GRAD = ("attention.k_lin.bias",
              "passage_encoder.transformer.layer.1.output_layer_norm.bias")


_MODES = {"flat": {}, "packed": {"pack_passages": True},
          "in_batch": {"in_batch_loss": True, "all_in_batch_neg": True},
          "reg": {"reg_lambda": 0.05}}


def _jax_init_params(run_folder):
    """The tiny model's initial params from the reference's init; its
    Trainer writes its config under ``run_folder``."""
    jt = JaxTrainer(JaxTrainConfig(**_train_kw(run_folder,
                                               experiment_name="init")),
                    JaxConfig.tiny(dropout=0.0, attention_dropout=0.0),
                    mesh=jmake_mesh(2))
    return jax.tree_util.tree_map(np.asarray, jt.init_state(4, seed=0).params)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """One two-rank gloo group runs every data-parallel job in turn: the
    four modes, a run whose last rank gets SIGTERM after step 1, and a
    resume from the checkpoint that run saved."""
    tmp = tmp_path_factory.mktemp("dp")
    port = str(tmp / "port")
    jobs = [(mode, _train_kw(port, experiment_name=mode, n_devices=2, **kw),
             None) for mode, kw in _MODES.items()]
    jobs += [("sigterm", _train_kw(port, experiment_name="sigterm",
                                   learning_rate=1e-3), 1),
             ("resumed", _train_kw(port, experiment_name="resumed",
                                   learning_rate=1e-3, resume=os.path.join(
                                       port, "sigterm",
                                       "checkpoint_1.pth.tar")), None),
             ("straight", _train_kw(port, experiment_name="straight",
                                    learning_rate=1e-3), None)]
    out = tmp / "ranks"
    out.mkdir()
    return port, torch_dp_worker.run_group(
        2, jobs, params_from_flax(_jax_init_params(tmp)), str(out))


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_data_parallel_trainer_matches_reference(tmp_path, mode, dp_runs):
    """Two gloo ranks, each encoding half of every global batch, against
    the reference's SPMD step on a 2-device mesh: in-batch negatives over
    the global batch, the global logits' norm for reg_lambda, global
    grad_norm and MRR. Only rank 0 writes checkpoints."""
    port, runs = dp_runs
    kw = _train_kw(tmp_path, experiment_name=mode, **_MODES[mode])
    jt = JaxTrainer(JaxTrainConfig(**kw),
                    JaxConfig.tiny(dropout=0.0, attention_dropout=0.0),
                    mesh=jmake_mesh(2))
    jm = []
    js = jt.train(torch_dp_worker.tiny_dataset(JaxDataset, JaxTokenizer),
                  init_params=jax.tree_util.tree_map(
                      jnp.asarray, _jax_init_params(tmp_path)),
                  step_hook=lambda s, m: jm.append(m))
    ranks = runs[mode]
    assert [r["world"] for r in ranks] == [2, 2]
    assert ranks[0]["saves"] == [4] and ranks[1]["saves"] == []
    for key in ("loss", "mrr", "recall", "grad_norm", "reg_loss"):
        ref = [float(m[key]) for m in jm]
        for r in ranks:
            got = [m[key] for m in r["metrics"]]
            assert len(got) == 4
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-7,
                                       err_msg=key)
    if mode == "reg":
        assert ranks[0]["metrics"][0]["reg_loss"] > 0
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, js.params))
    for r in ranks:
        diff = sum(float(np.sum((r["params"][k].numpy() - v.numpy()) ** 2))
                   for k, v in ref.items())
        norm = sum(float(np.sum(v.numpy() ** 2)) for v in ref.values())
        assert np.sqrt(diff / norm) < 1e-4
        for k, v in ref.items():
            atol = kw["learning_rate"] * (4 if k.endswith(_ZERO_GRAD)
                                          else 0.1)
            np.testing.assert_allclose(r["params"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=atol, err_msg=k)
    ckpts = sorted(os.listdir(os.path.join(port, mode)))
    assert [c for c in ckpts if c.startswith("checkpoint_")] == \
        ["checkpoint_4.pth.tar"]


def test_data_parallel_sigterm_and_resume(dp_runs):
    """SIGTERM to one rank stops every rank at the same step boundary
    (the flag is reduced over the group) and rank 0 saves; both ranks
    resume from that checkpoint and end with the uninterrupted run's
    params, bit for bit."""
    port, runs = dp_runs
    stopped = runs["sigterm"]
    assert [r["step"] for r in stopped] == [1, 1]
    assert stopped[0]["saves"] == [1] and stopped[1]["saves"] == []
    assert os.path.exists(os.path.join(port, "sigterm",
                                       "checkpoint_1.pth.tar"))
    resumed, straight = runs["resumed"], runs["straight"]
    assert [r["step"] for r in resumed] == [4, 4]
    assert [len(r["metrics"]) for r in resumed] == [3, 3]
    for r in range(2):
        for k, v in straight[r]["params"].items():
            assert torch.equal(resumed[r]["params"][k], v), k
        assert torch.equal(resumed[r]["params"][k],
                           resumed[1 - r]["params"][k])


def test_curriculum_evaluates_on_rank0_under_a_group(tmp_path):
    """cli.curriculum on two gloo ranks joined through torchrun's
    variables: rank 0 alone evaluates each iteration while rank 1 waits
    at a host-side barrier, here longer than the default group's timeout
    (as a full-corpus evaluation outlasts NCCL's). The evaluation table
    equals a one-process run's."""
    from cldrd_tpu_torch.cli import curriculum as t_curriculum

    paths = _write_corpus(tmp_path, np.random.default_rng(4))

    def argv(runs):
        return ["--queries", paths["q"], "--passages", paths["c"],
                "--training-paths", str(tmp_path / "it8.jsonl"),
                str(tmp_path / "it9.jsonl"), "--label-modes", "8", "9",
                "--epochs", "1", "1",
                "--learning-rates", "1e-4", "1e-4", "--batch-size", "8",
                "--run-folder", str(runs), "--eval-queries", paths["q"],
                "--eval-qrels", paths["qrels"], "--eval-topk", "10",
                "--model-size", "tiny", "--device", "cpu", "--config",
                str(tmp_path / "base.yaml")]

    out = tmp_path / "ranks"
    out.mkdir()
    ranks = torch_dp_worker.run_curriculum(
        2, argv(tmp_path / "dp") + ["--n-devices", "2"],
        group_timeout_s=6, eval_delay_s=9, out_dir=str(out))
    assert ranks == [{"rc": 0, "evaluations": 2, "world": 2},
                     {"rc": 0, "evaluations": 0, "world": 2}]
    assert t_curriculum.main(argv(tmp_path / "one")) == 0
    table = (tmp_path / "dp" / "curriculum_eval.tsv").read_text()
    assert len(table.splitlines()) == 3
    assert table == (tmp_path / "one" / "curriculum_eval.tsv").read_text()


# -------------------------------------------------------------- multihost


@pytest.fixture
def _clean_env(monkeypatch):
    for v, _ in multihost._CLUSTER_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    for v in ("RANK", "LOCAL_RANK", "OMPI_COMM_WORLD_RANK", "SLURM_PROCID",
              "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)


def test_cluster_configured_detection(_clean_env, monkeypatch):
    assert not multihost._cluster_configured()
    monkeypatch.setenv("SLURM_NTASKS", "1")      # an ordinary one-task job
    assert not multihost._cluster_configured()
    monkeypatch.setenv("SLURM_NTASKS", "4")
    assert multihost._cluster_configured()
    monkeypatch.delenv("SLURM_NTASKS")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "1")
    assert not multihost._cluster_configured()
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
    assert multihost._cluster_configured()
    monkeypatch.delenv("OMPI_COMM_WORLD_SIZE")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not multihost._cluster_configured()
    monkeypatch.setenv("MASTER_ADDR", "host")    # torchrun's rendezvous
    assert multihost._cluster_configured()


def test_initialize_joins_the_configured_group(_clean_env, monkeypatch):
    calls = []
    monkeypatch.setattr(multihost, "_already_initialized", lambda: False)
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(multihost.dist, "get_rank", lambda: 1)
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda: 2)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    multihost.initialize_multihost(backend="gloo")
    assert calls == [(("gloo",), {"init_method": "env://", "world_size": 2,
                                  "rank": 1})]
    calls.clear()
    multihost.initialize_multihost(coordinator_address="h:1234",
                                   num_processes=4, process_id=3,
                                   backend="gloo")
    assert calls[0][1] == {"init_method": "tcp://h:1234", "world_size": 4,
                           "rank": 3}


def test_already_initialized_is_a_no_op(_clean_env, monkeypatch):
    monkeypatch.setattr(multihost, "_already_initialized", lambda: True)

    def boom(*a, **k):
        raise AssertionError("init called twice")

    monkeypatch.setattr(multihost.dist, "init_process_group", boom)
    multihost.initialize_multihost()


def test_configured_but_failing_init_raises(_clean_env, monkeypatch):
    monkeypatch.setattr(multihost, "_already_initialized", lambda: False)

    def failing(*a, **kw):
        raise ValueError("rendezvous unreachable")

    monkeypatch.setattr(multihost.dist, "init_process_group", failing)
    with pytest.raises(RuntimeError, match="refusing to silently fall back"):
        multihost.initialize_multihost(coordinator_address="h:1234",
                                       num_processes=2, process_id=0)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "h")
    with pytest.raises(RuntimeError, match="refusing to silently fall back"):
        multihost.initialize_multihost(backend="gloo")


def test_unconfigured_launch_stays_single_process(_clean_env, monkeypatch):
    monkeypatch.setattr(multihost, "_already_initialized", lambda: False)

    def never(*a, **kw):
        raise AssertionError("no group was configured")

    monkeypatch.setattr(multihost.dist, "init_process_group", never)
    multihost.initialize_multihost()   # no raise, no group


def test_host_shard_single_process(_clean_env):
    assert multihost.host_shard() == (-1, None)
    assert multihost.is_first_host()
    assert multihost.world() == (0, 1)
    assert multihost.local_device("cpu") == torch.device("cpu")
