"""The port's host runtime held to cldrd_tpu on the CPU: length buckets,
the token cache, bucketed and cached encodes, the on-device index build,
bucketed reranking batches, the CLIs that take them, the WordPiece
trainer, and ``FlatIPIndex.reconstruct`` / ``range_search``.

Inputs are seeded with numpy; the model is the tiny DistilBERT in fp32
and the tokenizer the hash tokenizer unless a test says otherwise. The
JAX side's extract kernel runs in Pallas interpret mode. Tolerances:
bucketing, caches, batches and stores built from exact embeddings are
EQUAL (the reference's jitted on-device int8 quantizer aside: see its
test); fp32 embeddings from the tiny encoder within 1e-6 of their
largest magnitude; run-file scores within rtol 1e-5 (they print as
float reprs) with equal (qid, pid, rank); metric dicts equal; teacher
scores within 1e-5 and rerank metrics within rtol 1e-6 of JAX's.
"""
import contextlib
import io
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from cldrd_tpu.data import bucketing as jb
from cldrd_tpu.data import token_cache as jtc
from cldrd_tpu.data.reranking_dataset import RerankingDataset as JRerankDS
from cldrd_tpu.data.sequence_dataset import SequenceBatch as JBatch
from cldrd_tpu.data.sequence_dataset import SequenceDataset as JSeq
from cldrd_tpu.data.tokenization import HashTokenizer as JTok
from cldrd_tpu.index import builder as jbuilder
from cldrd_tpu.index.flat_index import FlatIPIndex as JIndex
from cldrd_tpu.index.flat_index import quantize_rows as j_quantize_rows
from cldrd_tpu.models import CrossEncoder as JCrossEncoder
from cldrd_tpu.models import DistilBertConfig as JConfig
from cldrd_tpu.models import NwayDualEncoder as JDual
from cldrd_tpu.models.hf_loader import dual_encoder_flax_to_torch
from cldrd_tpu.search import mips as jmips
from cldrd_tpu_torch.data import bucketing as tb
from cldrd_tpu_torch.data import token_cache as ttc
from cldrd_tpu_torch.data.reranking_dataset import RerankingDataset
from cldrd_tpu_torch.data.sequence_dataset import SequenceBatch, SequenceDataset
from cldrd_tpu_torch.data.tokenization import HashTokenizer
from cldrd_tpu_torch.index import builder as tbuilder
from cldrd_tpu_torch.index.flat_index import FlatIPIndex
from cldrd_tpu_torch.models import DistilBertConfig, NwayDualEncoder
from cldrd_tpu_torch.models.convert import params_from_flax

VOCAB = 512


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # the JAX side takes its extract route (interpret mode), as the port
    monkeypatch.setattr(jmips, "_INTERPRET", True)


def _write_collection(path, rng, n=70, max_words=40):
    """Passages of 1-``max_words`` words (some longer than the tests'
    max_length of 32, so truncation is exercised) and one titled row."""
    words = [f"w{i}" for i in range(200)]
    with open(path, "w") as f:
        for pid in range(n):
            text = " ".join(rng.choice(words, int(rng.integers(1,
                                                               max_words))))
            if pid == 5:
                text = f"a title\t{text}"
            f.write(f"{pid * 3 + 1}\t{text}\n")
    return str(path)


def _spec_pairs(specs):
    return [(s.length, s.batch_size) for s in specs]


def _assert_seq_batches_equal(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert a.n_valid == b.n_valid
        np.testing.assert_array_equal(a.ids, b.ids)
        assert a.tokens.keys() == b.tokens.keys()
        for key in a.tokens:
            assert a.tokens[key].dtype == b.tokens[key].dtype
            np.testing.assert_array_equal(a.tokens[key], b.tokens[key])


# ------------------------------------------------------------- bucketing

# (max_length, batch_size, bucket lengths, batch_multiple, longest row)
_LADDERS = {
    "default": (64, 16, None, 1, 64),
    "100_256_multiple8": (256, 32, (100, 256), 8, 256),
    "4_8_16": (16, 8, (4, 8, 16), 1, 16),
    "oversized_rows": (16, 8, (4, 8), 1, 24),
}


def _raw_batches(rng, n_rows, width, bz):
    """(ids, tokens, mask, n_valid) batches of width ``width``: masks
    mostly contiguous, some with holes, one row all padding."""
    lens = rng.integers(0, width + 1, n_rows)
    mask = (np.arange(width)[None] < lens[:, None]).astype(np.int32)
    holes = rng.random((n_rows, width)) < 0.2
    mask[::5] &= ~holes[::5]
    mask[3] = 0
    tokens = rng.integers(1, VOCAB, (n_rows, width)).astype(np.int32) * mask
    ids = np.arange(n_rows, dtype=np.int64) * 7 + 2
    out = []
    for start in range(0, n_rows, bz):
        nv = min(bz, n_rows - start)
        t = np.zeros((bz, width), np.int32)
        m = np.zeros((bz, width), np.int32)
        i = np.full((bz,), -1, np.int64)
        t[:nv], m[:nv], i[:nv] = (tokens[start:start + nv],
                                  mask[start:start + nv],
                                  ids[start:start + nv])
        out.append((i, t, m, nv))
    return out


@pytest.mark.parametrize("case", list(_LADDERS))
def test_bucketing_matches_reference(case):
    max_len, bz, lengths, multiple, width = _LADDERS[case]
    ts = tb.bucket_specs(max_len, bz, lengths, multiple)
    js = jb.bucket_specs(max_len, bz, lengths, multiple)
    assert _spec_pairs(ts) == _spec_pairs(js)
    assert tb.default_bucket_lengths(max_len) == \
        jb.default_bucket_lengths(max_len)
    rng = np.random.default_rng(len(case))
    raw = _raw_batches(rng, 5 * bz + 3, width, bz)
    for _, _, m, _ in raw:
        np.testing.assert_array_equal(tb.required_lengths(m),
                                      jb.required_lengths(m))
    assert tb.max_emitted_rows(77, ts) == jb.max_emitted_rows(77, js)

    def stream(cls):
        return [cls(tokens={"input_ids": t, "attention_mask": m}, ids=i,
                    n_valid=nv) for i, t, m, nv in raw]

    if width > max_len:
        for mod, specs, cls in ((tb, ts, SequenceBatch), (jb, js, JBatch)):
            with pytest.raises(ValueError, match="exceeds largest bucket"):
                list(mod.bucketize(stream(cls), specs))
        return
    ours = list(tb.bucketize(stream(SequenceBatch), ts))
    _assert_seq_batches_equal(ours, jb.bucketize(stream(JBatch), js))
    # every valid row once, each batch at its bucket's shape
    got = np.concatenate([b.ids[:b.n_valid] for b in ours])
    want = np.concatenate([i[:nv] for i, _, _, nv in raw])
    assert sorted(got.tolist()) == sorted(want.tolist())
    shapes = {(s.batch_size, s.length) for s in ts}
    assert all(b.tokens["input_ids"].shape in shapes for b in ours)


# ------------------------------------------------------------ token cache


def _seq(pkg, path, max_length=32):
    if pkg == "torch":
        return SequenceDataset.create_from_seqs_file(
            path, HashTokenizer(VOCAB), max_length, is_query=False)
    return JSeq.create_from_seqs_file(path, JTok(VOCAB), max_length,
                                      is_query=False)


def test_token_cache_files_identical_and_read_across(tmp_path):
    path = _write_collection(tmp_path / "c.tsv", np.random.default_rng(1))
    ttc.write_token_cache(_seq("torch", path), str(tmp_path / "t"),
                          batch_size=16)
    jtc.write_token_cache(_seq("jax", path), str(tmp_path / "j"),
                          batch_size=16)
    names = (ttc.META_NAME, ttc.IDS_NAME, ttc.TOKENS_NAME, ttc.LENGTHS_NAME)
    assert names == (jtc.META_NAME, jtc.IDS_NAME, jtc.TOKENS_NAME,
                     jtc.LENGTHS_NAME)
    for name in names:
        a = (tmp_path / "t" / name).read_bytes()
        assert a and a == (tmp_path / "j" / name).read_bytes(), name
    assert ttc.token_cache_exists(str(tmp_path / "j"))
    # each package reads the cache the other wrote: the same batches,
    # flat and bucketed
    ours = ttc.TokenCacheDataset(str(tmp_path / "j"))
    ref = jtc.TokenCacheDataset(str(tmp_path / "t"))
    assert len(ours) == len(ref) == 70
    _assert_seq_batches_equal(ours.batches(16), ref.batches(16))
    specs = tb.bucket_specs(32, 8, (8, 16))
    _assert_seq_batches_equal(ours.batches_bucketed(specs),
                              ref.batches_bucketed(
                                  jb.bucket_specs(32, 8, (8, 16))))
    # the cache's flat batches are the tokenizer's
    _assert_seq_batches_equal(ours.batches(16),
                              _seq("torch", path).batches(16))


class _OneBatch:
    """A dataset of one batch (for the cache's input checks)."""

    def __init__(self, cls, ids, mask):
        self.max_length = ids.shape[1]
        self._batch = cls(tokens={"input_ids": ids, "attention_mask": mask},
                          ids=np.arange(len(ids), dtype=np.int64),
                          n_valid=len(ids))

    def __len__(self):
        return self._batch.n_valid

    def batches(self, batch_size):
        yield self._batch


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_token_cache_input_errors(tmp_path, pkg):
    mod, cls = (ttc, SequenceBatch) if pkg == "torch" else (jtc, JBatch)
    mask = np.ones((2, 4), np.int32)
    big = np.full((2, 4), 70_000, np.int32)
    with pytest.raises(ValueError, match="uint16"):
        mod.write_token_cache(_OneBatch(cls, big, mask), str(tmp_path / "a"))
    holed = mask.copy()
    holed[0, 1] = 0
    with pytest.raises(ValueError, match="non-contiguous"):
        mod.write_token_cache(_OneBatch(cls, np.ones((2, 4), np.int32),
                                        holed), str(tmp_path / "b"))


# ----------------------------------------------------------------- encode


def _reference_compact():
    """The reference's ``_compact_tokens``, a closure inside its
    ``make_encode_fn`` (nothing is traced until the function is called)."""
    stub = types.SimpleNamespace(passage_embs=None)
    fn = jbuilder.make_encode_fn(stub, None, "passage_embs")
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    return cells["_compact_tokens"]


@pytest.mark.parametrize("ids", ["in_range", "high_ids", "over_uint16",
                                 "negative"])
def test_compact_tokens_matches_reference(ids):
    rng = np.random.default_rng(2)
    top = {"in_range": 30_522, "high_ids": 65_536, "over_uint16": 70_000,
           "negative": 100}[ids]
    tokens = {"input_ids": rng.integers(0, top, (4, 8)).astype(np.int32),
              "attention_mask": (rng.random((4, 8)) < 0.7).astype(np.int32)}
    tokens["input_ids"][0, 0] = top - 1
    if ids == "negative":
        tokens["input_ids"][1, 1] = -1
    ours = tbuilder.compact_tokens(tokens)
    ref = _reference_compact()(tokens)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(ours[key], ref[key])
        # widened back on the device: the same values as the input
        np.testing.assert_array_equal(
            tbuilder._to_device(ours[key], torch.device("cpu")).numpy(),
            tokens[key])


@pytest.fixture(scope="module")
def encoders():
    """The tiny dual encoder in fp32 in both packages, same weights."""
    jm = JDual(config=JConfig.tiny(), dtype=jnp.float32)
    ids = jnp.ones((1, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(5),
                     {"input_ids": ids, "attention_mask": ids},
                     {"input_ids": ids[:, None],
                      "attention_mask": ids[:, None]})["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = NwayDualEncoder(DistilBertConfig.tiny())
    tm.load_state_dict(params_from_flax(params))
    return (jbuilder.make_encode_fn(jm, params, "passage_embs"),
            tbuilder.make_encode_fn(tm, "passage_embs"), params)


def _by_id(embs, ids):
    order = np.argsort(ids)
    return embs[order], ids[order]


@pytest.mark.parametrize("source", ["greedy", "cache"])
def test_bucketed_encode_matches_reference(tmp_path, encoders, source):
    """Bucketed encodes (``bucketize`` over the tokenizer's batches, or
    the cache's sorted buckets) give per-id embeddings within 1e-6 of the
    largest magnitude of JAX's FLAT encode, in the id order of JAX's
    bucketed encode."""
    jenc, tenc, _ = encoders
    path = _write_collection(tmp_path / "c.tsv", np.random.default_rng(3))
    if source == "cache":
        ttc.write_token_cache(_seq("torch", path), str(tmp_path / "t"))
        jtc.write_token_cache(_seq("jax", path), str(tmp_path / "j"))
        ours = ttc.TokenCacheDataset(str(tmp_path / "t"))
        ref = jtc.TokenCacheDataset(str(tmp_path / "j"))
    else:
        ours, ref = _seq("torch", path), _seq("jax", path)
    j_flat, j_flat_ids = jbuilder.encode_dataset(jenc, _seq("jax", path), 16)
    for ladder in ((8, 16), ()):
        j_b, j_ids = jbuilder.encode_dataset(jenc, ref, 16,
                                             bucket_lengths=ladder)
        t_b, t_ids = tbuilder.encode_dataset(tenc, ours, 16,
                                             bucket_lengths=ladder,
                                             prefetch_depth=2)
        np.testing.assert_array_equal(t_ids, j_ids)
        if ladder:  # max_length 32's default ladder is one bucket
            assert not np.array_equal(t_ids, j_flat_ids)  # regrouped
        got, gid = _by_id(t_b, t_ids)
        want, wid = _by_id(j_flat, j_flat_ids)
        np.testing.assert_array_equal(gid, wid)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-6 * scale


# ------------------------------------------------------- on-device build

_D = 16


def _exact_encoders():
    """A toy passage encoder computed the same way in numpy, JAX and
    torch: the sum over real tokens of a small-integer row per token id.
    Every value is an exact integer, so stores built from it must be
    EQUAL across packages (all-masked rows encode to zeros)."""
    w = np.random.default_rng(7).integers(-3, 4, (VOCAB, _D)).astype(
        np.float32)

    def emb(tokens):
        m = np.asarray(tokens["attention_mask"]).astype(np.float32)
        ids = np.asarray(tokens["input_ids"]).astype(np.int64)
        return (w[ids] * m[..., None]).sum(1)

    return (lambda t: jnp.asarray(emb(t)),
            lambda t: torch.from_numpy(emb(t)))


_STORE = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _store_arrays(index):
    emb = np.asarray(index.embeddings.float() if isinstance(
        index.embeddings, torch.Tensor) else index.embeddings.astype(
        jnp.float32))
    scales = (None if index.row_scales is None
              else np.asarray(index.row_scales))
    return emb, np.asarray(index.row_ids), scales


def _assert_same_index(ours, ref, queries, k, rows=None):
    """Stores (the first ``rows`` rows) and exact searches EQUAL."""
    a, b = _store_arrays(ours), _store_arrays(ref)
    for x, y in zip(a, b):
        if y is None:
            assert x is None
        else:
            np.testing.assert_array_equal(x[:rows], y[:rows])
    ts, ti = ours.search(queries, k)
    js, ji = ref.search(jnp.asarray(queries), k)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_array_equal(ts, np.asarray(js))


@pytest.mark.parametrize("store", list(_STORE))
@pytest.mark.parametrize("ladder", [None, (8, 16)])
def test_build_index_on_device_matches_reference(tmp_path, store, ladder):
    jenc, tenc = _exact_encoders()
    path = _write_collection(tmp_path / "c.tsv", np.random.default_rng(4))
    jdt, tdt = _STORE[store]
    kw = dict(block_rows=64, bucket_lengths=ladder)
    ours = tbuilder.build_index_on_device(tenc, _seq("torch", path), 16, _D,
                                          dtype=tdt, device="cpu", **kw)
    ref = jbuilder.build_index_on_device(jenc, _seq("jax", path), 16, _D,
                                         dtype=jdt, **kw)
    queries = np.random.default_rng(5).integers(-2, 3, (5, _D)).astype(
        np.float32)
    if store != "int8":
        _assert_same_index(ours, ref, queries, 10)
    else:
        # the reference's on-device quantizer runs inside a jitted,
        # fused program, which rounds a rare code the other way from its
        # numpy quantizer (the same per-row arithmetic as the port's):
        # the stores agree in ids, in scales within an ulp and in codes
        # but for ties at one step; the port equals the reference's numpy
        # quantization of the same rows exactly
        (te, ti, tsc), (je, ji, jsc) = (_store_arrays(ours),
                                        _store_arrays(ref))
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tsc, jsc, rtol=2e-7)
        assert np.abs(te - je).max() <= 1 and (te != je).mean() < 1e-3
        embs, eids = jbuilder.encode_dataset(jenc, _seq("jax", path), 16,
                                             bucket_lengths=ladder)
        _assert_same_index(ours, JIndex.build_quantized(
            *j_quantize_rows(embs), eids, block_rows=64), queries, 10,
            rows=70)
    # rows past the last write: id -1, code 0 and (int8) scale 1
    emb, ids, scales = _store_arrays(ours)
    assert (ids >= 0).sum() == 70
    if scales is not None:
        assert np.isfinite(scales).all()
    # the host-built store from the same batch stream holds the same rows
    embs, eids = tbuilder.encode_dataset(tenc, _seq("torch", path), 16,
                                         bucket_lengths=ladder)
    host = FlatIPIndex.build(embs, eids, dtype=tdt, block_rows=64,
                             device="cpu")
    he, hi, hs = _store_arrays(host)
    np.testing.assert_array_equal(hi[:70], ids[:70])
    np.testing.assert_array_equal(he[:70], emb[:70])
    if hs is not None:
        np.testing.assert_array_equal(hs[:70], scales[:70])
    np.testing.assert_array_equal(host.search(queries, 10)[1],
                                  ours.search(queries, 10)[1])


def test_build_index_from_dataset_matches_reference(tmp_path):
    jenc, tenc = _exact_encoders()
    path = _write_collection(tmp_path / "c.tsv", np.random.default_rng(6))
    ours = tbuilder.build_index_from_dataset(
        tenc, _seq("torch", path), 16, out_dir=str(tmp_path / "t"),
        dtype=torch.float32, block_rows=64, device="cpu")
    ref = jbuilder.build_index_from_dataset(
        jenc, _seq("jax", path), 16, out_dir=str(tmp_path / "j"),
        dtype=jnp.float32, block_rows=64)
    queries = np.random.default_rng(7).integers(-2, 3, (3, _D)).astype(
        np.float32)
    _assert_same_index(ours, ref, queries, 7)
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def test_sharded_build_is_refused(tmp_path):
    """A sharded build needs an encode over the same mesh (its parts are
    the shards' rows); a one-device encode is refused."""
    from cldrd_tpu_torch.parallel import CORPUS_AXIS, make_mesh

    _, tenc = _exact_encoders()
    path = _write_collection(tmp_path / "c.tsv", np.random.default_rng(8))
    with pytest.raises(ValueError, match="same mesh"):
        tbuilder.build_index_on_device(
            tenc, _seq("torch", path), 16, _D,
            mesh=make_mesh(2, CORPUS_AXIS, "cpu"))


# ------------------------------------------------------------- reranking


@pytest.mark.parametrize("mode", ["cross", "cross_types", "dual"])
@pytest.mark.parametrize("ladder,multiple", [((8, 12), 1), (None, 4)])
def test_reranking_batches_bucketed_match_reference(mode, ladder, multiple):
    rng = np.random.default_rng(9)
    words = [f"w{i}" for i in range(60)]
    queries = {q: " ".join(rng.choice(words, int(rng.integers(1, 6))))
               for q in range(6)}
    passages = {p: " ".join(rng.choice(words, int(rng.integers(1, 20))))
                for p in range(50)}
    passages[7] = {"title": "t", "para": "p q r"}
    pairs = [(q, int(p)) for q in range(6)
             for p in rng.choice(50, 9, replace=False)]
    kw = dict(is_cross_encoder=mode != "dual", max_len=24, query_max_len=8,
              passage_max_len=16, with_token_type_ids=mode == "cross_types")
    ours = RerankingDataset.from_pairs(pairs, queries, passages,
                                       HashTokenizer(VOCAB), **kw)
    ref = JRerankDS.from_pairs(pairs, queries, passages, JTok(VOCAB), **kw)
    a = list(ours.batches_bucketed(8, ladder, multiple))
    b = list(ref.batches_bucketed(8, ladder, multiple))
    assert len(a) == len(b) > 1
    assert sum(x.n_valid for x in a) == len(pairs)
    for x, y in zip(a, b):
        assert x.n_valid == y.n_valid
        np.testing.assert_array_equal(x.qids, y.qids)
        np.testing.assert_array_equal(x.pids, y.pids)
        for field in ("query_passage", "query", "passage"):
            u, v = getattr(x, field), getattr(y, field)
            assert (u is None) == (v is None)
            if u is not None:
                assert list(u) == list(v)  # token_type_ids last
                for key in u:
                    assert u[key].dtype == v[key].dtype
                    np.testing.assert_array_equal(u[key], v[key])


# ------------------------------------------------------------------ CLIs


def _cli_out(main, argv):
    """A CLI's last printed JSON object (its log lines share stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    lines = buf.getvalue().splitlines()
    starts = [i for i, line in enumerate(lines) if line.startswith("{")]
    return json.loads("\n".join(lines[starts[-1]:])) if starts else None


def _cli_corpus(tmp):
    """16 queries; each query's relevant passage shares its wording, its
    noise passages have 2-30 words (so the buckets differ)."""
    rng = np.random.default_rng(10)
    queries, passages, qrels, cands = [], [], [], []
    pid = 0
    for q in range(16):
        queries.append(f"{q}\tfind subject{q} info\n")
        rel = pid
        passages.append(f"{pid}\tdocument with subject{q} info inside\n")
        pid += 1
        for _ in range(5):
            n = int(rng.integers(2, 30))
            passages.append(f"{pid}\t" + " ".join(
                f"noise{rng.integers(10**6)}" for _ in range(n)) + "\n")
            pid += 1
        qrels.append(f"{q}\t0\t{rel}\t{1 + q % 3}\n")
    for q in range(4):
        pids = [q * 6] + [p for p in rng.permutation(96).tolist()
                          if p != q * 6][:31]
        for rank, p in enumerate(rng.permutation(pids), start=1):
            cands.append(f"{q}\t{p}\t{rank}\t{1.0 / rank:.4f}\n")
    paths = {name: str(tmp / f"{name}.tsv")
             for name in ("queries", "passages", "qrels", "cands")}
    for name, lines in (("queries", queries), ("passages", passages),
                        ("qrels", qrels), ("cands", cands)):
        with open(paths[name], "w") as f:
            f.write("".join(lines))
    return paths


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host_runtime_cli")
    f = _cli_corpus(tmp)
    dual = JDual(config=JConfig.tiny())
    ids = jnp.ones((1, 8), jnp.int32)
    params = dual.init(jax.random.PRNGKey(11),
                       {"input_ids": ids, "attention_mask": ids},
                       {"input_ids": ids[:, None],
                        "attention_mask": ids[:, None]})["params"]
    sd = dual_encoder_flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                           params))
    f["dual"] = str(tmp / "checkpoint_1.pth.tar")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, f["dual"])
    cross = JCrossEncoder(config=JConfig.tiny(), arch="distilbert",
                          dtype=jnp.float32)
    cparams = cross.init(jax.random.PRNGKey(12), {
        "input_ids": jnp.zeros((1, 8), jnp.int32),
        "attention_mask": jnp.ones((1, 8), jnp.int32)})["params"]
    f["teacher"] = str(tmp / "teacher.msgpack")
    with open(f["teacher"], "wb") as fh:
        fh.write(serialization.msgpack_serialize({"params": cparams}))
    return f


def _run_rows(path):
    rows = [line.split("\t") for line in open(path).read().splitlines()]
    return ([(int(q), int(p), int(r)) for q, p, r, _ in rows],
            np.array([float(s) for *_, s in rows]))


def test_cli_index_buckets_and_cache_match_reference(cli_files, tmp_path):
    """index --bucket-lengths --token-cache -> retrieve -> evaluate
    through both packages' CLIs: the port's second index call reads the
    cache its first wrote; run files and metrics agree."""
    from cldrd_tpu.cli import evaluate as j_evaluate
    from cldrd_tpu.cli import index as j_index
    from cldrd_tpu.cli import retrieve as j_retrieve
    from cldrd_tpu_torch.cli import evaluate as t_evaluate
    from cldrd_tpu_torch.cli import index as t_index
    from cldrd_tpu_torch.cli import retrieve as t_retrieve

    f = cli_files
    common = ["--checkpoint", f["dual"], "--model-size", "tiny",
              "--tokenizer", "hash", "--compute-dtype", "float32"]
    out = {}
    for name, index_cli, retrieve_cli, evaluate_cli, extra in (
            ("jax", j_index, j_retrieve, j_evaluate, []),
            ("torch", t_index, t_retrieve, t_evaluate, ["--device", "cpu"])):
        idx = str(tmp_path / f"index_{name}")
        argv = ["--collection", f["passages"], "--out", idx,
                "--max-length", "32", "--batch-size", "16",
                "--bucket-lengths", "8", "16", "--token-cache",
                str(tmp_path / f"cache_{name}"), *common, *extra]
        stats = _cli_out(index_cli.main, argv)
        if name == "torch":
            assert "token_cache_write_s" in stats
            again = _cli_out(index_cli.main, argv)  # reads the cache
            assert "token_cache_write_s" not in again
            assert again["passages"] == stats["passages"] == 96
        run = str(tmp_path / f"{name}.run.tsv")
        _cli_out(retrieve_cli.main, [
            "--index", idx, "--queries", f["queries"], "--run", run,
            "--max-length", "12", "--topk", "20", "--hbm-dtype", "float32",
            "--encode-batch-size", "32", "--search-batch-size", "8",
            *common, *extra])
        out[name] = (_run_rows(run), _cli_out(evaluate_cli.main, [
            "--qrels", f["qrels"], "--run", run]))
    (j_rows, j_scores), j_metrics = out["jax"]
    (t_rows, t_scores), t_metrics = out["torch"]
    assert len(t_rows) == 16 * 20 and t_rows == j_rows
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-5)
    assert t_metrics == j_metrics


def _teacher_argv(f):
    return ["--candidates-run", f["cands"], "--queries", f["queries"],
            "--passages", f["passages"], "--teacher-checkpoint",
            f["teacher"], "--teacher-arch", "distilbert", "--model-size",
            "tiny", "--max-length", "32", "--batch-size", "16",
            "--compute-dtype", "float32"]


def _jsonl(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


def test_cli_create_training_data_buckets_match_reference(cli_files,
                                                          tmp_path):
    """--bucket-lengths: the curriculum files of the port's bucketed run
    equal its flat run's in qids and pids, scores within 1e-6 of the
    largest (fp32: buckets change no arithmetic that matters), and JAX's
    bucketed run's within 1e-5, the same pids where no two scores of a
    query are within 1e-4."""
    from cldrd_tpu.cli import create_training_data as j_ctd
    from cldrd_tpu_torch.cli import create_training_data as t_ctd

    argv = _teacher_argv(cli_files)
    buckets = ["--bucket-lengths", "8", "16"]
    runs = {
        "t_flat": (t_ctd.main, ["--device", "cpu"]),
        "t_buck": (t_ctd.main, ["--device", "cpu", *buckets]),
        "j_buck": (j_ctd.main, buckets)}
    files = {name: _cli_out(main, [*argv, *extra, "--out-prefix",
                                   str(tmp_path / f"{name}_")])
             for name, (main, extra) in runs.items()}
    assert files["t_buck"].keys() == files["j_buck"].keys()
    for stage in files["j_buck"]:
        rows = {name: _jsonl(p[stage]) for name, p in files.items()}
        assert [r["qid"] for r in rows["t_buck"]] == \
            [r["qid"] for r in rows["j_buck"]] == \
            [r["qid"] for r in rows["t_flat"]] == [0, 1, 2, 3]
        for a, b, c in zip(rows["t_buck"], rows["j_buck"], rows["t_flat"]):
            keys = ("relT", "most_hard", "semi_hard")
            sa = sum((a[f"{k}_scores"] for k in keys), [])
            sb = sum((b[f"{k}_scores"] for k in keys), [])
            sc = sum((c[f"{k}_scores"] for k in keys), [])
            scale = max(abs(x) for x in sb)
            assert np.abs(np.subtract(sa, sb)).max() <= 1e-5 * scale
            assert np.abs(np.subtract(sa, sc)).max() <= 1e-6 * scale
            if min(np.diff(sorted(sb)), default=1.0) > 1e-4:
                for k in keys:
                    assert a[f"{k}_pids"] == b[f"{k}_pids"] == c[f"{k}_pids"]


@pytest.mark.parametrize("mode", ["dual", "cross"])
def test_cli_rerank_eval_buckets_match_reference(cli_files, mode):
    from cldrd_tpu.cli import rerank_eval as j_re
    from cldrd_tpu_torch.cli import rerank_eval as t_re

    f = cli_files
    argv = ["--candidates-run", f["cands"], "--queries", f["queries"],
            "--passages", f["passages"], "--qrels", f["qrels"],
            "--mode", mode, "--model-size", "tiny", "--batch-size", "16",
            "--compute-dtype", "float32", "--max-length", "32",
            "--max-query-len", "12", "--max-passage-len", "32",
            "--checkpoint", f["teacher"] if mode == "cross" else f["dual"]]
    buckets = ["--bucket-lengths", "8", "16"]
    ours = _cli_out(t_re.main, [*argv, *buckets, "--device", "cpu"])
    ref = _cli_out(j_re.main, [*argv, *buckets])
    assert ours.keys() == ref.keys()
    for key, value in ref.items():
        np.testing.assert_allclose(ours[key], value, rtol=1e-6,
                                   err_msg=key)
    assert _cli_out(t_re.main, [*argv, "--device", "cpu"]) == ours


_TINY_NO_DROPOUT = dict(vocab_size=512, max_position_embeddings=64, dim=32,
                        n_layers=2, n_heads=4, hidden_dim=64, dropout=0.0,
                        attention_dropout=0.0)


def test_cli_curriculum_eval_buckets_match_reference(cli_files, tmp_path):
    """cli.curriculum with --eval-bucket-lengths (the default ladder) in
    both packages from the same warm start, fp32, dropout 0: the
    per-iteration curriculum_eval.tsv agrees within 1e-6."""
    from cldrd_tpu.cli import curriculum as j_cur
    from cldrd_tpu_torch.cli import curriculum as t_cur

    f = cli_files
    rng = np.random.default_rng(13)
    paths = []
    for mode, (r, n) in {"8": (5, 25), "9": (10, 20)}.items():
        path = tmp_path / f"it{mode}.jsonl"
        with open(path, "w") as fh:
            for q in range(16):
                pids = rng.choice(96, r + n, replace=False).tolist()
                fh.write(json.dumps({
                    "qid": q, "relT_pids": pids[:r],
                    "most_hard_pids": pids[r:r + n // 2],
                    "semi_hard_pids": pids[r + n // 2:]}) + "\n")
        paths.append(str(path))
    (tmp_path / "base.yaml").write_text(
        "max_query_len: 12\nmax_passage_len: 32\nwarmup_steps: 1\n"
        "logging_steps: 1\nevaluate_steps: 100\ncompute_dtype: "
        "\"float32\"\n")
    tables = {}
    for name, main, extra in (("jax", j_cur.main, []),
                              ("torch", t_cur.main, ["--device", "cpu"])):
        runs = tmp_path / f"runs_{name}"
        assert main([
            "--queries", f["queries"], "--passages", f["passages"],
            "--training-paths", *paths, "--label-modes", "8", "9",
            "--epochs", "1", "1", "--learning-rates", "1e-6", "1e-6",
            "--batch-size", "8", "--run-folder", str(runs),
            "--config", str(tmp_path / "base.yaml"),
            "--model-checkpoint", f["dual"], "--no-pack-passages",
            "--model-config", json.dumps(_TINY_NO_DROPOUT),
            "--tokenizer", "hash",
            "--eval-queries", f["queries"], "--eval-qrels", f["qrels"],
            "--eval-topk", "20", "--eval-batch-size", "16",
            "--eval-bucket-lengths", *extra]) == 0
        rows = (runs / "curriculum_eval.tsv").read_text().splitlines()
        tables[name] = [line.split("\t") for line in rows]
    j, t = tables["jax"], tables["torch"]
    assert len(t) == 3 and t[0] == j[0] and t[0][0] == "step"
    np.testing.assert_allclose(np.array([r[1:] for r in t[1:]], float),
                               np.array([r[1:] for r in j[1:]], float),
                               atol=1e-6)


# ------------------------------------------------------------- tokenizer


def test_train_wordpiece_tokenizer_matches_reference():
    """The same tokenizer but for its learned vocabulary: the trainer's
    merges at equal counts, and so its vocabulary, vary from run to run
    (two runs of the reference differ). So the two packages' trainers
    must give the same pipeline (normalizer, pre-tokenizer, template,
    special tokens and their ids, decoder), the same padded shapes and
    token types, and the port's adapter over the reference's trained
    tokenizer must give the reference's ids."""
    from cldrd_tpu.data.tokenization import train_wordpiece_tokenizer as jw
    from cldrd_tpu_torch.data import HFTokenizerAdapter
    from cldrd_tpu_torch.data import train_wordpiece_tokenizer as tw

    rng = np.random.default_rng(14)
    words = ["retrieval", "dense", "curriculum", "distillation", "teacher",
             "student", "passage", "query", "ranking", "marco"]
    texts = [" ".join(rng.choice(words, 8)) + f" token{i % 50}"
             for i in range(300)]
    ours, ref = tw(texts, vocab_size=300), jw(texts, vocab_size=300)

    def pipeline(adapter):
        spec = json.loads(adapter.tokenizer.backend_tokenizer.to_str())
        spec["model"].pop("vocab")
        return spec

    assert pipeline(ours) == pipeline(ref)
    for token in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"):
        assert ours.tokenizer.convert_tokens_to_ids(token) == \
            ref.tokenizer.convert_tokens_to_ids(token)
    probe = ["dense passage retrieval", "a teacher unseenword curriculum"]
    for kw in ({}, {"pairs": ["query ranking", "marco"],
                    "return_token_type_ids": True}):
        a, b = ours(probe, 16, **kw), ref(probe, 16, **kw)
        assert a.keys() == b.keys()
        assert all(a[k].shape == b[k].shape == (2, 16) for k in a)
        if "token_type_ids" in a:
            np.testing.assert_array_equal(a["token_type_ids"],
                                          b["token_type_ids"])
        same = HFTokenizerAdapter(ref.tokenizer)(probe, 16, **kw)
        for key in b:
            np.testing.assert_array_equal(same[key], b[key])


# ------------------------------------------ reconstruct and range_search

_N, _DIM = 300, 16


def _index_pair(store):
    rng = np.random.default_rng(15)
    embs = rng.integers(-4, 5, (_N, _DIM)).astype(np.float32)
    ids = rng.permutation(10 * _N)[:_N].astype(np.int64)
    jdt, tdt = _STORE[store]
    ours = FlatIPIndex.build(embs, ids, dtype=tdt, block_rows=64,
                             device="cpu")
    ref = JIndex.build(embs, ids, dtype=jdt, block_rows=64)
    return ours, ref, ids, rng


@pytest.mark.parametrize("store", list(_STORE))
def test_reconstruct_matches_reference(store):
    ours, ref, ids, _ = _index_pair(store)
    pick = ids[[0, 7, 299, 150]]
    got = ours.reconstruct(pick)
    assert got.dtype == np.float32 and got.shape == (4, _DIM)
    np.testing.assert_array_equal(got, ref.reconstruct(pick))
    np.testing.assert_array_equal(ours.reconstruct(int(ids[3])),
                                  ref.reconstruct(int(ids[3])))
    assert ours.reconstruct(int(ids[3])).shape == (_DIM,)
    missing = int(10 * _N + 1)
    for index in (ours, ref):
        with pytest.raises(KeyError, match=str(missing)):
            index.reconstruct([int(ids[0]), missing])
    removed = ours.remove([int(ids[7])])
    with pytest.raises(KeyError):
        removed.reconstruct(int(ids[7]))
    np.testing.assert_array_equal(removed.reconstruct(int(ids[0])),
                                  got[0])


@pytest.mark.parametrize("store", list(_STORE))
def test_range_search_matches_reference(store):
    ours, ref, _, rng = _index_pair(store)
    q = rng.integers(-2, 3, (5, _DIM)).astype(np.float32)
    q[0] = 0  # every score 0: no hit above radius 0.5
    # a radius deep enough for the doubling depths 8, 16, 32, 64
    radius = 4.5
    lims, scores, hits = ours.range_search(q, radius, k_start=8)
    rl, rs, rh = ref.range_search(jnp.asarray(q), radius, k_start=8)
    np.testing.assert_array_equal(lims, rl)
    np.testing.assert_array_equal(scores, rs)
    np.testing.assert_array_equal(hits, rh)
    assert lims[1] == 0 and lims[-1] == len(hits) > 4 * 8
    # the exact oracle: every row scoring above the radius
    stored = ours.reconstruct(np.sort(ours._host_ids()[
        ours._host_ids() >= 0]))
    ids_sorted = np.sort(ours._host_ids()[ours._host_ids() >= 0])
    for i in range(len(q)):
        s = stored @ q[i]
        want = set(ids_sorted[s > radius].tolist())
        assert set(hits[lims[i]:lims[i + 1]].tolist()) == want
        assert np.all(np.diff(scores[lims[i]:lims[i + 1]]) <= 0)
    with pytest.raises(RuntimeError, match="unsaturated"):
        ours.range_search(q, radius, k_start=8, max_passes=2)
    with pytest.raises(RuntimeError, match="unsaturated"):
        ref.range_search(jnp.asarray(q), radius, k_start=8, max_passes=2)
    every = ours.range_search(q, -1e9, k_start=8, max_passes=None)
    assert (np.diff(every[0]) == _N).all()
