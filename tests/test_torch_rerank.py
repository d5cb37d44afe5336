"""The teacher and rerank path of the port against the JAX package, on
the CPU at tiny sizes: BERT towers, both cross-encoder heads (flat and
packed), the HF conversions, pair tokenization, the reranking dataset,
the docstore, teacher buckets, the reranking evaluators, and the CLIs
create_training_data / rerank_eval / retrieve_queries / export / serve's
rerank stage.

Tolerances: outputs within 1e-5 of the largest magnitude in fp32 and
2e-2 in bf16 unless a test states otherwise; arrays, files and metric
dicts of the data path are EQUAL (metric dicts within 1e-6 where scores
come from two models)."""
import contextlib
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from cldrd_tpu.data import docstore as j_docstore
from cldrd_tpu.data import teacher as j_teacher
from cldrd_tpu.data.reranking_dataset import RerankingDataset as JRerankDS
from cldrd_tpu.data.tokenization import HashTokenizer as JTokenizer
from cldrd_tpu.evaluation import reranking_evaluator as j_rev
from cldrd_tpu.models import BertConfig as JBertConfig
from cldrd_tpu.models import BertEncoder as JBertEncoder
from cldrd_tpu.models import CrossEncoder as JCrossEncoder
from cldrd_tpu.models import DistilBertConfig as JConfig
from cldrd_tpu.models import NwayDualEncoder as JDualEncoder
from cldrd_tpu_torch.data import HashTokenizer, TsvDocStore
from cldrd_tpu_torch.data import teacher as t_teacher
from cldrd_tpu_torch.data.reranking_dataset import RerankingDataset
from cldrd_tpu_torch.evaluation import reranking_evaluator as t_rev
from cldrd_tpu_torch.models import (
    BertConfig,
    BertEncoder,
    CrossEncoder,
    DistilBertConfig,
    NwayDualEncoder,
)
from cldrd_tpu_torch.models.convert import (
    cross_encoder_from_flax,
    cross_encoder_state_dict,
    cross_encoder_to_hf,
    dual_encoder_state_dict,
    dual_encoder_to_reference,
    params_from_flax,
    tower_from_flax,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _pair_batch(rng, bz, length, vocab):
    """ids, mask (row lengths >= 4) and token types flipping 0 -> 1 inside
    each row's valid span, as [CLS] q [SEP] | p [SEP] does."""
    lens = rng.integers(4, length + 1, bz)
    ids = rng.integers(3, vocab, (bz, length)).astype(np.int32)
    mask = (np.arange(length)[None] < lens[:, None]).astype(np.int32)
    ids = ids * mask
    splits = np.array([rng.integers(2, n) for n in lens])
    types = ((np.arange(length)[None] >= splits[:, None]) & (mask == 1))
    return ids, mask, types.astype(np.int32)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in
            batch.items()}


def _jax_cross(cfg, arch, jdt, pairs, seed=0):
    model = JCrossEncoder(config=cfg, arch=arch, dtype=jdt)
    params = model.init(jax.random.PRNGKey(seed),
                        {k: jnp.asarray(v) for k, v in pairs.items()})
    return model, params["params"]


def _port_cross(cfg, arch, tdt, params):
    model = CrossEncoder(cfg, dtype=tdt, arch=arch)
    model.load_state_dict(cross_encoder_from_flax(_np(params)))
    return model.eval()


# ------------------------------------------------------------- models


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bert_encoder_matches_jax(impl, dtype):
    """BertEncoder with token types, every position, through the weight
    converter (the JAX side's pallas K5 in interpret mode)."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    ids, mask, types = _pair_batch(rng, 4, 16, 512)
    jenc = JBertEncoder(JBertConfig.tiny(attention_impl=impl), dtype=jdt)
    params = jenc.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                       jnp.asarray(mask))["params"]
    want = jenc.apply({"params": params}, jnp.asarray(ids),
                      jnp.asarray(mask), token_type_ids=jnp.asarray(types))
    enc = BertEncoder(BertConfig.tiny(attention_impl=impl), tdt)
    enc.load_state_dict(tower_from_flax(_np(params)))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                  token_type_ids=torch.from_numpy(types).long())
    _close(got.float().numpy(), want, tol)
    assert "embeddings.token_type_embeddings.weight" in enc.state_dict()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ["distilbert", "bert"])
def test_cross_encoder_flat_matches_jax(arch, impl, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    ids, mask, types = _pair_batch(rng, 6, 24, 512)
    pairs = {"input_ids": ids, "attention_mask": mask}
    if arch == "bert":
        pairs["token_type_ids"] = types
    cfg_cls = (JBertConfig, BertConfig) if arch == "bert" else \
        (JConfig, DistilBertConfig)
    jmodel, params = _jax_cross(cfg_cls[0].tiny(attention_impl=impl), arch,
                                jdt, pairs)
    want = jmodel.apply({"params": params},
                        {k: jnp.asarray(v) for k, v in pairs.items()})
    model = _port_cross(cfg_cls[1].tiny(attention_impl=impl), arch, tdt,
                        params)
    with torch.no_grad():
        got = model(_t(pairs))
    assert got.shape == (6,) and got.dtype == tdt
    _close(got.float().numpy(), want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distilbert_cross_encoder_packed_matches_jax(dtype):
    """Packed rows (segments on the einsum path) give the JAX packed
    scores, and in fp32 the flat layout's."""
    jdt, tdt, tol = DTYPES[dtype]
    corpus = _rerank_corpus()
    tok = HashTokenizer(512)
    ds = RerankingDataset.from_pairs(corpus["pairs"], corpus["queries"],
                                     corpus["passages"], tok,
                                     is_cross_encoder=True, max_len=32)
    batch = next(ds.batches_packed(8))
    jmodel, params = _jax_cross(JConfig.tiny(attention_impl="pallas"),
                                "distilbert", jdt, {
                                    "input_ids": np.zeros((1, 8), np.int32),
                                    "attention_mask": np.ones((1, 8),
                                                              np.int32)})
    want = jmodel.apply({"params": params}, {
        k: jnp.asarray(v) for k, v in batch.query_passage.items()})
    model = _port_cross(DistilBertConfig.tiny(attention_impl="pallas"),
                        "distilbert", tdt, params)
    with torch.no_grad():
        got = model(_t(batch.query_passage))
        flat = model(_t(next(ds.batches(8)).query_passage))
    _close(got.float().numpy(), want, tol)
    if dtype == "float32":
        _close(got.numpy(), flat.numpy(), 1e-5)


def test_bert_cross_encoder_refuses_packed_input():
    pairs = {"input_ids": np.zeros((1, 8), np.int32),
             "attention_mask": np.ones((1, 8), np.int32)}
    jmodel, params = _jax_cross(JBertConfig.tiny(), "bert", jnp.float32,
                                pairs)
    packed = dict(pairs, gather_pos=np.zeros((1,), np.int32))
    with pytest.raises(ValueError) as jerr:
        jmodel.apply({"params": params},
                     {k: jnp.asarray(v) for k, v in packed.items()})
    model = _port_cross(BertConfig.tiny(), "bert", torch.float32, params)
    with pytest.raises(ValueError) as terr:
        model(_t(packed))
    assert str(terr.value) == str(jerr.value)


def _hf_bert_config(transformers, cfg, num_labels=None):
    out = transformers.BertConfig(
        vocab_size=cfg.vocab_size,
        max_position_embeddings=cfg.max_position_embeddings,
        hidden_size=cfg.dim, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, intermediate_size=cfg.hidden_dim,
        type_vocab_size=cfg.type_vocab_size)
    if num_labels:
        out.num_labels = num_labels
    return out


@pytest.mark.parametrize("arch", ["distilbert", "bert"])
def test_hf_cross_encoder_conversion(arch):
    """HF *ForSequenceClassification weights (module.-prefixed, in a
    state_dict wrapper's layout) load into the port's CrossEncoder with
    HF's logits (fp32, 1e-5), and convert back to the same keys and
    values; the JAX converter reads them to the same model."""
    transformers = pytest.importorskip("transformers")
    from cldrd_tpu.models.hf_loader import (
        bert_cross_encoder_torch_to_flax,
        cross_encoder_torch_to_flax,
    )

    torch.manual_seed(5)
    if arch == "bert":
        cfg = BertConfig.tiny()
        hf = transformers.BertForSequenceClassification(
            _hf_bert_config(transformers, cfg, 1)).eval()
        jconvert, jcfg = bert_cross_encoder_torch_to_flax, JBertConfig.tiny()
    else:
        cfg = DistilBertConfig.tiny()
        hf = transformers.DistilBertForSequenceClassification(
            transformers.DistilBertConfig(
                vocab_size=cfg.vocab_size,
                max_position_embeddings=cfg.max_position_embeddings,
                dim=cfg.dim, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                hidden_dim=cfg.hidden_dim, num_labels=1)).eval()
        jconvert, jcfg = cross_encoder_torch_to_flax, JConfig.tiny()
    sd = {f"module.{k}": v for k, v in hf.state_dict().items()}
    model = CrossEncoder(cfg, arch=arch)
    model.load_state_dict(cross_encoder_state_dict(sd, arch))
    model.eval()
    rng = np.random.default_rng(5)
    ids, mask, types = _pair_batch(rng, 3, 12, cfg.vocab_size)
    pairs = {"input_ids": ids, "attention_mask": mask}
    kw = {"token_type_ids": torch.from_numpy(types).long()} \
        if arch == "bert" else {}
    if arch == "bert":
        pairs["token_type_ids"] = types
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids).long(),
                 attention_mask=torch.from_numpy(mask).long(),
                 **kw).logits.squeeze(-1).numpy()
        got = model(_t(pairs)).numpy()
    _close(got, ref, 1e-5)
    jmodel = JCrossEncoder(config=jcfg, arch=arch, dtype=jnp.float32)
    jgot = jmodel.apply({"params": jconvert(sd)},
                        {k: jnp.asarray(v) for k, v in pairs.items()})
    _close(got, jgot, 1e-5)
    back = cross_encoder_to_hf(model.state_dict(), arch)
    orig = {k: v for k, v in hf.state_dict().items()
            if not k.endswith("position_ids")}
    assert back.keys() == orig.keys()
    assert all(torch.equal(back[k], orig[k]) for k in orig)


def test_bert_dual_encoder_hf_towers_match_jax():
    """A reference-layout checkpoint with HF BertModel towers: the port
    (a BertConfig stands up BERT towers) and the JAX package give the same
    embeddings (fp32, 1e-5), and the port's reference export is those
    towers, key for key."""
    transformers = pytest.importorskip("transformers")
    from cldrd_tpu.models.hf_loader import dual_encoder_torch_to_flax

    cfg = BertConfig.tiny()
    sd = {}
    for seed, tower in ((7, "query_encoder"), (8, "passage_encoder")):
        torch.manual_seed(seed)
        hf = transformers.BertModel(_hf_bert_config(transformers, cfg))
        sd.update({f"{tower}.{k}": v for k, v in hf.state_dict().items()})
    model = NwayDualEncoder(cfg)
    model.load_state_dict(dual_encoder_state_dict(sd))
    model.eval()
    jmodel = JDualEncoder(config=JBertConfig.tiny(), dtype=jnp.float32)
    jparams = dual_encoder_torch_to_flax(sd)
    rng = np.random.default_rng(9)
    ids, mask, _ = _pair_batch(rng, 5, 12, cfg.vocab_size)
    tokens = {"input_ids": ids, "attention_mask": mask}
    jt = {k: jnp.asarray(v) for k, v in tokens.items()}
    for method in ("query_embs", "passage_embs"):
        want = jmodel.apply({"params": jparams}, jt,
                            method=getattr(jmodel, method))
        with torch.no_grad():
            got = getattr(model, method)(_t(tokens))
        _close(got.numpy(), want, 1e-5)
    back = dual_encoder_to_reference(model.state_dict())
    orig = {k: v for k, v in sd.items()
            if not k.endswith("position_ids") and ".pooler." not in k}
    assert back.keys() == orig.keys()
    assert all(torch.equal(back[k], orig[k]) for k in orig)


# ---------------------------------------------------------- data path


def _rerank_corpus():
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(60)]
    queries = {q: " ".join(rng.choice(words, 4)) for q in range(5)}
    passages = {p: " ".join(rng.choice(words, int(rng.integers(3, 14))))
                for p in range(40)}
    passages[39] = {"title": "a title", "para": "its para text"}
    pairs = [(q, int(p)) for q in range(5)
             for p in rng.choice(40, 7, replace=False)]
    return {"queries": queries, "passages": passages, "pairs": pairs}


def _assert_batches_equal(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert a.n_valid == b.n_valid
        np.testing.assert_array_equal(a.qids, b.qids)
        np.testing.assert_array_equal(a.pids, b.pids)
        for field in ("query_passage", "query", "passage"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.keys() == y.keys()
                for key in x:
                    assert x[key].dtype == y[key].dtype
                    np.testing.assert_array_equal(x[key], y[key])


@pytest.mark.parametrize("mode", ["cross", "cross_types", "dual", "packed"])
def test_reranking_dataset_batches_equal(mode):
    c = _rerank_corpus()
    kw = dict(is_cross_encoder=mode != "dual", max_len=20,
              query_max_len=8, passage_max_len=12,
              with_token_type_ids=mode == "cross_types")
    ours = RerankingDataset.from_pairs(c["pairs"], c["queries"],
                                       c["passages"], HashTokenizer(512), **kw)
    ref = JRerankDS.from_pairs(c["pairs"], c["queries"], c["passages"],
                               JTokenizer(512), **kw)
    if mode == "packed":
        _assert_batches_equal(ours.batches_packed(8), ref.batches_packed(8))
    else:
        _assert_batches_equal(ours.batches(8), ref.batches(8))
    # length buckets, ported since: the same batches as the reference's,
    # on an explicit ladder and on the default one
    for ladder in ([8, 12], None):
        _assert_batches_equal(ours.batches_bucketed(8, ladder),
                              ref.batches_bucketed(8, ladder))


def test_reranking_dataset_from_run_file(tmp_path):
    c = _rerank_corpus()
    (tmp_path / "q.tsv").write_text(
        "".join(f"{q}\t{t}\n" for q, t in c["queries"].items()))
    (tmp_path / "p.tsv").write_text("".join(
        f"{p}\t{t}\n" if isinstance(t, str) else
        f"{p}\t{t['title']}\t{t['para']}\n" for p, t in c["passages"].items()))
    (tmp_path / "run.tsv").write_text(
        "".join(f"{p}\t{q}\t1\t0.5\n" for q, p in c["pairs"]))
    args = [str(tmp_path / n) for n in ("run.tsv", "q.tsv", "p.tsv")]
    kw = dict(is_cross_encoder=True, max_len=24, query_first=False)
    _assert_batches_equal(
        RerankingDataset(*args, HashTokenizer(512), **kw).batches(16),
        JRerankDS(*args, JTokenizer(512), **kw).batches(16))


@pytest.mark.parametrize("max_len", [6, 12, 40])
def test_tokenizer_pairs_and_types_equal(max_len):
    texts = ["Short q", "a much longer query with many words in it", ""]
    pairs = ["p one two three", "x", "only passage words here ok"]
    ours = HashTokenizer(512)(texts, max_len, pairs=pairs,
                              return_token_type_ids=True)
    ref = JTokenizer(512)(texts, max_len, pairs=pairs,
                          return_token_type_ids=True)
    assert ours.keys() == ref.keys() == {"input_ids", "attention_mask",
                                         "token_type_ids"}
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_hf_adapter_pairs_and_types_equal():
    pytest.importorskip("tokenizers")
    from cldrd_tpu.data.tokenization import HFTokenizerAdapter as JAdapter
    from cldrd_tpu.data.tokenization import train_wordpiece_tokenizer
    from cldrd_tpu_torch.data import HFTokenizerAdapter

    fast = train_wordpiece_tokenizer(
        ["the quick brown fox", "jumps over the lazy dog", "query text"],
        vocab_size=120).tokenizer
    texts, pairs = ["the quick query", "dog"], ["lazy fox jumps", "the"]
    for max_len in (5, 16):
        ours = HFTokenizerAdapter(fast)(texts, max_len, pairs=pairs,
                                        return_token_type_ids=True)
        ref = JAdapter(fast)(texts, max_len, pairs=pairs,
                             return_token_type_ids=True)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])


@pytest.fixture()
def tsv(tmp_path):
    p = tmp_path / "passages.tsv"
    rows = [(7, "seven is a passage about sevens"),
            (100, "one hundredé unicode text"),
            (3, "title three\tpara after a title"),
            (42, "answer to everything")]
    p.write_text("".join(f"{i}\t{t}\n" for i, t in rows), encoding="utf-8")
    return str(p)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_docstore_sidecar_is_shared(tsv, writer):
    """A sidecar either package wrote is reused by the other without a
    rebuild, with the same answers."""
    first, second = (j_docstore.TsvDocStore, TsvDocStore) \
        if writer == "jax" else (TsvDocStore, j_docstore.TsvDocStore)
    a = first(tsv)
    sc = j_docstore._sidecar_path(tsv)
    stamp = os.stat(sc).st_mtime_ns
    b = second(tsv)
    assert os.stat(sc).st_mtime_ns == stamp
    ids = [42, 3, 7, 100]
    assert b.get_many(ids) == a.get_many(ids)
    assert len(b) == len(a) == 4 and 3 in b and 5 not in b
    assert b.get(3) == {"title": "title three", "para": "para after a title"}


def test_docstore_errors_match_jax(tmp_path, tsv):
    """Missing ids, untabbed and duplicate rows, a stale or corrupt
    sidecar and a missing trailing newline, as in the reference."""
    msgs = []
    for cls in (TsvDocStore, j_docstore.TsvDocStore):
        with pytest.raises(KeyError) as e:
            cls(tsv).get_many([7, 5, 9])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "5, 9" in msgs[0]
    bad = tmp_path / "bad.tsv"
    bad.write_text("1 no tab here\n", encoding="utf-8")
    dup = tmp_path / "dup.tsv"
    dup.write_text("1\ta\n1\tb\n", encoding="utf-8")
    for path, match in ((bad, "tab"), (dup, "duplicate")):
        errs = []
        for cls in (TsvDocStore, j_docstore.TsvDocStore):
            with pytest.raises(ValueError, match=match) as e:
                cls(str(path))
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    with open(j_docstore._sidecar_path(tsv), "wb") as f:
        f.write(b"not a zip")
    assert TsvDocStore(tsv).get(7).startswith("seven")
    time.sleep(0.01)
    with open(tsv, "a", encoding="utf-8") as f:
        f.write("77\tnew row")  # no trailing newline
    assert TsvDocStore(tsv).get(77) == "new row"
    assert j_docstore.TsvDocStore(tsv).get(77) == "new row"


def test_bucket_example_and_curriculum_files_identical(tmp_path):
    rng = np.random.default_rng(4)
    scored = {q: sorted(((int(p), float(s)) for p, s in zip(
        rng.permutation(200)[:int(rng.integers(28, 45))],
        rng.normal(size=45))), key=lambda t: -t[1]) for q in range(12)}
    for args in ((5, 12, 13), (30, 0, 0), (20, 5, 5)):
        for q, s in scored.items():
            assert t_teacher.bucket_example(
                q, s, *args, np.random.default_rng(q)) == \
                j_teacher.bucket_example(q, s, *args,
                                         np.random.default_rng(q))
    ours = t_teacher.build_curriculum_files(scored, str(tmp_path / "t_"))
    ref = j_teacher.build_curriculum_files(scored, str(tmp_path / "j_"))
    assert ours.keys() == ref.keys() == t_teacher.CURRICULUM_BUCKETS.keys()
    assert t_teacher.CURRICULUM_BUCKETS == j_teacher.CURRICULUM_BUCKETS
    for stage in ours:
        a = open(ours[stage], "rb").read()
        assert a == open(ref[stage], "rb").read() and a


@pytest.mark.parametrize("arch", ["distilbert", "bert", "packed"])
def test_rerank_candidates_with_teacher_agrees(arch):
    """Teacher scores (fp32) within 1e-5 of the largest, same candidate
    sets per query."""
    c = _rerank_corpus()
    ranklists = {}
    for q, p in c["pairs"]:
        ranklists.setdefault(q, []).append(p)
    model_arch = "distilbert" if arch == "packed" else arch
    cfgs = (JBertConfig, BertConfig) if arch == "bert" else \
        (JConfig, DistilBertConfig)
    pairs = {"input_ids": np.zeros((1, 8), np.int32),
             "attention_mask": np.ones((1, 8), np.int32)}
    jmodel, params = _jax_cross(cfgs[0].tiny(), model_arch, jnp.float32,
                                pairs, seed=6)
    model = _port_cross(cfgs[1].tiny(), model_arch, torch.float32, params)
    kw = dict(max_len=24, batch_size=8, pack_pairs=arch == "packed",
              with_token_type_ids=arch == "bert")
    ours = t_teacher.rerank_candidates_with_teacher(
        ranklists, t_rev.make_cross_encoder_score_fn(model), c["queries"],
        c["passages"], HashTokenizer(512), **kw)
    ref = j_teacher.rerank_candidates_with_teacher(
        ranklists, j_rev.make_cross_encoder_score_fn(jmodel, params),
        c["queries"], c["passages"], JTokenizer(512), **kw)
    assert ours.keys() == ref.keys()
    for q in ref:
        mine, theirs = dict(ours[q]), dict(ref[q])
        assert mine.keys() == theirs.keys()
        keys = sorted(theirs)
        _close([mine[k] for k in keys], [theirs[k] for k in keys], 1e-5)


# -------------------------------------------------------- evaluators


@pytest.fixture()
def files(tmp_path):
    queries = tmp_path / "queries.tsv"
    queries.write_text("".join(f"{q}\tquery text {q}\n" for q in range(3)))
    passages = tmp_path / "passages.tsv"
    passages.write_text("".join(f"{p}\tpassage body {p} w{p % 5}\n"
                                for p in range(12)))
    run = tmp_path / "run.tsv"
    run.write_text("".join(
        f"{q}\t{p}\t{r}\t{1.0 / r}\n" for q in range(3)
        for r, p in enumerate(range(q * 4, q * 4 + 4), start=1)))
    qrels = tmp_path / "qrels.tsv"
    qrels.write_text("".join(f"{q}\t0\t{q * 4 + 3}\t1\n" for q in range(3)))
    return {k: str(v) for k, v in (("queries", queries),
                                   ("passages", passages), ("run", run),
                                   ("qrels", qrels), ("tmp", tmp_path))}


def _dual_params(seed):
    model = JDualEncoder(config=JConfig.tiny(), dtype=jnp.float32)
    ids = jnp.ones((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(seed),
                        {"input_ids": ids, "attention_mask": ids},
                        {"input_ids": ids[:, None],
                         "attention_mask": ids[:, None]})["params"]
    return model, params


def _datasets(f, cross):
    kw = dict(is_cross_encoder=cross, max_len=24, query_max_len=8,
              passage_max_len=12)
    args = (f["run"], f["queries"], f["passages"])
    return (RerankingDataset(*args, HashTokenizer(512), **kw),
            JRerankDS(*args, JTokenizer(512), **kw))


def _metrics_close(ours, ref):
    assert ours.keys() == ref.keys()
    for k in ref:
        assert abs(float(ours[k]) - float(ref[k])) <= 1e-6, k


@pytest.mark.parametrize("mode", ["dual", "cross"])
def test_reranking_evaluator_matches_jax(files, mode, tmp_path):
    ds, jds = _datasets(files, mode == "cross")
    kw = dict(mrr_at_k=(1, 4), recall_at_k=(4,), ndcg_at_k=(4,), map_at_k=4)
    ev = t_rev.RerankingEvaluator(files["qrels"], **kw)
    jev = j_rev.RerankingEvaluator(files["qrels"], **kw)
    if mode == "dual":
        jmodel, params = _dual_params(3)
        model = NwayDualEncoder(DistilBertConfig.tiny())
        model.load_state_dict(params_from_flax(_np(params)))
        fn = t_rev.make_dual_encoder_score_fn(model.eval())
        jfn = j_rev.make_dual_encoder_score_fn(jmodel, params)
    else:
        jmodel, params = _jax_cross(JConfig.tiny(), "distilbert",
                                    jnp.float32, {
                                        "input_ids": np.zeros((1, 8),
                                                              np.int32),
                                        "attention_mask": np.ones(
                                            (1, 8), np.int32)}, seed=4)
        model = _port_cross(DistilBertConfig.tiny(), "distilbert",
                            torch.float32, params)
        fn = t_rev.make_cross_encoder_score_fn(model)
        jfn = j_rev.make_cross_encoder_score_fn(jmodel, params)
    paths = [str(tmp_path / f"{n}.tsv") for n in ("t", "j")]
    ours = ev.compute_metrics(fn, ds, 5, rankdata_path=paths[0])
    ref = jev.compute_metrics(jfn, jds, 5, rankdata_path=paths[1])
    _metrics_close(ours, ref)
    ranked = [[line.split("\t")[:3] for line in open(p).read().splitlines()]
              for p in paths]
    assert ranked[0] == ranked[1] and len(ranked[0]) == 12
    lists = {0: [3, 1, 2, 0], 1: [4, 7], 2: [11]}
    _metrics_close(ev.direct_compute_metric(lists),
                   jev.direct_compute_metric(lists))


def test_continue_rerank_evaluator_folder(files, tmp_path):
    """Every checkpoint of a folder: JAX-written .msgpack ones and a
    port-written .pth.tar, step-keyed; each step's metric dict within
    1e-6 of the JAX evaluator's on the same weights."""
    from cldrd_tpu.cli.common import load_dual_encoder_params
    from cldrd_tpu_torch.cli.common import load_dual_encoder

    folder = tmp_path / "run"
    folder.mkdir()
    for step, seed in ((10, 1), (20, 2)):
        _, params = _dual_params(seed)
        (folder / f"checkpoint_{step}.msgpack").write_bytes(
            serialization.msgpack_serialize({"params": params,
                                             "step": np.int32(step)}))
    ds, jds = _datasets(files, False)
    kw = dict(mrr_at_k=(1, 4), recall_at_k=(4,), ndcg_at_k=(4,), map_at_k=4)
    cfg, jcfg = DistilBertConfig.tiny(), JConfig.tiny()
    jmodel = JDualEncoder(config=jcfg, dtype=jnp.float32)
    ours = t_rev.ContinueRerankEvaluator(
        t_rev.RerankingEvaluator(files["qrels"], **kw), ds,
        t_rev.make_dual_encoder_score_fn,
        lambda p: load_dual_encoder(p, cfg, False, False, torch.float32,
                                    "cpu"), batch_size=4)
    ref = j_rev.ContinueRerankEvaluator(
        j_rev.RerankingEvaluator(files["qrels"], **kw), jds,
        lambda params: j_rev.make_dual_encoder_score_fn(jmodel, params),
        lambda p: load_dual_encoder_params(p, jmodel, jcfg, False),
        batch_size=4)
    res = ours.evaluate_folder(str(folder), str(tmp_path / "t.tsv"))
    jres = ref.evaluate_folder(str(folder), str(tmp_path / "j.tsv"))
    assert set(res) == set(jres) == {10, 20}
    for step in jres:
        _metrics_close(res[step], jres[step])
    assert (tmp_path / "t.tsv").read_text() == (tmp_path / "j.tsv").read_text()
    # the port's own checkpoints are evaluated beside the JAX ones
    model = load_dual_encoder(str(folder / "checkpoint_10.msgpack"), cfg,
                              False, False, torch.float32, "cpu")
    torch.save({"state_dict": model.state_dict()},
               folder / "checkpoint_30.pth.tar")
    assert [s for s, _ in ours.checkpoints(str(folder))] == [10, 20, 30]
    assert ours.evaluate_folder(str(folder))[30] == res[10]


# ------------------------------------------------------------- CLIs


def _corpus(tmp):
    """16 queries; each query's relevant passage shares its wording
    (tests/test_cli.py::corpus_files)."""
    rng = np.random.default_rng(0)
    queries, passages, qrels = [], [], []
    pid = 0
    for q in range(16):
        queries.append(f"{q}\tfind subject{q} info\n")
        passages.append(f"{pid}\tdocument with subject{q} info inside\n")
        qrels.append(f"{q}\t0\t{pid}\t{1 + q % 3}\n")
        pid += 1
        for _ in range(5):
            passages.append(f"{pid}\tnoise {rng.integers(10**6)} text "
                            f"{rng.integers(10**6)}\n")
            pid += 1
    paths = {name: str(tmp / f"{name}.tsv")
             for name in ("queries", "passages", "qrels", "cands")}
    for name, lines in (("queries", queries), ("passages", passages),
                        ("qrels", qrels)):
        with open(paths[name], "w") as f:
            f.write("".join(lines))
    # 4 train queries x 32 candidates, each query's relevant one among them
    with open(paths["cands"], "w") as f:
        for q in range(4):
            pids = [q * 6] + [int(p) for p in rng.permutation(96)
                              if p != q * 6][:31]
            for rank, p in enumerate(rng.permutation(pids), start=1):
                f.write(f"{q}\t{p}\t{rank}\t{1.0 / rank:.4f}\n")
    return paths


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rerank_cli")
    f = _corpus(tmp)
    _, params = _dual_params(11)
    f["dual"] = str(tmp / "checkpoint_3.msgpack")
    with open(f["dual"], "wb") as fh:
        fh.write(serialization.msgpack_serialize({"params": params}))
    for arch, cfg in (("distilbert", JConfig.tiny()),
                      ("bert", JBertConfig.tiny())):
        _, tparams = _jax_cross(cfg, arch, jnp.float32, {
            "input_ids": np.zeros((1, 8), np.int32),
            "attention_mask": np.ones((1, 8), np.int32)}, seed=12)
        f[arch] = str(tmp / f"teacher_{arch}.msgpack")
        with open(f[arch], "wb") as fh:
            fh.write(serialization.msgpack_serialize({"params": tparams}))
    f["tmp"] = tmp
    return f


def _out(main, argv):
    """A CLI's printed JSON (the last top-level object of its stdout,
    which also carries its log lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    lines = buf.getvalue().splitlines()
    starts = [i for i, line in enumerate(lines) if line.startswith("{")]
    return "\n".join(lines[starts[-1]:]) if starts else ""


def _jsonl(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


def test_cli_create_training_data_oracle_identical(cli_files, tmp_path):
    from cldrd_tpu.cli import create_training_data as j_ctd
    from cldrd_tpu_torch.cli import create_training_data as t_ctd

    f = cli_files
    argv = ["--candidates-run", f["cands"], "--queries", f["queries"],
            "--passages", f["passages"], "--teacher-oracle-qrels",
            f["qrels"], "--teacher-noise", "0.3", "--model-size", "tiny"]
    t_paths = json.loads(_out(t_ctd.main, [
        *argv, "--out-prefix", str(tmp_path / "t_"), "--device", "cpu"]))
    j_paths = json.loads(_out(j_ctd.main, [
        *argv, "--out-prefix", str(tmp_path / "j_")]))
    assert t_paths.keys() == j_paths.keys() and len(t_paths) == 4
    for stage in t_paths:
        a = open(t_paths[stage], "rb").read()
        assert a and a == open(j_paths[stage], "rb").read()


@pytest.mark.parametrize("arch", ["distilbert", "bert"])
def test_cli_create_training_data_teacher_agrees(cli_files, tmp_path, arch):
    """A tiny cross-encoder teacher from a JAX .msgpack, fp32: the same
    queries in every stage, and every score within 1e-5 of the largest;
    where no two scores of a query are that close, the same buckets."""
    from cldrd_tpu.cli import create_training_data as j_ctd
    from cldrd_tpu_torch.cli import create_training_data as t_ctd

    f = cli_files
    argv = ["--candidates-run", f["cands"], "--queries", f["queries"],
            "--passages", f["passages"], "--teacher-checkpoint", f[arch],
            "--teacher-arch", arch, "--model-size", "tiny",
            "--max-length", "32", "--batch-size", "16",
            "--compute-dtype", "float32", "--attention-impl", "pallas"]
    t_paths = json.loads(_out(t_ctd.main, [
        *argv, "--out-prefix", str(tmp_path / "t_"), "--device", "cpu"]))
    j_paths = json.loads(_out(j_ctd.main, [
        *argv, "--out-prefix", str(tmp_path / "j_")]))
    for stage in j_paths:
        ours, ref = _jsonl(t_paths[stage]), _jsonl(j_paths[stage])
        assert [r["qid"] for r in ours] == [r["qid"] for r in ref] == \
            [0, 1, 2, 3]
        for a, b in zip(ours, ref):
            sa = a["relT_scores"] + a["most_hard_scores"]
            sb = b["relT_scores"] + b["most_hard_scores"]
            _close(sa, sb, 1e-5)
            if min(np.diff(sorted(sb)), default=1.0) > 1e-4:
                assert a["relT_pids"] == b["relT_pids"]
                assert a["most_hard_pids"] == b["most_hard_pids"]


def test_cli_create_training_data_refuses_unported(cli_files, tmp_path):
    from cldrd_tpu_torch.cli import create_training_data as t_ctd

    f = cli_files
    argv = ["--candidates-run", f["cands"], "--queries", f["queries"],
            "--passages", f["passages"], "--out-prefix", str(tmp_path / "x"),
            "--model-size", "tiny", "--device", "cpu"]
    # --bucket-lengths is ported (tests/test_torch_host_runtime.py); the
    # reference's refusal of --pack-pairs with the bert teacher stays,
    # with buckets asked for too
    with pytest.raises(SystemExit):
        t_ctd.main([*argv, "--teacher-arch", "bert", "--pack-pairs"])
    with pytest.raises(SystemExit):
        t_ctd.main([*argv, "--teacher-arch", "bert", "--pack-pairs",
                    "--bucket-lengths", "32"])
    with pytest.raises(SystemExit):
        t_ctd.main([*argv, "--teacher-arch", "distilbert", "--arch", "bert"])


@pytest.mark.parametrize("mode", ["dual", "cross"])
def test_cli_rerank_eval_matches_jax(cli_files, mode):
    from cldrd_tpu.cli import rerank_eval as j_re
    from cldrd_tpu_torch.cli import rerank_eval as t_re

    f = cli_files
    argv = ["--candidates-run", f["cands"], "--queries", f["queries"],
            "--passages", f["passages"], "--qrels", f["qrels"],
            "--mode", mode, "--model-size", "tiny", "--tokenizer", "hash",
            "--max-query-len", "12", "--max-passage-len", "16",
            "--max-length", "32", "--batch-size", "16",
            "--compute-dtype", "float32"]
    if mode == "cross":
        argv += ["--checkpoint", f["bert"], "--teacher-arch", "bert"]
    else:
        argv += ["--checkpoint", f["dual"]]
    ours = json.loads(_out(t_re.main, [*argv, "--device", "cpu"]))
    ref = json.loads(_out(j_re.main, argv))
    _metrics_close(ours, ref)
    assert ours["QueriesRanked"] == 4


def test_cli_retrieve_queries_identical(cli_files, tmp_path, monkeypatch):
    """Passages -> top queries over a query index: the port's run file
    has the JAX CLI's (pid, qid, rank) rows, every row, and scores within
    rtol 1e-5 (two fp32 encoders differ in reduction order, ~1e-7
    relative). The query index holds integer-valued embeddings, written
    once by the JAX package and read by both CLIs, so that a passage's
    scores lie far apart: the test asserts every neighbouring pair is
    more than 1e-4 apart, relative (1.5e-4 at the closest)."""
    from cldrd_tpu.cli import retrieve_queries as j_rq
    from cldrd_tpu.index.persistence import write_embeddings
    from cldrd_tpu.search import mips as jmips
    from cldrd_tpu_torch.cli import retrieve_queries as t_rq

    monkeypatch.setattr(jmips, "_INTERPRET", True)
    # the JAX CLI has no dtype flags (bf16 encoder, bf16 store): run it in
    # fp32, as the port runs with --compute-dtype / --hbm-dtype float32
    import functools
    import types

    from cldrd_tpu.index import load_index as j_load_index

    monkeypatch.setattr(j_rq, "jnp", types.SimpleNamespace(
        bfloat16=jnp.float32))
    monkeypatch.setattr(j_rq, "load_index", functools.partial(
        j_load_index, dtype=jnp.float32))
    f = cli_files
    n_q, topk = 16, 8
    qidx = str(tmp_path / "qindex")
    write_embeddings(qidx, np.random.default_rng(5).integers(
        -8, 9, (n_q, JConfig.tiny().dim)).astype(np.float32),
        np.arange(n_q, dtype=np.int64))
    common = ["--checkpoint", f["dual"], "--model-size", "tiny",
              "--tokenizer", "hash"]
    rows = {}
    for name, rq_cli, extra in (
            ("jax", j_rq, []),
            ("torch", t_rq, ["--device", "cpu", "--compute-dtype", "float32",
                             "--hbm-dtype", "float32"])):
        run = str(tmp_path / f"{name}.p2q.tsv")
        _out(rq_cli.main, ["--query-index", qidx, "--passages",
                           f["passages"], "--run", run, "--max-length", "16",
                           "--topk", str(topk), "--encode-batch-size", "32",
                           "--search-batch-size", "8", *common, *extra])
        lines = [line.split("\t") for line in open(run).read().splitlines()]
        rows[name] = ([tuple(int(x) for x in r[:3]) for r in lines],
                      np.array([float(r[3]) for r in lines]))
    assert len(rows["jax"][0]) == 96 * topk
    assert rows["torch"][0] == rows["jax"][0]
    np.testing.assert_allclose(rows["torch"][1], rows["jax"][1], rtol=1e-5)
    s = rows["jax"][1].reshape(96, topk)
    # neighbours ten times the tolerance apart: no score within it swaps
    assert (np.abs(np.diff(s, axis=1)) > 1e-4 * np.abs(s[:, 1:])).all()


@pytest.mark.parametrize("fmt", ["reference", "hf"])
def test_cli_export_matches_jax(cli_files, tmp_path, fmt):
    """From a JAX .msgpack, both formats hold the JAX export's keys and
    values; the reference export round-trips into the port's index."""
    from cldrd_tpu.cli import export as j_export
    from cldrd_tpu_torch.cli import export as t_export
    from cldrd_tpu_torch.cli import index as t_index

    f = cli_files
    name = "ckpt.pth.tar" if fmt == "reference" else "hf"
    argv = ["--checkpoint", f["dual"], "--format", fmt,
            "--model-size", "tiny", "--tokenizer", "hash"]
    _out(t_export.main, [*argv, "--out", str(tmp_path / "t" / name),
                         "--device", "cpu"])
    _out(j_export.main, [*argv, "--out", str(tmp_path / "j" / name)])
    if fmt == "reference":
        files = [("t", "ckpt.pth.tar")]
    else:
        files = [("t", os.path.join("hf", t, "pytorch_model.bin"))
                 for t in ("query_encoder", "passage_encoder")]
    for _, rel in files:
        ours = torch.load(tmp_path / "t" / rel, weights_only=True)
        ref = torch.load(tmp_path / "j" / rel, weights_only=True)
        if fmt == "reference":
            ours, ref = ours["state_dict"], ref["state_dict"]
        assert ours.keys() == ref.keys()
        assert all(torch.equal(ours[k], ref[k]) for k in ref)
    if fmt == "reference":
        stats = json.loads(_out(t_index.main, [
            "--collection", f["passages"], "--out", str(tmp_path / "idx"),
            "--checkpoint", str(tmp_path / "t" / name), "--model-size",
            "tiny", "--max-length", "16", "--compute-dtype", "float32",
            "--device", "cpu"]))
        assert stats["passages"] == 96


# ------------------------------------------------------ serve rerank


def _post(url, path, payload, expect=200):
    req = urllib.request.Request(url + path, data=json.dumps(payload)
                                 .encode(),
                                 headers={"Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=120) as r:
            assert expect == 200
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        assert e.code == expect, e.read()
        return json.loads(e.read())


@contextlib.contextmanager
def _daemon(serve_mod, argv):
    httpd = serve_mod.serve(serve_mod.build_parser().parse_args(argv))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.RequestHandlerClass.service.close()
        httpd.shutdown()
        httpd.server_close()


def test_cli_serve_rerank_matches_rerank_eval_and_jax(cli_files, tmp_path):
    """The port's daemon with a resident cross-encoder: /rerank EQUALS the
    offline cross path (rerank_eval's score function over
    RerankingDataset batches at the daemon's batch shape); its order is
    the JAX daemon's wherever their scores are apart by more than the bf16
    tolerance; /search rerank_k reorders the first stage by those scores;
    texts added by /add stay rerankable; bad requests answer 400."""
    from cldrd_tpu.cli import index as j_index
    from cldrd_tpu.cli import serve as j_serve
    from cldrd_tpu_torch.cli import index as t_index
    from cldrd_tpu_torch.cli import serve as t_serve
    from cldrd_tpu_torch.cli.common import load_cross_encoder, \
        cross_encoder_config
    from cldrd_tpu_torch.data import load_passages, passage_text

    f = cli_files
    common = ["--checkpoint", f["dual"], "--model-size", "tiny",
              "--tokenizer", "hash"]
    idx = {}
    for name, cli, extra in (("jax", j_index, []),
                             ("torch", t_index, ["--device", "cpu"])):
        idx[name] = str(tmp_path / f"idx_{name}")
        _out(cli.main, ["--collection", f["passages"], "--out", idx[name],
                        "--max-length", "16", "--batch-size", "8",
                        "--compute-dtype", "float32", *common, *extra])
    serve_argv = ["--port", "0", "--max-length", "12",
                  "--passage-max-length", "16", "--encode-batch-size", "8",
                  "--topk", "8", "--reranker", "distilbert",
                  "--reranker-size", "tiny", "--reranker-checkpoint",
                  f["distilbert"], "--rerank-max-length", "24",
                  "--rerank-batch-size", "4", "--passages", f["passages"],
                  *common]
    texts = [passage_text(p) for p in
             list(load_passages(f["passages"]).values())[:6]]
    query = "find subject3 info"
    with _daemon(j_serve, ["--index", idx["jax"], *serve_argv]) as (_, jurl):
        jgot = _post(jurl, "/rerank", {"query": query, "passages": texts})
    with _daemon(t_serve, ["--index", idx["torch"], *serve_argv,
                           "--device", "cpu"]) as (httpd, url):
        svc = httpd.RequestHandlerClass.service
        health = json.loads(urllib.request.build_opener(
            urllib.request.ProxyHandler({})).open(url + "/healthz").read())
        assert health["reranker"] == "distilbert"
        got = _post(url, "/rerank", {"query": query, "passages": texts})
        scores = [h["score"] for h in got["results"]]
        assert scores == sorted(scores, reverse=True)
        # the offline path: the same model, batches of the daemon's shape
        model = load_cross_encoder(
            f["distilbert"], cross_encoder_config("distilbert", "tiny"),
            "distilbert", torch.bfloat16, "cpu")
        fn = t_rev.make_cross_encoder_score_fn(model)
        ds = RerankingDataset.from_pairs(
            [(0, i) for i in range(6)], {0: query}, dict(enumerate(texts)),
            svc.reranker.tokenizer, is_cross_encoder=True, max_len=24)
        offline = {}
        for batch in ds.batches(4):
            s = fn(batch)
            for i in range(batch.n_valid):
                offline[int(batch.pids[i])] = float(s[i])
        assert {h["index"]: h["score"] for h in got["results"]} == offline
        # the JAX daemon's order, up to its scores' bf16 tolerance
        jscore = {h["index"]: h["score"] for h in jgot["results"]}
        tol = 2e-2 * max(abs(v) for v in jscore.values())
        _close([offline[i] for i in range(6)], [jscore[i] for i in range(6)],
               2e-2)
        order = [h["index"] for h in got["results"]]
        for a, b in zip(order, order[1:]):
            assert jscore[a] >= jscore[b] - tol
        assert _post(url, "/rerank", {"query": query, "passages": texts,
                                      "k": 2})["results"] == got["results"][:2]
        # two stages: first-stage candidates reordered by the teacher
        first = _post(url, "/search", {"queries": [query], "k": 6}
                      )["results"][0]
        two = _post(url, "/search", {"queries": [query], "k": 4,
                                     "rerank_k": 6})["results"][0]
        ids = [h["id"] for h in first]
        pool = [passage_text(p) for p in TsvDocStore(f["passages"])
                .get_many(ids)]
        oracle = _post(url, "/rerank", {"query": query, "passages": pool})
        assert [h["id"] for h in two] == \
            [ids[h["index"]] for h in oracle["results"]][:4]
        retrieval = {h["id"]: h["score"] for h in first}
        assert all(h["retrieval_score"] == retrieval[h["id"]] for h in two)
        out = _post(url, "/search", {"queries": [query], "k": 3,
                                     "rerank_k": 5, "exclude_ids": ids[:1]})
        assert ids[0] not in [h["id"] for h in out["results"][0]]
        _post(url, "/add", {"ids": [9100], "texts": ["zebra stripes doc"]})
        assert svc._passages_for_ids([9100]) == ["zebra stripes doc"]
        _post(url, "/remove", {"ids": [9100]})
        assert 9100 not in svc._live_texts
        for path, bad in (
                ("/search", {"queries": [query], "k": 7, "rerank_k": 6}),
                ("/search", {"queries": [query], "k": 2, "rerank_k": 99}),
                ("/rerank", {"query": query, "passages": []}),
                ("/rerank", {"query": query, "passages": texts, "k": 0}),
                ("/rerank", {"query": 5, "passages": texts})):
            _post(url, path, bad, expect=400)
        svc.docstore = None
        err = _post(url, "/search", {"queries": [query], "k": 2,
                                     "rerank_k": 4}, expect=400)
        assert "--passages" in err["error"]


def test_cli_serve_rejects_rerank_without_reranker():
    """A daemon without --reranker refuses rerank_k and /rerank with the
    reference's messages."""
    from cldrd_tpu.cli import serve as j_serve
    from cldrd_tpu_torch.cli import serve as t_serve

    msgs = []
    for mod in (t_serve, j_serve):
        svc = mod.SearchService(tokenizer=None, encode_fn=None, index=None,
                                max_length=8, encode_batch=8, default_k=5,
                                dynamic_batching=False)
        with pytest.raises(ValueError, match="--reranker") as a:
            svc.search(["q"], 2, rerank_k=4)
        with pytest.raises(ValueError, match="--reranker") as b:
            svc.rerank("q", ["p"], 1)
        msgs.append((str(a.value), str(b.value)))
    assert msgs[0] == msgs[1]
