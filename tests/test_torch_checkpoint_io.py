"""Flax ``.msgpack`` checkpoints in the port (``train/msgpack_io.py``,
no ``msgpack``/``flax`` import there): the decoder against flax's own
reader on a hand-built blob of every type, bf16 and chunked leaves and
malformed input; a checkpoint the JAX ``Trainer`` wrote, read for
warm start, ``cli.index`` (embeddings within 1e-5 of the JAX CLI's, fp32),
``cli.serve`` and the cross-encoder loaders; and the port's BERT
checkpoints read by the JAX package."""
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from cldrd_tpu.models import BertConfig as JBertConfig
from cldrd_tpu.models import CrossEncoder as JCrossEncoder
from cldrd_tpu.models import DistilBertConfig as JConfig
from cldrd_tpu_torch.train import msgpack_io


def _same(a, b):
    """Trees equal: dict keys, list items, array dtype/shape/values (bf16
    leaves compare as float32), scalars."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys()
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(b, np.ndarray):
        want = b.astype(np.float32) if b.dtype.name == "bfloat16" else b
        assert isinstance(a, np.ndarray) and a.dtype == want.dtype
        np.testing.assert_array_equal(a, want)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _every_type():
    ext = serialization._msgpack_ext_pack
    return {
        "fixint": 7, "neg_fixint": -3, "u8": 200, "u16": 60000,
        "u32": 2**31, "u64": 2**63 + 5, "i8": -100, "i16": -30000,
        "i32": -2**31, "i64": -2**62, "f64": 1.0 / 3, "nil": None,
        "yes": True, "no": False, "fixstr": "héllo", "str8": "s" * 200,
        "str16": "t" * 70000, "bin8": b"\x00\x01\x02",
        "bin16": bytes(range(256)) * 2, "fixarray": [1, "a", None],
        "array16": list(range(20)), "map16": {f"k{i}": i for i in range(20)},
        "nd_f32": ext(np.arange(12, dtype=np.float32).reshape(3, 4)),
        "nd_i64": ext(np.array([[-1, 2**40]], np.int64)),
        "nd_u8_empty": ext(np.zeros((0, 3), np.uint8)),
        "nd_big": ext(np.arange(70000, dtype=np.int8)),
        "scalar_i32": ext(np.int32(-9)), "scalar_f64": ext(np.float64(2.5)),
        "complex": ext(1.5 - 2j),
    }


def test_decoder_reads_every_type():
    tree = _every_type()
    blob = msgpack.packb(tree, use_bin_type=True)
    blob32 = msgpack.packb({"f32": 0.25, "str32": "u" * 70000,
                            "bin32": b"x" * 70000}, use_single_float=True,
                           use_bin_type=True)
    for b in (blob, blob32):
        _same(msgpack_io.msgpack_restore(b), serialization.msgpack_restore(b))


def test_decoder_reads_bf16_leaves_exactly():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(5, 7)) * 100,
                    jnp.bfloat16)
    blob = serialization.msgpack_serialize({"w": x, "b": {"c": x[0]}})
    out = msgpack_io.msgpack_restore(blob)
    assert out["w"].dtype == np.float32
    np.testing.assert_array_equal(out["w"], np.asarray(x, np.float32))
    np.testing.assert_array_equal(out["b"]["c"], np.asarray(x[0], np.float32))


def test_decoder_joins_chunked_leaves(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(10, 10),
            "nested": {"also": np.arange(33, dtype=np.int64)},
            "small": np.ones(3, np.float32)}
    blob = serialization.msgpack_serialize(tree)
    raw = msgpack.unpackb(blob, raw=False, strict_map_key=False)
    assert "__msgpack_chunked_array__" in raw["big"]
    assert len(raw["big"]["chunks"]) == 7
    _same(msgpack_io.msgpack_restore(blob), serialization.msgpack_restore(blob))


@pytest.mark.parametrize("blob, match", [
    (b"\x92\x01", "truncated"), (b"\x01\x02", "trailing"),
    (b"\xc1", "unknown type"), (b"\xd4\x05\x00", "unknown ext")])
def test_decoder_rejects_malformed_input(blob, match):
    with pytest.raises(ValueError, match=match):
        msgpack_io.msgpack_restore(blob)


# ------------------------------------------------- a JAX Trainer's file


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two JAX-trained steps (tiny, fp32) and their msgpack checkpoint."""
    from cldrd_tpu.cli import train as j_train

    tmp = tmp_path_factory.mktemp("jax_ckpt")
    rng = np.random.default_rng(0)
    queries = "".join(f"{q}\tfind subject{q} info\n" for q in range(16))
    passages, lines = [], []
    for q in range(16):
        passages.append(f"{q * 6}\tdocument with subject{q} info inside\n")
        for j in range(1, 6):
            passages.append(f"{q * 6 + j}\tnoise {rng.integers(10**6)}\n")
        lines.append(json.dumps({
            "qid": q, "relT_pids": [q * 6],
            "most_hard_pids": [q * 6 + 1, q * 6 + 2, q * 6 + 3],
            "semi_hard_pids": [q * 6 + 4, q * 6 + 5]}) + "\n")
    paths = {"queries": tmp / "q.tsv", "passages": tmp / "c.tsv",
             "train": tmp / "t.jsonl"}
    paths["queries"].write_text(queries)
    paths["passages"].write_text("".join(passages))
    paths["train"].write_text("".join(lines))
    paths = {k: str(v) for k, v in paths.items()}
    with contextlib.redirect_stdout(io.StringIO()):
        assert j_train.main([
            "--queries-path", paths["queries"], "--passages-path",
            paths["passages"], "--training-path", paths["train"],
            "--label-mode", "1", "--model-size", "tiny", "--tokenizer",
            "hash", "--batch-size", "8", "--num-train-epochs", "1",
            "--learning-rate", "2e-3", "--warmup-steps", "1",
            "--max-query-len", "12", "--max-passage-len", "16",
            "--compute-dtype", "float32", "--run-folder", str(tmp / "runs"),
            "--experiment-name", "it1", "--logging-steps", "1",
            "--evaluate-steps", "100"]) == 0
    folder = tmp / "runs" / "it1"
    ckpts = sorted(p for p in os.listdir(folder) if p.endswith(".msgpack"))
    paths["ckpt"] = str(folder / ckpts[-1])
    paths["tmp"] = tmp
    return paths


def test_reads_a_jax_trainer_checkpoint(jax_run):
    blob = open(jax_run["ckpt"], "rb").read()
    ours = msgpack_io.load_flax_checkpoint(jax_run["ckpt"])
    _same(ours, serialization.msgpack_restore(blob))
    assert {"params", "opt_state", "step"} <= set(ours)
    assert int(ours["step"]) == 2
    assert msgpack_io.flax_params(ours) is ours["params"]
    assert msgpack_io.flax_params(ours["params"]) is ours["params"]


def test_warm_start_from_a_jax_checkpoint(jax_run):
    from cldrd_tpu.models import NwayDualEncoder as JDualEncoder
    from cldrd_tpu.train.checkpoint import load_warm_start_params as j_warm
    from cldrd_tpu_torch.models.convert import params_from_flax
    from cldrd_tpu_torch.train import load_warm_start_params

    ids = jnp.ones((1, 8), jnp.int32)
    target = JDualEncoder(JConfig.tiny()).init(
        jax.random.PRNGKey(0), {"input_ids": ids, "attention_mask": ids},
        {"input_ids": ids[:, None], "attention_mask": ids[:, None]}
    )["params"]
    want = params_from_flax(jax.tree_util.tree_map(
        np.asarray, j_warm(jax_run["ckpt"], target)))
    got = load_warm_start_params(jax_run["ckpt"])
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_index_and_serve_from_a_jax_checkpoint(jax_run, tmp_path):
    """cli.index over the JAX checkpoint: the stored embeddings within
    1e-5 of the largest of the JAX CLI's (fp32); cli.serve loads it and
    answers as its index does."""
    from cldrd_tpu.cli import index as j_index
    from cldrd_tpu.index.persistence import read_embeddings as j_read
    from cldrd_tpu_torch.cli import index as t_index
    from cldrd_tpu_torch.cli import serve as t_serve
    from cldrd_tpu_torch.index.persistence import read_embeddings

    argv = ["--collection", jax_run["passages"], "--checkpoint",
            jax_run["ckpt"], "--model-size", "tiny", "--max-length", "16",
            "--batch-size", "32", "--compute-dtype", "float32"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert t_index.main([*argv, "--out", str(tmp_path / "t"),
                             "--device", "cpu"]) == 0
        assert j_index.main([*argv, "--out", str(tmp_path / "j")]) == 0
    ours, ids = read_embeddings(str(tmp_path / "t"))
    ref, jids = j_read(str(tmp_path / "j"))
    np.testing.assert_array_equal(ids, jids)
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    svc = t_serve.make_service(t_serve.build_parser().parse_args([
        "--index", str(tmp_path / "t"), "--checkpoint", jax_run["ckpt"],
        "--model-size", "tiny", "--device", "cpu", "--topk", "5",
        "--max-length", "12", "--passage-max-length", "16",
        "--no-dynamic-batching",
        "--passages", jax_run["passages"], "--reranker", "bert",
        "--reranker-size", "tiny", "--rerank-max-length", "32"]))
    hits = svc.search(["find subject3 info"], 5, rerank_k=5)[0]
    assert len(hits) == 5 and all("retrieval_score" in h for h in hits)
    svc.close()


@pytest.mark.parametrize("arch", ["distilbert", "bert"])
def test_cross_encoder_from_msgpack(tmp_path, arch):
    """--teacher-checkpoint / --reranker-checkpoint: a JAX CrossEncoder's
    params in a .msgpack give the JAX scores (fp32, 1e-5)."""
    from cldrd_tpu_torch.cli.common import (
        cross_encoder_config,
        load_cross_encoder,
    )

    jcfg = JBertConfig.tiny() if arch == "bert" else JConfig.tiny()
    pairs = {"input_ids": jnp.asarray(np.random.default_rng(1).integers(
        3, 512, (4, 20)), jnp.int32), "attention_mask": jnp.ones(
        (4, 20), jnp.int32)}
    model = JCrossEncoder(config=jcfg, arch=arch, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(2), pairs)["params"]
    path = str(tmp_path / "teacher.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize({"params": params}))
    ours = load_cross_encoder(path, cross_encoder_config(arch, "tiny"), arch,
                              torch.float32, "cpu")
    with torch.no_grad():
        got = ours({k: torch.from_numpy(np.array(v)).long()
                    for k, v in pairs.items()}).numpy()
    want = np.asarray(model.apply({"params": params}, pairs))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_port_bert_checkpoint_reads_in_jax(jax_run, tmp_path):
    """The port's trainer writes BERT towers in HF BertModel names, so the
    JAX package reads its .pth.tar and encodes as the port does (fp32,
    1e-5)."""
    from cldrd_tpu.cli.common import load_dual_encoder_params
    from cldrd_tpu.models import NwayDualEncoder as JDualEncoder
    from cldrd_tpu_torch.cli import train as t_train
    from cldrd_tpu_torch.cli.common import load_dual_encoder
    from cldrd_tpu_torch.models import BertConfig

    with contextlib.redirect_stdout(io.StringIO()):
        assert t_train.main([
            "--queries-path", jax_run["queries"], "--passages-path",
            jax_run["passages"], "--training-path", jax_run["train"],
            "--label-mode", "1", "--arch", "bert", "--model-size", "tiny",
            "--batch-size", "8", "--num-train-epochs", "1",
            "--max-query-len", "12", "--max-passage-len", "16",
            "--compute-dtype", "float32", "--run-folder", str(tmp_path),
            "--experiment-name", "b", "--evaluate-steps", "100",
            "--device", "cpu"]) == 0
    ckpt = str(tmp_path / "b" / "checkpoint_2.pth.tar")
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    assert any(".attention.self.query." in k for k in sd)
    ours = load_dual_encoder(ckpt, BertConfig.tiny(), False, False,
                             torch.float32, "cpu")
    jmodel = JDualEncoder(config=JBertConfig.tiny(), dtype=jnp.float32)
    jparams = load_dual_encoder_params(ckpt, jmodel, JBertConfig.tiny(),
                                       False)
    ids = np.random.default_rng(3).integers(3, 512, (3, 12))
    tokens = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
    with torch.no_grad():
        got = ours.passage_embs({k: torch.from_numpy(v).long()
                                 for k, v in tokens.items()}).numpy()
    want = np.asarray(jmodel.apply(
        {"params": jparams}, {k: jnp.asarray(v) for k, v in tokens.items()},
        method=jmodel.passage_embs))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_resume_from_a_jax_trainer_checkpoint(tmp_path):
    """The port's Trainer resumes from the JAX Trainer's step-2
    .msgpack (params, AdamW moments, schedule) and takes steps 3-4 with
    the JAX run's losses (rtol 1e-4) to its final params (relative norm
    of the difference < 1e-4); fp32, dropout 0."""
    from cldrd_tpu.data.nway_dataset import NwayDataset as JDataset
    from cldrd_tpu.data.tokenization import HashTokenizer as JTokenizer
    from cldrd_tpu.parallel import make_mesh
    from cldrd_tpu.train import TrainConfig as JTrainConfig
    from cldrd_tpu.train import Trainer as JTrainer
    from cldrd_tpu_torch.data import HashTokenizer, NwayDataset
    from cldrd_tpu_torch.models import DistilBertConfig
    from cldrd_tpu_torch.models.convert import params_from_flax
    from cldrd_tpu_torch.train import TrainConfig, Trainer

    def dataset(cls, tok_cls):
        queries = {q: f"query about topic {q}" for q in range(16)}
        passages, examples = {}, []
        for q in range(16):
            passages[q * 6] = f"passage answering topic {q}"
            for j in range(1, 6):
                passages[q * 6 + j] = f"filler text {q * 6 + j} banana {j}"
            examples.append({"qid": q, "relT_pids": [q * 6],
                             "neg_pids": [q * 6 + j for j in range(1, 6)]})
        return cls(queries, passages, examples, tok_cls(vocab_size=512),
                   max_query_len=12, max_passage_len=16, label_mode="1")

    kw = dict(label_mode="1", batch_size=8, num_train_epochs=2,
              learning_rate=1e-4, warmup_steps=1, logging_steps=1,
              evaluate_steps=2, max_query_len=12, max_passage_len=16,
              compute_dtype="float32", seed=0, run_folder=str(tmp_path),
              pack_passages=False, experiment_name="jax")
    jt = JTrainer(JTrainConfig(**kw),
                  JConfig.tiny(dropout=0.0, attention_dropout=0.0),
                  mesh=make_mesh(1))
    losses = []
    final = jt.train(dataset(JDataset, JTokenizer),
                     step_hook=lambda s, m: losses.append(m["loss"]))
    final = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                    final.params))
    ckpt = str(tmp_path / "jax" / "checkpoint_2.msgpack")
    kw.update(experiment_name="port", resume=ckpt, evaluate_steps=100)
    tt = Trainer(TrainConfig(**kw),
                 DistilBertConfig.tiny(dropout=0.0, attention_dropout=0.0),
                 device="cpu")
    seen = []
    state = tt.train(dataset(NwayDataset, HashTokenizer),
                     step_hook=lambda s, m: seen.append((s, m["loss"])))
    assert [s for s, _ in seen] == [3, 4] and state.step == 4
    np.testing.assert_allclose([x for _, x in seen], losses[2:], rtol=1e-4)
    diff = sum(float(((state.params[k] - v) ** 2).sum())
               for k, v in final.items())
    norm = sum(float((v ** 2).sum()) for v in final.values())
    assert np.sqrt(diff / norm) < 1e-4
