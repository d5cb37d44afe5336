"""The retrieval path end to end through both packages' CLIs: one shared
``.pth.tar`` checkpoint, then index -> retrieve -> evaluate with the JAX
CLIs and with the port's CLIs (``--device cpu``), on the corpus of
tests/test_cli.py. Run files must agree in (qid, pid, rank) with scores
within rtol=1e-5 (scores print as ``float()`` reprs, so ulp-level
reduction-order differences forbid byte equality), and the metric dicts
must be equal."""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cldrd_tpu.cli import evaluate as j_evaluate
from cldrd_tpu.cli import index as j_index
from cldrd_tpu.cli import retrieve as j_retrieve
from cldrd_tpu.models import DistilBertConfig as JaxConfig
from cldrd_tpu.models import NwayDualEncoder as JaxDualEncoder
from cldrd_tpu.models.hf_loader import dual_encoder_flax_to_torch
from cldrd_tpu.search import mips as jmips
from cldrd_tpu_torch.cli import evaluate as t_evaluate
from cldrd_tpu_torch.cli import index as t_index
from cldrd_tpu_torch.cli import retrieve as t_retrieve


def _corpus(tmp):
    """16 queries; each query's relevant passage shares its wording
    (tests/test_cli.py::corpus_files)."""
    rng = np.random.default_rng(0)
    queries, passages, qrels = [], [], []
    pid = 0
    for q in range(16):
        queries.append(f"{q}\tfind subject{q} info\n")
        rel = pid
        passages.append(f"{pid}\tdocument with subject{q} info inside\n")
        pid += 1
        for _ in range(5):
            passages.append(f"{pid}\tnoise {rng.integers(10**6)} text "
                            f"{rng.integers(10**6)}\n")
            pid += 1
        qrels.append(f"{q}\t0\t{rel}\t1\n")
    paths = {name: str(tmp / f"{name}.tsv")
             for name in ("queries", "passages", "qrels")}
    for name, lines in (("queries", queries), ("passages", passages),
                        ("qrels", qrels)):
        with open(paths[name], "w") as f:
            f.write("".join(lines))
    return paths


def _checkpoint(path):
    model = JaxDualEncoder(config=JaxConfig.tiny())
    dq = {"input_ids": jnp.zeros((1, 8), jnp.int32),
          "attention_mask": jnp.ones((1, 8), jnp.int32)}
    dp = {"input_ids": jnp.zeros((1, 1, 8), jnp.int32),
          "attention_mask": jnp.ones((1, 1, 8), jnp.int32)}
    params = model.init(jax.random.PRNGKey(11), dq, dp)["params"]
    sd = dual_encoder_flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                           params))
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, path)


def _run_rows(path):
    rows = [line.split("\t") for line in open(path).read().splitlines()]
    return ([(int(q), int(p), int(r)) for q, p, r, _ in rows],
            np.array([float(s) for *_, s in rows]))


def _metrics(evaluate_main, qrels, run):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert evaluate_main(["--qrels", qrels, "--run", run]) == 0
    return json.loads(buf.getvalue())


def test_cli_pipeline_matches_jax(tmp_path, monkeypatch):
    # the JAX side takes its extract route too (interpret mode), so both
    # packages route the search the same way
    monkeypatch.setattr(jmips, "_INTERPRET", True)
    f = _corpus(tmp_path)
    ckpt = str(tmp_path / "checkpoint_1.pth.tar")
    _checkpoint(ckpt)
    common = ["--checkpoint", ckpt, "--model-size", "tiny",
              "--tokenizer", "hash", "--compute-dtype", "float32"]
    runs = {}
    for name, index_cli, retrieve_cli, extra in (
            ("jax", j_index, j_retrieve, []),
            ("torch", t_index, t_retrieve, ["--device", "cpu"])):
        idx = str(tmp_path / f"index_{name}")
        assert index_cli.main(["--collection", f["passages"], "--out", idx,
                               "--max-length", "16", "--batch-size", "32",
                               *common, *extra]) == 0
        runs[name] = str(tmp_path / f"{name}.run.tsv")
        with contextlib.redirect_stdout(io.StringIO()):
            assert retrieve_cli.main([
                "--index", idx, "--queries", f["queries"],
                "--run", runs[name], "--max-length", "12", "--topk", "20",
                "--hbm-dtype", "float32", "--encode-batch-size", "32",
                "--search-batch-size", "8", *common, *extra]) == 0
    j_rows, j_scores = _run_rows(runs["jax"])
    t_rows, t_scores = _run_rows(runs["torch"])
    assert len(t_rows) == 16 * 20
    assert t_rows == j_rows
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-5)
    jm = _metrics(j_evaluate.main, f["qrels"], runs["jax"])
    tm = _metrics(t_evaluate.main, f["qrels"], runs["torch"])
    assert tm == jm
    assert {"MRR@10", "Recall@1000", "nDCG@10", "MAP@1000"} <= set(tm)


def test_tokenizer_and_dataset_batches_match_reference(tmp_path):
    """The port's copies of HashTokenizer, the TSV loaders and
    SequenceDataset give the reference's batches id for id."""
    from cldrd_tpu.data.sequence_dataset import SequenceDataset as JaxDataset
    from cldrd_tpu.data.tokenization import HashTokenizer as JaxTokenizer
    from cldrd_tpu_torch.data import HashTokenizer, SequenceDataset

    path = tmp_path / "collection.tsv"
    path.write_text("7\tThe quick  brown fox\n3\tTitle\tpara with words\n"
                    "11\t" + " ".join(f"tok{i}" for i in range(40)) + "\n")
    ours = SequenceDataset.create_from_seqs_file(
        str(path), HashTokenizer(vocab_size=512), 16, is_query=False)
    ref = JaxDataset.create_from_seqs_file(
        str(path), JaxTokenizer(vocab_size=512), 16, is_query=False)
    assert ours.pairs == ref.pairs
    for a, b in zip(ours.batches(2), ref.batches(2)):
        assert a.n_valid == b.n_valid
        np.testing.assert_array_equal(a.ids, b.ids)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(a.tokens[key], b.tokens[key])
    texts, pairs = ["a b c", "Hello World"], ["x y", "z"]
    np.testing.assert_array_equal(
        HashTokenizer()(texts, 8, pairs, True)["token_type_ids"],
        JaxTokenizer()(texts, 8, pairs, True)["token_type_ids"])


def test_cli_rejects_flags_of_later_slices():
    # --attention-impl came back with the training slice (K5 encodes)
    args = t_retrieve.build_parser().parse_args(
        ["--index", "i", "--queries", "q", "--run", "r",
         "--attention-impl", "pallas"])
    assert args.attention_impl == "pallas"
    for argv in (["--shards", "2"], ["--dropout", "0.1"],
                 ["--profile-dir", "x"], ["--arch", "bert"]):
        with pytest.raises(SystemExit):
            t_retrieve.build_parser().parse_args(
                ["--index", "i", "--queries", "q", "--run", "r", *argv])
    for argv in (["--ivf-nlist", "8"], ["--devices", "2"],
                 ["--token-cache", "c"], ["--bucket-lengths", "32"]):
        with pytest.raises(SystemExit):
            t_index.build_parser().parse_args(
                ["--collection", "c", "--out", "o", *argv])
