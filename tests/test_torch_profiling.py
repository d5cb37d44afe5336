"""The port's profiling module (``cldrd_tpu_torch/utils/profiling.py``)
held to ``cldrd_tpu/utils/profiling.py`` on the CPU: ``PhaseTimer`` and
``Throughput`` give the reference's reports and TSV on one fake clock;
``trace`` writes one Chrome-format trace holding ``annotate`` labels and
the ops run inside them; a second profiler session raises, as
``jax.profiler.start_trace`` does, and leaves the outer one running; and
``cli.retrieve --profile-dir`` traces the search phase alone and writes
the untraced run file byte for byte. The port's spans: off, ``annotate``
is one shared no-op; a ``collect`` collector counts them from every
thread; under ``trace`` the Trainer, the encode and search and the
teacher write their ``cldrd.*`` ranges in order and nesting; and a
collector leaves a training run's parameters bit for bit."""
import contextlib
import io
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cldrd_tpu.utils as j_utils
import cldrd_tpu_torch.utils as t_utils
from cldrd_tpu.utils import profiling as j_prof
from cldrd_tpu_torch.cli import index as t_index
from cldrd_tpu_torch.cli import retrieve as t_retrieve
from cldrd_tpu_torch.data import (
    HashTokenizer,
    NwayDataset,
    SequenceDataset,
    prefetch,
)
from cldrd_tpu_torch.data.teacher import rerank_candidates_with_teacher
from cldrd_tpu_torch.index import FlatIPIndex, encode_dataset, make_encode_fn
from cldrd_tpu_torch.models import DistilBertConfig, NwayDualEncoder
from cldrd_tpu_torch.train import TrainConfig, Trainer
from cldrd_tpu_torch.utils import profiling as t_prof

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_pipeline import _checkpoint, _corpus  # noqa: E402

# irregular steps, so rounding to 4 (seconds) and 2 (rates) decimals bites
_TICKS = np.cumsum(np.random.default_rng(0).uniform(1e-5, 0.7, 64))


class _Clock:
    def __init__(self):
        self.i = 0

    def __call__(self):
        self.i += 1
        return float(_TICKS[self.i - 1])


def _phases(mod):
    timer = mod.PhaseTimer()
    for name in ("encode", "search", "encode", "merge", "search"):
        with timer.phase(name):
            pass
    with pytest.raises(ValueError):
        with timer.phase("write"):  # a phase that raises still counts
            raise ValueError
    return timer.report(), timer.to_tsv()


def _throughput(mod):
    meter = mod.Throughput()
    meter.update(512)
    meter.update(7)
    first = (meter.report(unit="queries"), meter.items)
    meter.reset()
    meter.update(3)
    return first, meter.report(), meter.per_second


def test_phase_timer_and_throughput_equal_the_reference(monkeypatch):
    got = {}
    for name, mod in (("jax", j_prof), ("torch", t_prof)):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=_Clock()))
        got[name] = (_phases(mod), _throughput(mod))
    assert got["torch"] == got["jax"]
    (report, tsv), ((queries, items), default, _) = got["torch"]
    assert list(report) == ["encode_s", "search_s", "merge_s", "write_s",
                            "total_s"]
    assert tsv.splitlines()[0].split("\t") == list(report)
    assert list(queries) == ["queries", "elapsed_s", "queries_per_s"]
    assert items == 519 and default["items"] == 3


def test_utils_export_the_reference_names():
    assert t_utils.__all__ == j_utils.__all__
    for name in t_utils.__all__:
        assert getattr(t_utils, name) is not None


def _ops(events, cat=("cpu_op",)):
    return [e for e in events if e.get("cat") in cat]


def test_trace_writes_one_loadable_trace_with_labels(tmp_path):
    logdir = str(tmp_path / "new" / "logdir")
    a = torch.randn(16, 16)
    with t_prof.trace(logdir):
        with t_prof.annotate("score_block"):
            a @ a
    assert len(os.listdir(logdir)) == 1
    assert os.listdir(logdir)[0].endswith(".pt.trace.json")
    events = t_prof.read_trace(logdir)
    label, = [e for e in _ops(events, ("user_annotation",))
              if e["name"] == "score_block"]
    mm = [e for e in _ops(events) if e["name"] == "aten::mm"]
    assert len(mm) == 1
    assert label["ts"] <= mm[0]["ts"]
    assert mm[0]["ts"] + mm[0]["dur"] <= label["ts"] + label["dur"]
    assert not torch.autograd._profiler_enabled()


def test_trace_refuses_a_second_session_and_keeps_the_first(tmp_path):
    outer_dir = str(tmp_path / "outer")
    x = torch.randn(8)
    with t_prof.trace(outer_dir):
        with pytest.raises(RuntimeError, match="Only one profile"):
            with t_prof.trace(str(tmp_path / "inner")):
                pass
        assert torch.autograd._profiler_enabled()
        x.sin()  # after the refused call: must still be recorded
    assert not os.path.exists(tmp_path / "inner")
    assert [e for e in _ops(t_prof.read_trace(outer_dir))
            if e["name"] == "aten::sin"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError, match="Only one profile"):
            with t_prof.trace(str(tmp_path / "inside_plain")):
                pass
        x.cos()
    assert "aten::cos" in {e.key for e in prof.key_averages()}
    assert not os.path.exists(tmp_path / "inside_plain")
    # the reference refuses a nested trace with the same words
    with j_prof.trace(str(tmp_path / "jax_outer")):
        with pytest.raises(RuntimeError, match="Only one profile"):
            with j_prof.trace(str(tmp_path / "jax_inner")):
                pass


def test_trace_stops_on_an_exception(tmp_path):
    with pytest.raises(KeyError):
        with t_prof.trace(str(tmp_path)):
            torch.ones(4).sum()
            raise KeyError("inside the window")
    assert not torch.autograd._profiler_enabled()
    assert [e for e in _ops(t_prof.read_trace(str(tmp_path)))
            if e["name"] == "aten::sum"]


def test_read_trace_wants_exactly_one_trace(tmp_path):
    with pytest.raises(ValueError, match="0 traces"):
        t_prof.read_trace(str(tmp_path))
    for _ in range(2):
        with t_prof.trace(str(tmp_path)):
            pass
    with pytest.raises(ValueError, match="2 traces"):
        t_prof.read_trace(str(tmp_path))


def test_cli_retrieve_profile_dir(tmp_path, monkeypatch):
    """tests/test_cli.py::test_cli_retrieve_profile_dir through the port:
    the trace holds the search and not the query encode (no embedding
    op), and the run file is the untraced one's, byte for byte."""
    f = _corpus(tmp_path)
    ckpt = str(tmp_path / "checkpoint_1.pth.tar")
    _checkpoint(ckpt)
    common = ["--checkpoint", ckpt, "--model-size", "tiny", "--tokenizer",
              "hash", "--device", "cpu"]
    idx = str(tmp_path / "prof_idx")
    assert t_index.main(["--collection", f["passages"], "--out", idx,
                         "--max-length", "16", "--batch-size", "32",
                         *common]) == 0
    argv = ["--index", idx, "--queries", f["queries"], "--max-length", "12",
            "--topk", "5", "--encode-batch-size", "32",
            "--search-batch-size", "8", *common]
    plain, traced = str(tmp_path / "p.run.tsv"), str(tmp_path / "t.run.tsv")

    def no_trace(logdir):
        raise AssertionError("traced without --profile-dir")

    with monkeypatch.context() as m:
        m.setattr(t_retrieve, "trace", no_trace)
        with contextlib.redirect_stdout(io.StringIO()):
            assert t_retrieve.main([*argv, "--run", plain]) == 0
    prof = str(tmp_path / "trace")
    with contextlib.redirect_stdout(io.StringIO()):
        assert t_retrieve.main([*argv, "--run", traced,
                                "--profile-dir", prof]) == 0
    assert not torch.autograd._profiler_enabled()
    with open(plain, "rb") as a, open(traced, "rb") as b:
        assert a.read() == b.read()
    names = {e["name"] for e in _ops(t_prof.read_trace(prof))}
    assert "aten::embedding" not in names  # the encode is outside
    assert "aten::mm" in names or "aten::matmul" in names  # the search


# ------------------------------------------------------------ the spans


def test_annotate_off_is_one_shared_noop(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) with no session")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not torch.autograd._profiler_enabled()
    off = t_prof.annotate("cldrd.data.wait")
    assert off is t_prof.annotate("cldrd.train.h2d")
    with off:
        with t_prof.annotate("cldrd.train.h2d"):
            pass
    # a collector takes spans without opening a range either
    timer = t_prof.PhaseTimer()
    with t_prof.collect(timer) as got:
        assert got is timer
        for _ in range(3):
            with t_prof.annotate("cldrd.train.h2d"):
                pass
    assert timer.counts() == {"cldrd.train.h2d": 3}
    assert t_prof.annotate("cldrd.train.h2d") is off  # removed again


def test_phase_timer_counts_calls_and_keeps_its_report():
    timer = t_prof.PhaseTimer()
    timer.add("encode", 0.25)
    with timer.phase("search"):
        pass
    timer.add("encode", 0.5)
    assert timer.counts() == {"encode": 2, "search": 1}
    assert list(timer.totals()) == ["encode", "search"]
    assert timer.totals()["encode"] == 0.75
    assert list(timer.report()) == ["encode_s", "search_s", "total_s"]


def test_collector_takes_spans_from_every_thread():
    """The main thread and a ``prefetch`` producer thread feed one
    collector, and two threads using one name count exactly."""

    def made(n):
        for i in range(n):
            with t_prof.annotate("cldrd.data.batch"):
                item = i
            yield item

    timer = t_prof.PhaseTimer()
    with t_prof.collect(timer):
        assert list(prefetch(made(7), depth=2)) == list(range(7))
        with t_prof.annotate("cldrd.data.batch"):
            pass

        def many():
            for _ in range(2000):
                with t_prof.annotate("cldrd.x"):
                    pass

        # more threads than cores, switching often: a lost update shows
        threads = [threading.Thread(target=many)
                   for _ in range((os.cpu_count() or 1) + 2)]
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(switch)
        assert not any(t.is_alive() for t in threads)
    counts = timer.counts()
    assert counts["cldrd.data.batch"] == 8  # 7 produced + 1 on main
    assert counts["cldrd.data.wait"] == 8  # 7 items + the end
    assert counts["cldrd.x"] == 2000 * len(threads)
    assert all(v >= 0 for v in timer.totals().values())


def test_a_slow_producer_shows_as_data_wait():
    """A sleep planted in the ``prefetch`` producer lands in the
    consumer's ``cldrd.data.wait``, not elsewhere."""

    def waits(pause):
        def made():
            for i in range(5):
                time.sleep(pause)
                yield i

        timer = t_prof.PhaseTimer()
        with t_prof.collect(timer):
            assert list(prefetch(made(), depth=2)) == list(range(5))
        return timer.totals()["cldrd.data.wait"]

    assert waits(0.04) >= 0.15 > waits(0.0)


def _cldrd_ranges(events):
    """(name, start, end) of the ``cldrd.`` ranges, by start."""
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"])
                   for e in _ops(events, ("user_annotation",))
                   if e["name"].startswith("cldrd.")),
                  key=lambda r: (r[1], -r[2]))


def _tree(ranges):
    """Each range's name and its innermost enclosing range's name."""
    out = []
    for i, (name, a, b) in enumerate(ranges):
        parents = [r for r in ranges[:i] if r[1] <= a and b <= r[2]]
        out.append((name, parents[-1][0] if parents else None))
    return out


def _nway(n=4):
    queries = {q: f"query about topic {q}" for q in range(n)}
    passages, examples = {}, []
    for q in range(n):
        pids = list(range(6 * q, 6 * q + 6))
        for p in pids:
            passages[p] = f"passage {p} about topic {q} " + "x " * (p % 4)
        examples.append({"qid": q, "relT_pids": pids[:1],
                         "neg_pids": pids[1:]})
    return NwayDataset(queries, passages, examples,
                       HashTokenizer(vocab_size=512), max_query_len=8,
                       max_passage_len=12, label_mode="1")


def _trainer(tmp_path, name):
    cfg = TrainConfig(label_mode="1", batch_size=2, num_train_epochs=1,
                      learning_rate=1e-3, warmup_steps=1, logging_steps=1,
                      evaluate_steps=100, max_query_len=8,
                      max_passage_len=12, compute_dtype="float32", seed=3,
                      run_folder=str(tmp_path), experiment_name=name,
                      pack_passages=False)
    return Trainer(cfg, DistilBertConfig.tiny(), device="cpu")


def test_train_spans_in_the_trace(tmp_path):
    trainer = _trainer(tmp_path, "traced")
    logdir = str(tmp_path / "trace")
    with t_prof.trace(logdir):
        assert trainer.train(_nway()).step == 2
    step = ["cldrd.data.wait", "cldrd.train.h2d", "cldrd.train.forward",
            "cldrd.train.backward", "cldrd.train.optimizer",
            "cldrd.train.flush"]
    tree = _tree(_cldrd_ranges(t_prof.read_trace(logdir)))
    assert [n for n, _ in tree] == step * 2 + ["cldrd.data.wait",
                                               "cldrd.train.checkpoint"]
    assert all(parent is None for _, parent in tree)


def test_encode_and_search_spans_in_the_trace(tmp_path, monkeypatch):
    """``encode_dataset`` then ``search_batched`` with every query's
    certificate failed, so each resolve holds a rescue."""
    torch.manual_seed(0)
    model = NwayDualEncoder(DistilBertConfig.tiny())
    texts = {i: f"query number {i} " + "y " * (i % 5) for i in range(40)}
    dataset = SequenceDataset(texts, HashTokenizer(vocab_size=512), 10,
                              is_query=True)
    rng = np.random.default_rng(0)
    index = FlatIPIndex.build(rng.standard_normal((4096, 32), np.float32),
                              np.arange(4096), dtype=torch.float32,
                              device="cpu")
    orig = FlatIPIndex._search_device

    def missed(self, q, k):
        s, i, positions, ok = orig(self, q, k)
        return s, i, positions, torch.zeros_like(ok)

    monkeypatch.setattr(FlatIPIndex, "_search_device", missed)
    logdir = str(tmp_path / "trace")
    with t_prof.trace(logdir):
        q, _ = encode_dataset(make_encode_fn(model, "query_embs"), dataset,
                              16)
        index.search_batched(q, 10, batch_size=128)
    assert index.rescued_queries == 40
    tree = _tree(_cldrd_ranges(t_prof.read_trace(logdir)))
    wait, encode = ("cldrd.data.wait", None), ("cldrd.index.encode", None)
    # batches are made on the producer thread: not in the trace
    assert tree == [wait, encode] * 3 + [wait] + [
        ("cldrd.index.fetch", None)] * 3 + [
        ("cldrd.search.dispatch", None), ("cldrd.search.resolve", None),
        ("cldrd.search.rescue", "cldrd.search.resolve")]


def test_teacher_spans_in_the_trace(tmp_path):
    queries = {q: f"query {q}" for q in range(3)}
    passages = {p: f"passage {p} " + "z " * (p % 3) for p in range(12)}
    lists = {q: list(range(4 * q, 4 * q + 4)) for q in range(3)}

    def score_fn(batch):
        ids = torch.from_numpy(batch.query_passage["input_ids"])
        return ids.float().sin().sum(1).numpy()

    logdir = str(tmp_path / "trace")
    with t_prof.trace(logdir):
        out = rerank_candidates_with_teacher(
            lists, score_fn, queries, passages,
            HashTokenizer(vocab_size=512), max_len=16, batch_size=5)
    assert sorted(out) == [0, 1, 2]
    tree = _tree(_cldrd_ranges(t_prof.read_trace(logdir)))
    one = [("cldrd.data.wait", None), ("cldrd.data.batch", "cldrd.data.wait"),
           ("cldrd.teacher.score", None), ("cldrd.teacher.collect", None)]
    assert tree == one * 3 + [("cldrd.data.wait", None),
                              ("cldrd.teacher.collect", None)]


def test_collector_leaves_training_bit_for_bit(tmp_path):
    off = _trainer(tmp_path / "off", "off").train(_nway())
    timer = t_prof.PhaseTimer()
    with t_prof.collect(timer):
        on = _trainer(tmp_path / "on", "on").train(_nway())
    assert on.step == off.step == 2
    assert off.params.keys() == on.params.keys()
    for k, v in off.params.items():
        assert torch.equal(v, on.params[k]), k
    counts = timer.counts()
    for name in ("cldrd.train.h2d", "cldrd.train.forward",
                 "cldrd.train.backward", "cldrd.train.optimizer",
                 "cldrd.train.flush"):
        assert counts[name] == 2, name
    assert counts["cldrd.data.batch"] == 2  # on the producer thread
    assert counts["cldrd.data.wait"] == 3
    assert counts["cldrd.train.checkpoint"] == 1
