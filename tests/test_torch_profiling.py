"""The port's profiling module (``cldrd_tpu_torch/utils/profiling.py``)
held to ``cldrd_tpu/utils/profiling.py`` on the CPU: ``PhaseTimer`` and
``Throughput`` give the reference's reports and TSV on one fake clock;
``trace`` writes one Chrome-format trace holding ``annotate`` labels and
the ops run inside them; a second profiler session raises, as
``jax.profiler.start_trace`` does, and leaves the outer one running; and
``cli.retrieve --profile-dir`` traces the search phase alone and writes
the untraced run file byte for byte."""
import contextlib
import io
import os
import sys
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
