"""The port's own ranges (``cldrd.*``, ``utils.profiling.annotate``) in a
trace move no reading of the benchmark: a trace with the program's
ranges and the same trace without them give the same device operations,
each tied to the same harness span, the same busy time, the same device
operations in ``breakdown()`` and the same value from every per-layer
reader. What the ranges add: the device milliseconds by program range,
and idle gaps named ``<harness span or ->: <program span>``; without
them the gaps read as before. Checked on synthetic events with device
operations and on a real traced run of the tiny cells on the CPU, whose
trace holds the program's ranges. Every reader reads nothing from
nothing (``portbench/metrics/__init__.py``'s contract)."""
import math
import types

import pytest

from portbench import harness, tracing
from portbench.tests import tiny

THREAD, OTHER = 1, 2


def _x(cat, name, ts, dur, tid=THREAD, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(name, ts, corr, start, dur):
    """A kernel launched at ``ts`` that runs ``[start, start + dur)``."""
    return [_x("cuda_runtime", "cudaLaunchKernel", ts, 3, corr=corr),
            _x("kernel", name, start, dur, tid=7, corr=corr)]


def _harness_events():
    """One traced segment: an encode, a search and a score span, each with
    host operations and device work, and idle gaps between them."""
    ev = [_x("user_annotation", "portbench.traced", 0, 10_000),
          _x("user_annotation", "portbench.encode", 100, 2_000),
          _x("cpu_op", "aten::mm", 150, 40),
          _x("user_annotation", "portbench.search", 3_000, 3_000),
          _x("cpu_op", "aten::topk", 3_100, 50),
          _x("cpu_op", "aten::copy_", 5_000, 900),
          _x("user_annotation", "portbench.score", 7_000, 2_000),
          _x("cpu_op", "aten::addmm", 7_050, 30)]
    ev += _launch("gemm_bf16", 160, 1, 200, 1_500)
    ev += _launch("vectorized_elementwise_kernel", 180, 2, 1_700, 200)
    ev += _launch("extract_topk_sm90_kernel", 3_120, 3, 3_200, 1_500)
    ev += _launch("attn_infer_d32_kernel", 7_060, 4, 7_100, 400)
    ev += _launch("attn_fwd_sm90_kernel", 7_070, 5, 7_500, 100)
    ev += _launch("attn_bwd_sm90_kernel", 7_075, 6, 7_600, 100)
    ev.append(_x("gpu_memcpy", "Memcpy DtoH", 5_100, 700, tid=7, corr=8))
    ev.append(_x("cuda_runtime", "cudaMemcpyAsync", 5_050, 5, corr=8))
    return ev


def _program_events():
    """The port's ranges: on the dispatching thread, around the gaps and
    the launches, and on a producer thread of its own."""
    return [_x("user_annotation", "cldrd.index.encode", 120, 1_900),
            _x("user_annotation", "cldrd.data.wait", 2_200, 700),
            _x("user_annotation", "cldrd.search.dispatch", 3_050, 200),
            _x("user_annotation", "cldrd.search.resolve", 4_800, 1_150),
            _x("user_annotation", "cldrd.search.rescue", 4_900, 300),
            _x("user_annotation", "cldrd.teacher.score", 6_990, 2_010),
            _x("user_annotation", "cldrd.train.h2d", 9_100, 800),
            _x("user_annotation", "cldrd.data.batch", 2_000, 5_000,
               tid=OTHER)]


def _shapes():
    return {"search_batch": 512, "k": 1000, "rows": 8_847_360, "dim": 768,
            "search_batches": 1, "encode_batches": 1, "traced_units": 1,
            "batch_size": 128, "max_len": 256, "calls": 1, "keys": 7_936,
            "n_layers": 2, "n_heads": 12, "model_units": 1,
            "model_span": "score", "trace_steps": 1, "nway": 30, "lq": 30,
            "lp": 256}


# the collector's gathering over a window (host seconds, calls)
SPANS = {"totals": {"cldrd.data.wait": 0.012, "cldrd.train.h2d": 0.024,
                    "cldrd.train.forward": 0.03, "cldrd.train.backward":
                    0.027, "cldrd.train.optimizer": 0.031,
                    "cldrd.search.resolve": 0.084},
         "counts": {"cldrd.data.wait": 15, "cldrd.train.h2d": 1,
                    "cldrd.train.forward": 1, "cldrd.train.backward": 1,
                    "cldrd.train.optimizer": 1, "cldrd.search.resolve": 14}}
PER_LAYER = harness.load_json(harness.ROOT, "BENCHMARK.json")["per_layer"]


def _reader(name):
    return harness.load_module(harness.reader_path(name),
                               "spans_" + name.replace(".", "_"))


def _readings(trace):
    """Every per-layer metric of ``BENCHMARK.json`` read from ``trace``."""
    ctx = types.SimpleNamespace(
        trace=trace, shapes=_shapes(), complete=True,
        window={"units": 1, "seconds": 0.02, "flops": 1e12,
                "examples": 8}, spans=SPANS)
    return {m["name"]: _reader(m["name"]).read(ctx) for m in PER_LAYER}


def _same(a: tracing.Trace, b: tracing.Trace):
    assert a.ops == b.ops
    assert a.busy_s == b.busy_s and a.window_s == b.window_s
    assert a.all_busy_s() == b.all_busy_s()
    assert a.breakdown()["device_ops"] == b.breakdown()["device_ops"]
    assert a.by_span_ms() == b.by_span_ms()
    # the same idle seconds, however they are named
    assert math.isclose(sum(s for _, s in a.idle_gaps()),
                        sum(s for _, s in b.idle_gaps()))
    ra, rb = _readings(a), _readings(b)
    assert ra == rb
    return ra


def test_program_ranges_move_no_reading_on_synthetic_events():
    plain = tracing.parse(_harness_events(), 0.01)
    spanned = tracing.parse(_harness_events() + _program_events(), 0.01)
    readings = _same(plain, spanned)
    # the readers read something here, so the equality means something
    got = [v for v in readings.values() if v is not None]
    assert len(got) >= 14 and all(math.isfinite(v) for v in got)
    # each device operation keeps the harness span it was launched in
    assert [sp for *_, sp in spanned.ops] == [
        "encode", "encode", "search", "score", "score", "score", "search"]
    # without program ranges the gaps read as they did before them
    assert plain.breakdown()["idle_gaps"] == [["host", 0.0055]]
    assert plain.by_span_ms(program=True) == {}
    # with them, a gap is named by the program range open at its middle
    # (the innermost: the rescue inside the resolve), else as before
    gaps = {k: round(v, 9) for k, v in spanned.idle_gaps()}
    assert gaps == {"score: cldrd.teacher.score": 0.0023,
                    "host": 0.0015, "-: cldrd.data.wait": 0.0013,
                    "search: cldrd.search.rescue": 0.0004}
    # and each device operation by the range open at its launch; the
    # producer thread's range is not the traced thread's
    ms = {k: round(v, 9) for k, v in
          spanned.by_span_ms(program=True).items()}
    assert ms == {"cldrd.index.encode": 1.7, "cldrd.search.dispatch": 1.5,
                  "cldrd.search.rescue": 0.7, "cldrd.teacher.score": 0.6}


@pytest.mark.parametrize("metric", PER_LAYER, ids=lambda m: m["name"])
def test_every_reader_reads_nothing_from_nothing(metric):
    """The readers' contract: None where the trace, the shapes, the
    window or the spans it needs are absent, with or without the rest."""
    read = _reader(metric["name"]).read
    trace = tracing.parse(_harness_events() + _program_events(), 0.01)
    empty = types.SimpleNamespace(trace=None, shapes={}, complete=True,
                                  window={}, spans=None)
    assert read(empty) is None
    assert read(types.SimpleNamespace(**dict(vars(empty),
                                             trace=trace))) is None
    if metric["source"] == "device_trace":  # all but the trace
        assert read(types.SimpleNamespace(
            trace=None, shapes=_shapes(), complete=True, spans=SPANS,
            window={"units": 1, "seconds": 0.02, "flops": 1e12,
                    "examples": 8})) is None


def _traced_events(monkeypatch, name):
    """The events of a ``--trace 1`` run of a tiny cell on the CPU."""
    seen = []
    parse = tracing.parse

    def keep(events, wall):
        seen.append(list(events))
        return parse(events, wall)

    monkeypatch.setattr(tracing, "parse", keep)
    res = harness.run_cell(tiny.cell(name), 5_400_000_011, 0.2, True,
                           device="cpu")
    assert res["correct"], res["checks"]
    (events,) = seen
    return events


@pytest.mark.parametrize("name,spans", [
    ("distilbert.retrieve.exact-int8-b512",
     {"cldrd.data.wait", "cldrd.index.encode", "cldrd.index.fetch",
      "cldrd.search.dispatch", "cldrd.search.resolve"}),
    ("minilm.teacher.flat-top100",
     {"cldrd.data.wait", "cldrd.data.batch", "cldrd.teacher.score",
      "cldrd.teacher.collect"}),
])
def test_program_ranges_move_no_reading_on_a_cpu_trace(monkeypatch, name,
                                                       spans):
    events = _traced_events(monkeypatch, name)
    found = {e["name"] for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("cldrd.")}
    # a certificate miss (a tiny store's) adds the rescue
    assert spans <= found <= spans | {"cldrd.search.rescue"}
    without = [e for e in events
               if not e.get("name", "").startswith("cldrd.")]
    _same(tracing.parse(without, 1.0), tracing.parse(events, 1.0))


SPAN_READERS = [m for m in PER_LAYER if m["name"].split(".")[0] in
                {"data_wait_ms", "h2d_ms", "dispatch_ms", "resolve_ms"}]


@pytest.mark.parametrize("name", sorted({c for m in SPAN_READERS
                                         for c in m["workloads"]}))
def test_spans_read_over_the_window_of_a_traced_run(monkeypatch, name):
    """``--trace 1``: the port's spans gathered over the window reach
    their readers; ``--trace 0``: no collector is installed, so the
    end-to-end metrics are taken without one. Either way none is left
    installed after the run."""
    from cldrd_tpu_torch.utils import profiling

    installed = []
    real = profiling.collect
    monkeypatch.setattr(profiling, "collect",
                        lambda timer: installed.append(timer)
                        or real(timer))
    cell = tiny.cell(name)
    # a window of several steps: it opens and closes inside a step
    res = harness.run_cell(cell, 5_400_000_029, 2.0, True, device="cpu")
    assert res["correct"], res["checks"]
    assert len(installed) == 1 and profiling._collector is None
    for m in SPAN_READERS:
        if name in m["workloads"]:
            value = res["metrics"][m["name"]]["value"]
            assert 0 < value < 2e3, (m["name"], value)
    harness.run_cell(cell, 5_400_000_029, 0.2, False, device="cpu")
    assert len(installed) == 1 and profiling._collector is None
