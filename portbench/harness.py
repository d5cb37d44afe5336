"""The harness: one run of one cell, driven by ``BENCHMARK.json``.

``run_cell`` finds everything by name: the cell in ``workloads``, its
configuration's file, ``traffic/<traffic>.json`` (whose ``driver`` names
the module under ``drivers/`` that makes the inputs, drives the port's
entry and counts the work), ``limits/<cell>.json`` (the limits of the
numbers that decide ``correct``) and, with ``--trace 1``, a reader for
each per-layer metric of the cell (``reader_path``).

A run: set-up (inputs from the seed, the port's objects, every shape
warmed up; ``setup_s`` is the process's age when the window opens), the
measured window, with ``--trace 1`` (or where an end-to-end metric
reads the device's trace) a traced segment after it (the process's
first profiler session, through the port's
``utils.profiling.trace``), then the device's memory peak, the port's
state freed, and the comparison with the plain reference. The last line
of standard output is the result; the numbers compared close standard
error, each beside its limit. With ``--trace 1`` the port's own spans
(``cldrd.*``) are gathered over the window too, by a collector on the
host's clock (``utils.profiling.collect``), for the readers of host
time; the ``--trace 0`` runs that give the end-to-end metrics run
without it.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cldrd_tpu")
SPAN = "portbench."


def log(*args) -> None:
    print("[portbench]", *args, file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's, its libraries'
    or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def reader_path(metric: str) -> str:
    """The reader of a per-layer metric: ``metrics/<metric>.py``, or
    where none has the whole name, the file of the name up to its first
    dot (one reader serves ``device_idle_pct.train`` and ``.teacher``)."""
    whole = os.path.join(HERE, "metrics", metric + ".py")
    if os.path.exists(whole):
        return whole
    return os.path.join(HERE, "metrics", metric.split(".")[0] + ".py")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` with its files resolved."""

    def __init__(self, name: str, bench: Optional[dict] = None):
        bench = bench or load_json(ROOT, "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config = load_json(ROOT, conf["file"])
        self.traffic = load_json(HERE, "traffic",
                                 self.workload["traffic"] + ".json")
        path = os.path.join(HERE, "limits", name + ".json")
        self.limits = load_json(path) if os.path.exists(path) else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.chips = int(self.workload["chips"])


class Run:
    """What a driver is handed: the cell, the seed, the window's length,
    whether to trace, the device, and the harness's services."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda"):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device = bool(trace), device
        self.config, self.traffic = cell.config, cell.traffic
        self.setup_s: Optional[float] = None
        self.opened_at: Optional[float] = None
        self.memory_peak = 0
        self.trace_data = None
        self.launch_check: List[str] = []
        # the port's spans over the window: {"totals": host seconds,
        # "counts": calls} by span name (--trace 1 runs)
        self.spans: Optional[dict] = None
        self._collector = None  # (the installed ``collect``, its timer)

    # ------------------------------------------------------------ phases

    def window_opens(self) -> None:
        """Set-up ends here: the next operation is timed. In a ``--trace
        1`` run the port's spans are gathered from here until the driver
        takes the window's time (``close_spans``)."""
        self.sync()
        self.setup_s = process_age()
        self.opened_at = time.time()
        log(f"setup_s {self.setup_s:.3f}")
        if self.trace:
            from cldrd_tpu_torch.utils.profiling import PhaseTimer, collect

            installed = collect(PhaseTimer())
            self._collector = (installed, installed.__enter__())

    def close_spans(self) -> None:
        """The window's time is taken: remove the span collector and keep
        the host seconds and calls it gathered (``spans``). Spans still
        open add nothing to them."""
        if self._collector is None:
            return
        installed, timer = self._collector
        self._collector = None
        self.spans = {"totals": timer.totals(), "counts": timer.counts()}
        installed.__exit__(None, None, None)

    def drop_spans(self) -> None:
        """Remove a collector that the driver did not close (it raised),
        keeping nothing."""
        if self._collector is not None:
            self._collector[0].__exit__(None, None, None)
            self._collector = None

    def window_closed(self) -> None:
        """The window and any traced segment are over: read the device's
        memory peak before the port's state is freed."""
        import torch

        self.sync()
        if self.device != "cpu":
            self.memory_peak = int(torch.cuda.max_memory_allocated())
        found = forbidden_modules()
        if found:
            raise SystemExit("JAX or the JAX package was loaded: "
                             + ", ".join(found))

    def sync(self) -> None:
        import torch

        if self.device != "cpu" and torch.cuda.is_available():
            torch.cuda.synchronize()

    @staticmethod
    def span(name: str):
        """A named range in the trace around a call into a layer."""
        import torch

        return torch.profiler.record_function(SPAN + name)

    @contextlib.contextmanager
    def traced(self, counters: Callable[[], Dict[str, int]]):
        """Trace the enclosed units as the process's first profiler
        session; afterwards ``trace_data`` holds the parsed trace and the
        kernel events are held to the port's launch counters
        (``counters()``: a fragment of the kernels' names -> launches so
        far)."""
        import shutil
        import tempfile

        from cldrd_tpu_torch.utils.profiling import read_trace, trace

        logdir = tempfile.mkdtemp(prefix="portbench-trace-",
                                  dir=os.environ.get("TMPDIR"))
        before = counters()
        self.sync()
        t0 = time.perf_counter()
        try:
            with trace(logdir):
                with self.span("traced"):
                    yield
                self.sync()
            wall = time.perf_counter() - t0
            after = counters()
            from . import tracing

            self.trace_data = tracing.parse(read_trace(logdir), wall)
            self.launch_check = tracing.hold_to_counters(
                self.trace_data, {k: after[k] - before[k] for k in after})
        finally:
            shutil.rmtree(logdir, ignore_errors=True)


def _check_lines(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, the checks' JSON) with every number beside its limit: a
    number passes when it is finite and at most its limit, and every
    limit needs its number."""
    import math

    checks, ok = {}, bool(numbers)
    for name, value in numbers.items():
        limit = limits.get(name)
        good = (limit is not None and value is not None
                and math.isfinite(value) and value <= limit)
        ok = ok and good
        if value is None or not math.isfinite(value):
            value = 1e300  # unreadable: stands far above any limit
        checks[name] = {"value": value, "limit": limit}
    for name, limit in limits.items():
        if name not in numbers:  # a number the run could not read
            ok = False
            checks[name] = {"value": 1e300, "limit": limit}
    return ok, checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """One run; returns the result's object (the last line's)."""
    run = Run(cell, seed, seconds, trace, device)
    driver = importlib.import_module(
        "portbench.drivers." + cell.traffic["driver"])
    try:
        out = driver.run(run)
    finally:
        run.drop_spans()
    if device != "cpu":
        log("card:", card_line())
    numbers = out["check"]()
    correct, checks = _check_lines(numbers, cell.limits)
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if trace:
        metrics = {}
        ctx = MetricContext(run, out)
        for m in cell.per_layer:
            reader = load_module(reader_path(m["name"]),
                                 "portbench_metric_" + m["name"].replace(
                                     ".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if run.trace_data is not None:
            for what, ms in (("harness", run.trace_data.by_span_ms()),
                             ("program", run.trace_data.by_span_ms(
                                 program=True))):
                log(f"device ms by {what} span: {json.dumps(ms)}")
    else:
        metrics = {m["name"]: {"value": driver_metric(out["metrics"],
                                                      m["name"]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": run.setup_s, "unit": "s"}
    result["metrics"] = metrics
    result["device"] = device_info(run)
    if trace and run.trace_data is not None:
        result["device"]["busy_s"] = run.trace_data.busy_s
        result["device"]["window_s"] = run.trace_data.window_s
        result["breakdown"] = run.trace_data.breakdown()
    result["checks"] = checks
    for line in run.launch_check:
        log(line)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return result


def driver_metric(values: Dict[str, float], name: str) -> float:
    """An end-to-end metric's value from the driver's: under its whole
    name, or where the driver gives none by it, under its name up to the
    first dot (``teacher_pass_device_ms.<cell>`` takes the teacher
    driver's ``teacher_pass_device_ms``), so a cell can join with an
    entry of its own."""
    return values[name] if name in values else values[name.split(".")[0]]


class MetricContext:
    """What a per-layer reader reads: the trace (``trace``: a
    ``tracing.Trace`` or None), the window's counts (``window``), the
    driver's shapes (``shapes``), whether the trace's kernel events
    matched the launch counters (``complete``), and the port's spans
    over the window (``spans``: ``{"totals": host seconds, "counts":
    calls}`` by span name, or None)."""

    def __init__(self, run: Run, out: dict):
        self.trace = run.trace_data
        self.window = out.get("window", {})
        self.shapes = out.get("shapes", {})
        self.complete = not run.launch_check
        self.spans = run.spans


def device_info(run: Run) -> dict:
    import torch

    if run.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.cell.chips, "memory_peak_bytes": run.memory_peak}


def card_line() -> str:
    """The card's name and power limit (``nvidia-smi``), for the log."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
