"""Profiling and throughput observability.

Port of ``cldrd_tpu/utils/profiling.py`` on ``torch.profiler``:

- ``trace(logdir)``: context manager that writes one Chrome-format trace
  (``*.pt.trace.json``) of the enclosed region into ``logdir``: host ops
  and, where CUDA is available, every kernel of every device. Perfetto,
  ``chrome://tracing`` and TensorBoard's PyTorch profiler plugin load it.
- ``PhaseTimer``: named wall-clock phases -> dict / TSV (index build,
  encode, search, merge ... the end-to-end budget breakdown), with each
  phase's call count; safe to update from several threads.
- ``Throughput``: running items/sec meter (QPS, passages/sec).
- ``annotate(name)``: the port's span. With no profiler session on the
  calling thread and no collector installed it returns one shared no-op
  context (a guarded check, no ``record_function``); under a session it
  opens a ``torch.profiler.record_function`` range, on the trace's clock
  beside the kernels it launches; with a collector installed it adds its
  host seconds and one call to it, from any thread.
- ``collect(timer)``: installs a ``PhaseTimer`` as the process's collector
  of spans for the enclosed region.
- ``spanned(iterable, name)``: yields the items of ``iterable``, taking
  each one under ``annotate(name)``.
- ``read_trace(logdir)``: the events of the one trace in ``logdir``.

The port's spans are named ``cldrd.<layer>.<what>``: ``cldrd.data.wait``
(the caller blocked on its next batch), ``cldrd.data.batch`` (making one
batch, on whichever thread makes it), ``cldrd.train.{h2d, forward,
backward, optimizer, gather, allreduce, flush, checkpoint}``,
``cldrd.index.{encode, fetch}``, ``cldrd.search.{dispatch, fetch,
resolve, rescue}`` and ``cldrd.teacher.{score, collect}``. No span
synchronises the device, launches device work or changes a result.
The profiler's state is per thread: a span on a thread of its own (a
``data.prefetch`` producer) reaches a collector, never the trace.

Only one profiler session may run at a time: ``trace`` raises
``RuntimeError`` when one is already active (a ``trace`` or a plain
``torch.profiler.profile``), as ``jax.profiler.start_trace`` does. A
nested ``torch.profiler.profile`` raises nothing; it ends the outer
session instead, and the outer trace loses what follows.

A session can lose device records at its start. On an H100 with CUPTI
12.8 under a CUDA 13.0 driver (``tools/trace_check.py``) each session
lost its first kernels and copies, more the longer ago the process's
first profiler session started CUPTI: none within seconds of it, 4 at
60 s, 21 at 300 s, while a first session opened 150 s into a process
lost none. A trace that must hold every kernel is best the first
profiler session of its process, as ``cli.retrieve --profile-dir``'s
is; compare its kernel events with the launches it should hold.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, TypeVar

import torch

TRACE_GLOB = "*.pt.trace.json*"

T = TypeVar("T")


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a torch.profiler trace (host ops, and CUDA kernels where
    CUDA is available) into ``logdir``."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    if torch.autograd._profiler_enabled():
        raise RuntimeError("Profile has already been started. "
                           "Only one profile may be run at a time.")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield
    finally:
        try:
            _synchronize_devices()
        finally:
            prof.stop()


def _synchronize_devices() -> None:
    """Wait for every CUDA device this process holds a context on, so the
    trace holds every kernel launched inside it."""
    if not torch.cuda.is_initialized():
        return
    for i in range(torch.cuda.device_count()):
        if torch._C._cuda_hasPrimaryContext(i):
            torch.cuda.synchronize(i)


_OFF = contextlib.nullcontext()
_collector: Optional["PhaseTimer"] = None


class _Span:
    """An open span: a ``record_function`` range where a profiler session
    is active on this thread, and its host seconds into ``timer``."""

    __slots__ = ("name", "timer", "range", "t0")

    def __init__(self, name: str, timer: Optional["PhaseTimer"]):
        self.name, self.timer, self.range = name, timer, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.timer is not None:
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.timer is not None:
            self.timer.add(self.name, time.perf_counter() - self.t0)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def annotate(name: str):
    """A span named ``name``: in the profiler's timeline where a session
    is active on this thread, in the collector where one is installed,
    and else a shared no-op."""
    timer = _collector
    if timer is None and not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, timer)


@contextlib.contextmanager
def collect(timer: "PhaseTimer") -> Iterator["PhaseTimer"]:
    """Install ``timer`` as the process's collector of spans, from every
    thread, for the enclosed region; the collector before it comes back
    afterwards."""
    global _collector
    before, _collector = _collector, timer
    try:
        yield timer
    finally:
        _collector = before


def spanned(iterable: Iterable[T], name: str) -> Iterator[T]:
    """The items of ``iterable``, each taken under ``annotate(name)``."""
    it = iter(iterable)
    end = object()
    while True:
        with annotate(name):
            item = next(it, end)
        if item is end:
            return
        yield item


def read_trace(logdir: str) -> List[dict]:
    """The ``traceEvents`` of the one trace ``trace`` wrote into
    ``logdir``; raises unless there is exactly one."""
    paths = sorted(glob.glob(os.path.join(logdir, TRACE_GLOB)))
    if len(paths) != 1:
        raise ValueError(f"{logdir}: {len(paths)} traces, expected one")
    opener = gzip.open if paths[0].endswith(".gz") else open
    with opener(paths[0], "rt") as f:
        return json.load(f)["traceEvents"]


class PhaseTimer:
    """Accumulate named wall-clock phases.

    >>> t = PhaseTimer()
    >>> with t.phase("encode"): ...
    >>> with t.phase("search"): ...
    >>> t.report()  # {"encode_s": ..., "search_s": ..., "total_s": ...}
    """

    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._calls: Dict[str, int] = {}
        self._order: list = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Count one call of phase ``name`` lasting ``seconds``."""
        with self._lock:
            if name not in self._acc:
                self._order.append(name)
            self._acc[name] = self._acc.get(name, 0.0) + seconds
            self._calls[name] = self._calls.get(name, 0) + 1

    def totals(self) -> Dict[str, float]:
        """Each phase's seconds, unrounded, in first-seen order."""
        with self._lock:
            return {k: self._acc[k] for k in self._order}

    def counts(self) -> Dict[str, int]:
        """Each phase's calls, in first-seen order."""
        with self._lock:
            return {k: self._calls[k] for k in self._order}

    def report(self) -> Dict[str, float]:
        out = {f"{k}_s": round(self._acc[k], 4) for k in self._order}
        out["total_s"] = round(sum(self._acc.values()), 4)
        return out

    def to_tsv(self) -> str:
        rep = self.report()
        return (
            "\t".join(rep.keys()) + "\n"
            + "\t".join(str(v) for v in rep.values()) + "\n"
        )


class Throughput:
    """Running items/sec with optional window reporting."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._items = 0

    def update(self, n_items: int) -> None:
        self._items += n_items

    @property
    def items(self) -> int:
        return self._items

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def per_second(self) -> float:
        return self._items / max(self.elapsed, 1e-9)

    def report(self, unit: str = "items") -> Dict[str, float]:
        return {
            unit: self._items,
            "elapsed_s": round(self.elapsed, 4),
            f"{unit}_per_s": round(self.per_second, 2),
        }
