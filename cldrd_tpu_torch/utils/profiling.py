"""Profiling and throughput observability.

Port of ``cldrd_tpu/utils/profiling.py`` on ``torch.profiler``:

- ``trace(logdir)``: context manager that writes one Chrome-format trace
  (``*.pt.trace.json``) of the enclosed region into ``logdir``: host ops
  and, where CUDA is available, every kernel of every device. Perfetto,
  ``chrome://tracing`` and TensorBoard's PyTorch profiler plugin load it.
- ``PhaseTimer``: named wall-clock phases -> dict / TSV (index build,
  encode, search, merge ... the end-to-end budget breakdown).
- ``Throughput``: running items/sec meter (QPS, passages/sec).
- ``annotate(name)``: a ``torch.profiler.record_function`` range, so hot
  loops show up labeled in the trace.
- ``read_trace(logdir)``: the events of the one trace in ``logdir``.

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
import time
from typing import Dict, Iterator, List

import torch

TRACE_GLOB = "*.pt.trace.json*"


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


def annotate(name: str):
    """Label a region in the profiler timeline."""
    return torch.profiler.record_function(name)


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
        self._order: list = []

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self._acc:
                self._order.append(name)
            self._acc[name] = self._acc.get(name, 0.0) + dt

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
