"""Reading a ``torch.profiler`` trace (Chrome format, as the port's
``utils.profiling.trace`` writes it).

- Device operations: events of category ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``. Each is tied to the host call that launched it by its
  ``correlation`` id, and so to the innermost ``portbench.*`` range (the
  harness's spans around the calls into each layer) open at that call.
- The window: the ``portbench.traced`` range. ``busy_s`` is the union of
  the device operations' intervals inside it, ``window_s`` its length.
- The port's own ranges (``cldrd.*``, ``utils.profiling.annotate``) on
  the thread that opened ``portbench.traced``: each device operation is
  also tied to the innermost one open at its launch (``by_span_ms(
  program=True)``), apart from the harness's spans, which the readers
  read as before.
- Idle gaps: the stretches of the window with no device operation,
  labelled ``<harness span or ->: <program span>`` by the innermost
  ranges open across their middle, or where no program range is open,
  by the harness span and the innermost host operation running there.
  A trace without program ranges reads as it did before they existed.
- ``hold_to_counters``: kernel events counted by name against the port's
  launch counters over the same segment (the driver names each counter
  by the fragment of its kernels' names); a shortfall (records the trace
  lost) is reported, and the readers of kernel times then read nothing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SPAN = "portbench."
PROGRAM = "cldrd."


class Ranges:
    """Named ranges on one thread, and the innermost open at a time."""

    def __init__(self, ranges):
        self._ranges = sorted(ranges)  # [(ts, end, name)]
        self._starts = [r[0] for r in self._ranges]

    def at(self, t: float) -> Optional[str]:
        for i in range(bisect.bisect_right(self._starts, t) - 1, -1, -1):
            a, b, name = self._ranges[i]
            if b >= t:  # the latest start covering it: innermost
                return name
        return None


class Trace:
    def __init__(self, ops, host, window, wall, spans, program,
                 op_programs):
        self.ops = ops            # [(name, ts, dur, span)] in microseconds
        self._host = host         # [(ts, end, name, span)] host operations
        self._spans, self._program = spans, program  # harness's, port's
        # the innermost program range open at each op's launch
        self.op_programs = op_programs
        self.t0, self.t1 = window
        self.window_s = (self.t1 - self.t0) / 1e6 if self.t1 > self.t0 \
            else wall
        self.intervals = _merge([(ts, ts + dur) for _, ts, dur, _ in ops],
                                self.t0, self.t1)
        self.busy_s = sum(b - a for a, b in self.intervals) / 1e6

    def all_busy_s(self) -> float:
        """Busy seconds of every device operation in the trace, not
        clipped to the window: the session starts after a sync and stops
        after one, so the work that the segment launched and that the
        device finishes after the range closes counts too."""
        return sum(b - a for a, b in _merge(
            [(ts, ts + dur) for _, ts, dur, _ in self.ops],
            float("-inf"), float("inf"))) / 1e6

    def device_ms(self, pattern: Optional[str] = None,
                  span: Optional[str] = None) -> float:
        """Device milliseconds of the operations whose name holds
        ``pattern`` and that were launched inside ``span``."""
        return sum(dur for name, _, dur, sp in self.ops
                   if (pattern is None or pattern in name)
                   and (span is None or sp == span)) / 1e3

    def by_span_ms(self, program: bool = False) -> Dict[str, float]:
        """Device milliseconds by the harness span (or with ``program``,
        the port's innermost range) open at each operation's launch;
        operations launched outside every span are left out."""
        out: Dict[str, float] = defaultdict(float)
        spans = self.op_programs if program else [o[3] for o in self.ops]
        for (_, _, dur, _), sp in zip(self.ops, spans):
            if sp is not None:
                out[sp] += dur / 1e3
        return dict(out)

    def count(self, pattern: str) -> int:
        return sum(1 for name, _, _, _ in self.ops if pattern in name)

    def by_name_ms(self, span: Optional[str] = None) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, _, dur, sp in self.ops:
            if span is None or sp == span:
                out[name] += dur / 1e3
        return dict(out)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        gaps: Dict[str, float] = defaultdict(float)
        edges = [self.t0] + [x for iv in self.intervals for x in iv] \
            + [self.t1]
        starts = [h[0] for h in self._host]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            label = "host"
            program = self._program.at(mid)
            if program is not None:
                label = f"{self._spans.at(mid) or '-'}: {program}"
            else:
                # the innermost host operation covering the gap's middle
                hi = bisect.bisect_right(starts, mid)
                for i in range(hi - 1, max(hi - 4096, 0) - 1, -1):
                    ts, end, name, sp = self._host[i]
                    if end >= mid:  # the latest start covering it
                        label = f"{sp or '-'}: {name}"
                        break
            gaps[label] += (b - a) / 1e6
        return sorted(gaps.items(), key=lambda kv: -kv[1])

    def breakdown(self) -> dict:
        ops = sorted(self.by_name_ms().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, ms / 1e3] for n, ms in ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps()[:10]]}


def _merge(intervals, lo, hi):
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def parse(events: List[dict], wall: float) -> Trace:
    spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    ranges = []  # (ts, end, span name)
    program = []  # (ts, end, name, thread) of the port's ranges
    traced_thread = None
    host = []
    launch_ts: Dict[int, float] = {}
    ops_raw = []
    for e in events:
        cat, ph = e.get("cat", ""), e.get("ph")
        if ph != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops_raw.append((e["name"], ts, dur,
                            e.get("args", {}).get("correlation")))
        elif cat in RUNTIME_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ts
        elif cat == "user_annotation" and e["name"].startswith(SPAN):
            name = e["name"][len(SPAN):]
            spans[name].append((ts, dur))
            ranges.append((ts, ts + dur, name))
            if name == "traced":
                traced_thread = (e.get("pid"), e.get("tid"))
        elif cat == "user_annotation" and e["name"].startswith(PROGRAM):
            program.append((ts, ts + dur, e["name"],
                            (e.get("pid"), e.get("tid"))))
        elif cat == "cpu_op":
            host.append((ts, ts + dur, e["name"]))
    window = spans.get("traced", [(0.0, 0.0)])[0]
    harness = Ranges(r for r in ranges if r[2] != "traced")
    ours = Ranges((a, b, name) for a, b, name, thread in program
                  if thread == traced_thread)
    launches = [launch_ts.get(corr, ts) for _, ts, _, corr in ops_raw]
    ops = [(name, ts, dur, harness.at(t))
           for (name, ts, dur, _), t in zip(ops_raw, launches)]
    host = sorted((a, b, name, harness.at(a)) for a, b, name in host)
    return Trace(ops, host, (window[0], window[0] + window[1]), wall,
                 spans=harness, program=ours,
                 op_programs=[ours.at(t) for t in launches])


def hold_to_counters(trace: Trace, launched: Dict[str, int]) -> List[str]:
    """Lines naming each counted kernel whose events in the trace fall
    short of (or exceed) the launches the port counted; ``launched`` maps
    a fragment of the kernels' names to their launches."""
    lines = []
    for fragment, n in launched.items():
        seen = trace.count(fragment)
        if seen != n:
            lines.append(f"trace incomplete: {seen} '{fragment}' kernel "
                         f"events against {n} launches counted; kernel "
                         "times left out")
    return lines
