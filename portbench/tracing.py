"""Reading a ``torch.profiler`` trace (Chrome format, as the port's
``utils.profiling.trace`` writes it).

- Device operations: events of category ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``. Each is tied to the host call that launched it by its
  ``correlation`` id, and so to the innermost ``portbench.*`` range (the
  harness's spans around the calls into each layer) open at that call.
- The window: the ``portbench.traced`` range. ``busy_s`` is the union of
  the device operations' intervals inside it, ``window_s`` its length.
- Idle gaps: the stretches of the window with no device operation,
  labelled by the span and the innermost host operation running across
  their middle.
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


class Trace:
    def __init__(self, ops, host, window, wall):
        self.ops = ops            # [(name, ts, dur, span)] in microseconds
        self._host = host         # [(ts, end, name, span)] host operations
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
            # the innermost host operation covering the gap's middle
            hi = bisect.bisect_right(starts, mid)
            for i in range(hi - 1, max(hi - 4096, 0) - 1, -1):
                ts, end, name, sp = self._host[i]
                if end >= mid:  # the latest start covering it: innermost
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
        elif cat == "cpu_op":
            host.append((ts, ts + dur, e["name"]))
    window = spans.get("traced", [(0.0, 0.0)])[0]
    ranges = sorted(r for r in ranges if r[2] != "traced")
    starts = [r[0] for r in ranges]

    def span_at(t):
        """The innermost harness span open at ``t``."""
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            a, b, name = ranges[i]
            if b >= t:  # the latest start covering it: innermost
                return name
        return None

    ops = [(name, ts, dur, span_at(launch_ts.get(corr, ts)))
           for name, ts, dur, corr in ops_raw]
    host = sorted((a, b, name, span_at(a)) for a, b, name in host)
    return Trace(ops, host,
                 (window[0], window[0] + window[1]), wall)


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
