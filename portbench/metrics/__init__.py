"""Per-layer metric readers, one file a computation: a metric's reader is
``<name>.py``, or where no file has its whole name, the file of its name
up to the first dot (``device_idle_pct.train`` -> ``device_idle_pct.py``).

The contract: each has ``read(m) -> float | None``, ``m`` a
``harness.MetricContext``. It returns None when what it needs is absent:
the trace (``m.trace`` None, or ``m.complete`` false for a kernel's
time), a key of the driver's shapes (``m.shapes``) or of the window's
counts (``m.window``), or the port's spans (``m.spans`` None, or a span
that never ran). It never raises for a missing input, and never returns
0 for a share of a roofline or of a peak in place of nothing. The
harness leaves a metric whose reader returns None out of the result.
``test_portbench_program_spans`` calls every reader with nothing to
read.
"""
from typing import Optional


def has(d: dict, *keys: str) -> bool:
    """Whether ``d`` holds every key of ``keys``, each non-zero."""
    return all(d.get(k) for k in keys)


def span_ms(m, name: str) -> Optional[float]:
    """The host milliseconds of the port's span ``name`` over the window,
    or None where the spans were not gathered or it never ran."""
    if not m.spans or name not in m.spans["totals"]:
        return None
    return 1e3 * m.spans["totals"][name]


def span_call_ms(m, name: str) -> Optional[float]:
    """The host milliseconds of a call of the port's span ``name``."""
    ms = span_ms(m, name)
    return None if ms is None else ms / m.spans["counts"][name]
