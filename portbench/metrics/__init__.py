"""Per-layer metric readers, one file a computation: a metric's reader is
``<name>.py``, or where no file has its whole name, the file of its name
up to the first dot (``device_idle_pct.train`` -> ``device_idle_pct.py``).
Each has ``read(m) -> float | None``, ``m`` a ``harness.MetricContext``;
a reader that finds nothing to read returns None and the metric is left
out of the result."""
