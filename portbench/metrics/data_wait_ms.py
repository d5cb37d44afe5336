"""Host milliseconds a unit of the window (a pass, a step) in which the
port's caller waited for its next batch: the ``cldrd.data.wait`` spans
(``data.prefetch``'s consumer, the teacher's inline tokenizing), from
the collector over the untraced window of a ``--trace 1`` run."""
from portbench.metrics import has, span_ms


def read(m):
    ms = span_ms(m, "cldrd.data.wait")
    if ms is None or not has(m.window, "units"):
        return None
    return ms / m.window["units"]
