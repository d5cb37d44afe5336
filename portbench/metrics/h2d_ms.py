"""Host milliseconds a training step spends copying its batch to the
device: a ``cldrd.train.h2d`` span (``batch_to_device``, one a step),
from the collector over the untraced window of a ``--trace 1`` run."""
from portbench.metrics import span_call_ms


def read(m):
    return span_call_ms(m, "cldrd.train.h2d")
