"""Host milliseconds a training step spends dispatching its model work:
a ``cldrd.train.forward``, ``.backward`` and ``.optimizer`` span each
(one of each a step), from the collector over the untraced window of a
``--trace 1`` run. Taken call by call: the window opens and closes
inside a step's forward, so it holds one forward fewer than steps."""
from portbench.metrics import span_call_ms


def read(m):
    parts = [span_call_ms(m, "cldrd.train." + s)
             for s in ("forward", "backward", "optimizer")]
    return None if None in parts else sum(parts)
