"""Host milliseconds a search batch spends resolving its results: a
``cldrd.search.resolve`` call (the results' fetch, any rescue, the map
from row positions to ids), from the collector over the untraced window
of a ``--trace 1`` run."""
from portbench.metrics import span_call_ms


def read(m):
    return span_call_ms(m, "cldrd.search.resolve")
