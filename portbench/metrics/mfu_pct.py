"""The window's useful FLOPs a second over the bf16 peak of the chips
used (``window["flops"]``, from the driver: the model's forward at each
sequence's real tokens, 3x it for a training step's forward and
backward, plus 2*N*D a query for the search's scores, since K1 widens
the int8 rows to bf16), over all the window's time."""
from portbench.metrics import has
from portbench.roofline import PEAK_OPS, pct


def read(m):
    w = m.window
    if not has(w, "seconds", "flops"):
        return None
    return pct(w["flops"] / w["seconds"],
               w.get("chips", 1) * PEAK_OPS["bf16"])
