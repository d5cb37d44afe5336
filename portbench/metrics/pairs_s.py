"""The window's (query, passage) pairs a second on the host's clock:
every pair scored over all the window's seconds, tokenization, dispatch
and the score fetch included (``window["pairs"]``, from the driver). The
rate users feel; a per-layer metric because it follows the host's speed
from run to run (PERF.md)."""


def read(m):
    w = m.window
    if not w.get("pairs") or not w.get("seconds"):
        return None
    return w["pairs"] / w["seconds"]
