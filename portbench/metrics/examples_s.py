"""The window's examples a second on the host's clock: every example
stepped over all the window's seconds, data waits, the periodic metric
fetch and the optimizer included (``window["examples"]``, from the
driver). The rate users feel; a per-layer metric because it follows the
host's speed from run to run (PERF.md)."""


def read(m):
    w = m.window
    if not w.get("examples") or not w.get("seconds"):
        return None
    return w["examples"] / w["seconds"]
