"""The share of a unit's time (a pass, a step) in which no operation
ran on the device: the traced segment's busy device seconds a unit, over
the untraced window's seconds a unit. The traced segment's own idle
share (``device.busy_s`` against ``device.window_s``) also carries the
profiler's host overhead; the device's work a unit is the same in both."""


def read(m):
    t, w = m.trace, m.window
    units = m.shapes.get("traced_units")
    if t is None or not units or not w.get("units") or not w.get("seconds"):
        return None
    return 100.0 * (1.0 - (t.busy_s / units) / (w["seconds"] / w["units"]))
