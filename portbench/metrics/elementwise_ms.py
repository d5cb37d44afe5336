"""Device milliseconds a model unit (a training step, a score call) in
the elementwise class (norms, GELU, dropout, casts, reductions, copies:
every kernel that is not a product, attention, the optimizer's or a
search kernel), from the operations launched inside the driver's
``model_span`` (the whole traced segment where it names none), over its
``model_units``."""
from portbench.roofline import ELEMENTWISE, kernel_class


def read(m):
    t, s = m.trace, m.shapes
    if t is None or not s.get("model_units"):
        return None
    ms = sum(v for k, v in t.by_name_ms(span=s.get("model_span")).items()
             if kernel_class(k) == ELEMENTWISE)
    return ms / s["model_units"]
