"""Device milliseconds of the query tower a batch of encode_batch
queries (with its token copies), from the operations launched inside
the harness's encode span."""


def read(m):
    t, s = m.trace, m.shapes
    if t is None or not s.get("encode_batches"):
        return None
    return t.device_ms(span="encode") / s["encode_batches"]
