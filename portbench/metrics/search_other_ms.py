"""Device milliseconds a search batch spends outside K1: bin selection,
merges, certificate checks, rescues and the result copies, from the
operations launched inside the harness's search span."""


def read(m):
    t, s = m.trace, m.shapes
    if t is None or not m.complete or not s.get("search_batches"):
        return None
    other = t.device_ms(span="search") \
        - t.device_ms("extract_topk", span="search")
    return other / s["search_batches"]
