"""K1's least time at the search's shape (int8 store with scales, bf16
queries, the level-2 rounds it emits) over its mean device time a launch
in the trace."""
from portbench.metrics import has
from portbench.roofline import bound_ms, k1_bytes_ops, pct, super_rounds


def read(m):
    t, s = m.trace, m.shapes
    if t is None or not m.complete or not has(s, "rows", "search_batch",
                                              "dim", "k"):
        return None
    n = t.count("extract_topk")
    if n == 0:
        return None
    rows, bz = s["rows"], s["search_batch"]
    nbytes, ops = k1_bytes_ops(bz, rows, s["dim"], "int8", "bf16",
                               super_rounds(rows, rows // 2048, bz, s["k"]),
                               True)
    return pct(bound_ms(nbytes, ops, "bf16")[0],
               t.device_ms("extract_topk") / n)
