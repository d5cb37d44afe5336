"""K5's head_dim-32 kernel (the teacher's): its least time over the
traced score calls, K and V counted for the unmasked keys only, over
its device time. Every block but the CLS-only last one launches it."""
from portbench.metrics import has
from portbench.roofline import attn_bytes_ops, bound_ms, pct


def read(m):
    t, s = m.trace, m.shapes
    if t is None or not m.complete or not has(
            s, "calls", "n_layers", "batch_size", "max_len", "n_heads",
            "dim", "keys"):
        return None
    launches = s["calls"] * (s["n_layers"] - 1)
    if t.count("attn_infer_d32") != launches:
        return None
    nbytes, ops = attn_bytes_ops(
        s["batch_size"], s["max_len"], "bf16", 4, 2,
        heads=s["n_heads"], head_dim=s["dim"] // s["n_heads"],
        keys=s["keys"] / s["calls"])
    return pct(bound_ms(nbytes, ops, "bf16")[0] * launches,
               t.device_ms("attn_infer_d32"))
