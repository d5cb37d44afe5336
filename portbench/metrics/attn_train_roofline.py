"""K3 and K4 together: the sum of their least times over the traced
steps (every block but the CLS-only last one of both towers: the
queries at [bz, lq], the passages at [bz * nway, lp]; bf16, the mask
read once) over their device time."""
from portbench.metrics import has
from portbench.roofline import attn_bytes_ops, bound_ms, pct


def read(m):
    t, s = m.trace, m.shapes
    if t is None or not m.complete or not has(
            s, "trace_steps", "n_layers", "dim", "n_heads", "batch_size",
            "lq", "nway", "lp"):
        return None
    steps, blocks = s["trace_steps"], s["n_layers"] - 1
    if t.count("attn_fwd") != 2 * blocks * steps:
        return None
    hd = s["dim"] // s["n_heads"]
    bound = 0.0
    for b, length in ((s["batch_size"], s["lq"]),
                      (s["batch_size"] * s["nway"], s["lp"])):
        for tensors, dots in ((4, 2), (7, 5)):
            nbytes, ops = attn_bytes_ops(b, length, "bf16", tensors, dots,
                                         heads=s["n_heads"], head_dim=hd)
            bound += bound_ms(nbytes, ops, "bf16")[0]
    ms = t.device_ms("attn_fwd") + t.device_ms("attn_bwd")
    return pct(bound * blocks * steps, ms)
