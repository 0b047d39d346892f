"""Device milliseconds a step under the program's fused GAT spans, each
with the backward linked to it (``gnnbench/spans.py``): ``op/gat``, the
whole ``gat_attention_aggregate`` call, and ``op/gat.grad``, its backward
(both walks and the s_row product before them)."""

from gnnbench import spans


def read(run):
    t = spans.from_run(run)
    if t is None:
        return None
    ms = [t["device_ms"][k] for k in ("op/gat", "op/gat.grad")
          if k in t["device_ms"]]
    return sum(ms) if ms else None
