"""Device milliseconds a step under the program's fused dot-attention
spans, each with the backward linked to it (``gnnbench/spans.py``):
``op/dot``, the whole ``dot_attention_aggregate`` call, and
``op/dot.grad``, its backward (both walks and the s_row product before
them)."""

from gnnbench import spans


def read(run):
    t = spans.from_run(run)
    if t is None:
        return None
    ms = [t["device_ms"][k] for k in ("op/dot", "op/dot.grad")
          if k in t["device_ms"]]
    return sum(ms) if ms else None
