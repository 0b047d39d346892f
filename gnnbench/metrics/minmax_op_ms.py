"""Device milliseconds a step under the program's max/min SpMM spans, each
with the backward linked to it (``gnnbench/spans.py``):
``op/spmm_minmax``, the whole max/min ``spmm()`` call (kernel row 2 and its
pair carry), and ``op/spmm_minmax.grad``, its backward (row 3 and its
carry).  A program whose max/min path runs under ``op/spmm`` has neither
span: nothing to read."""

from gnnbench import spans


def read(run):
    t = spans.from_run(run)
    if t is None:
        return None
    ms = [t["device_ms"][k] for k in ("op/spmm_minmax", "op/spmm_minmax.grad")
          if k in t["device_ms"]]
    return sum(ms) if ms else None
