"""Device milliseconds a step under the program's own SpMM spans, each with
the backward linked to it (``gnnbench/spans.py``): ``op/spmm``, the whole
``spmm()`` call (the kernel and, for ``reduce="mean"``, the division), and
``op/spmm.grad``, its backward.  The program-side twin of ``spmm_ms``."""

from gnnbench import spans


def read(run):
    t = spans.from_run(run)
    if t is None:
        return None
    ms = [t["device_ms"][k] for k in ("op/spmm", "op/spmm.grad")
          if k in t["device_ms"]]
    return sum(ms) if ms else None
