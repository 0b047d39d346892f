"""The least time of a step's fused dot-attention calls over
``dot_op_ms``, in percent.  Each walk (forward, backward over the CSR,
backward over the CSC) is bounded alone by ``roofline.bound`` over its
bytes and operations from shapes (``dot_roofline.py``), with the attention
mask's bytes where the configuration drops attention out; the calls are
the adapter's count from the configuration's shapes."""

from gnnbench.dot_roofline import dot_bound_s
from gnnbench.harness import metric_reader


def read(run):
    calls = getattr(run["adapter"], "dot_calls", None)
    measured_ms = metric_reader("dot_op_ms")(run)
    if calls is None or not measured_ms:
        return None
    cfg = run["config"]
    bound_s = dot_bound_s(calls(cfg, run["n"], run["nnz"]),
                          masked=cfg.get("attn_dropout", 0.0) > 0.0)
    return 100.0 * bound_s / (measured_ms / 1e3)
