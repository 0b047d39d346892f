"""The least time of a step's fused GAT calls over ``gat_op_ms``, in
percent.  Each walk (forward, backward over the CSR, backward over the CSC)
is bounded alone by ``roofline.bound`` over its bytes and operations from
shapes (``attention_roofline.py``); the calls are the adapter's count from
the configuration's shapes."""

from gnnbench.attention_roofline import gat_bound_s
from gnnbench.harness import metric_reader


def read(run):
    calls = getattr(run["adapter"], "attention_calls", None)
    measured_ms = metric_reader("gat_op_ms")(run)
    if calls is None or not measured_ms:
        return None
    bound_s = gat_bound_s(calls(run["config"], run["n"], run["nnz"]))
    return 100.0 * bound_s / (measured_ms / 1e3)
