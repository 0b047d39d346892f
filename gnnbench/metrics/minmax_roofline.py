"""The least time of a step's max/min SpMM walks over ``minmax_op_ms``, in
percent.  Each walk (row 2 forward over the CSR, row 3 backward over the
CSC) is bounded alone by ``roofline.bound`` over its bytes and operations
from shapes (``minmax_roofline.py``: each input read once and each output
written once, at 3.35 TB/s); the calls are the adapter's count from the
configuration's shapes."""

from gnnbench.harness import metric_reader
from gnnbench.minmax_roofline import minmax_bound_s


def read(run):
    calls = getattr(run["adapter"], "minmax_calls", None)
    measured_ms = metric_reader("minmax_op_ms")(run)
    if calls is None or not measured_ms:
        return None
    bound_s = minmax_bound_s(calls(run["config"], run["n"], run["nnz"]))
    return 100.0 * bound_s / (measured_ms / 1e3)
