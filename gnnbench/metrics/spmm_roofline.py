"""The least time of a step's SpMM calls over their traced device time, in
percent.  Each call is bounded alone by ``roofline.bound`` over its bytes
(indptr, indices, B and out, each once) and its 2·nnz·K operations; the
calls are the adapter's count from the configuration's shapes."""

from gnnbench.roofline import spmm_bound_s


def read(run):
    t = run["trace"]
    if t is None or not t["layer_s"].get("spmm"):
        return None
    calls = run["adapter"].spmm_calls(run["config"], run["n"], run["nnz"])
    measured = t["layer_s"]["spmm"] / t["steps"]
    return 100.0 * spmm_bound_s(calls) / measured
