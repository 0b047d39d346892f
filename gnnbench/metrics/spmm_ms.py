"""Device milliseconds a step of the operations attributed to the SpMM
layer in the trace (``traceparse.layer_of``)."""


def read(run):
    t = run["trace"]
    if t is None or not t["layer_s"].get("spmm"):
        return None
    return t["layer_s"]["spmm"] * 1e3 / t["steps"]
