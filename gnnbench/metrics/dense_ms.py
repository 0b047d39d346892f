"""Device milliseconds a step of the matrix products, forward and
backward, in the trace (``traceparse.layer_of``)."""


def read(run):
    t = run["trace"]
    if t is None or not t["layer_s"].get("dense"):
        return None
    return t["layer_s"]["dense"] * 1e3 / t["steps"]
