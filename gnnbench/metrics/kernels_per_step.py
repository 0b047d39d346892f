"""Device operations (kernels, copies, fills) a step in the trace."""


def read(run):
    t = run["trace"]
    if t is None:
        return None
    return t["device_ops"] / t["steps"]
