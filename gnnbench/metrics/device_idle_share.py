"""The share of the profiled steps' wall time in which no kernel, copy or
fill ran on the device, in percent."""


def read(run):
    t = run["trace"]
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / run["trace_wall_s"])
