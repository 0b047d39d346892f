"""The median host milliseconds of the program's ``step`` span over the
profiled steps: the host's floor under a step, read under the profiler,
which adds to it (``gnnbench/spans.py``)."""

import statistics

from gnnbench import spans


def read(run):
    t = spans.from_run(run)
    if t is None:
        return None
    return statistics.median(t["step_host_ms"])
