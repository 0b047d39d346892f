"""The 90th percentile of the window's step times, each from the CUDA
events recorded on the stream between steps."""

import statistics


def read(run):
    times = run["window"].step_s
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=10, method="inclusive")[-1] * 1e3
