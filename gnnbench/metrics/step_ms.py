"""The window's wall time, ended by a synchronize, over the steps in it."""


def read(run):
    w = run["window"]
    return w.wall_s * 1e3 / w.steps
