"""Device milliseconds a step that no program span covers, directly or
through the autograd node's link to its forward (``gnnbench/spans.py``):
what the program's spans do not yet name."""

from gnnbench import spans


def read(run):
    t = spans.from_run(run)
    if t is None:
        return None
    return t["device_ms"].get(spans.UNATTRIBUTED, 0.0)
