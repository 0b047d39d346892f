"""Device milliseconds a step under the program's ``model/dropout`` span,
the mask's draw and the masked scale, with their backward linked to it
(``gnnbench/spans.py``)."""

from gnnbench import spans


def read(run):
    t = spans.from_run(run)
    if t is None:
        return None
    return t["device_ms"].get("model/dropout")
