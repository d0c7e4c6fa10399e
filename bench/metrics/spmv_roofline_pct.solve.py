"""The byte floor (``bench/roofline.py``, d = 1) of the SpMV passes of
the traced solves, 20 a solve, over the device time of every kernel in
the traced window, in percent."""
from bench.roofline import roofline_pct


def read(run):
    return roofline_pct(run) if "solves" in run.extra else None
