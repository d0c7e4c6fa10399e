"""The byte floor (``bench/roofline.py``, at the slot width B) of the
stepper's SpMV passes in the traced window, the ``iters`` of each chunk
span wholly inside it, over the device time of every kernel there, in
percent."""
from bench.roofline import roofline_pct


def read(run):
    return roofline_pct(run) if "records" in run.extra else None
