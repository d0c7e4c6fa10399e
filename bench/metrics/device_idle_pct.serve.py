"""100 - the device's busy share of the traced window of the served
closed loop (torch.profiler: the union of the card's kernel, copy and
set intervals over the window's host-clock length)."""
from bench.devtrace import idle_pct


def read(run):
    return idle_pct(run.devtrace) if "records" in run.extra else None
