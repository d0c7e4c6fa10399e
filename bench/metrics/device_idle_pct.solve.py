"""100 - the device's busy share of the traced window of back-to-back
solves (torch.profiler: the union of the card's kernel, copy and set
intervals over the window's host-clock length)."""
from bench.devtrace import idle_pct


def read(run):
    return idle_pct(run.devtrace) if "solves" in run.extra else None
