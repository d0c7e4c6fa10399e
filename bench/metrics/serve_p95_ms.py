"""95th percentile (nearest rank) of client latency, from
``Gateway.submit`` to the future resolving, over every query submitted
in the window: one open at the close counts at its age then, a failed
one as infinite (host clock)."""
import math

from bench.loadgen import gateway_closed


def read(run):
    if run.extra.get("records") is None:
        return None
    p95 = gateway_closed.nearest_rank(gateway_closed.latencies_s(run), 95)
    if p95 is None or not math.isfinite(p95):
        return None
    return p95 * 1e3
