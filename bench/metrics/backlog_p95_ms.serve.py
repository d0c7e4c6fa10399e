"""95th percentile (nearest rank) of the gateway's ``backlog`` spans
(``obs/trace.py``: submit to the device thread's hand-over to the
scheduler) that began in the window; the traced run observes."""
from bench.loadgen import gateway_closed


def read(run):
    spans = run.extra.get("spans")
    if not spans:
        return None
    waits = [s.t_end - s.t_start for s in spans
             if s.name == "backlog" and run.t0 <= s.t_start < run.t1]
    p95 = gateway_closed.nearest_rank(waits, 95)
    return None if p95 is None else p95 * 1e3
