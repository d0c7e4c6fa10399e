"""95th percentile (nearest rank) of the scheduler's queue wait, submit
to admission (``serve/metrics.py`` QueryTrace), over the queries
submitted in the window."""
from bench.loadgen import gateway_closed


def read(run):
    traces = run.extra.get("query_traces")
    if not traces:
        return None
    waits = [tr.t_admit - tr.t_submit for tr in traces.values()
             if tr.t_admit is not None and run.t0 <= tr.t_submit < run.t1]
    p95 = gateway_closed.nearest_rank(waits, 95)
    return None if p95 is None else p95 * 1e3
