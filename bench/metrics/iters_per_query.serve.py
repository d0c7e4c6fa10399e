"""Mean ``QueryResult.iterations`` of the queries answered in the
window (the serving scheduler's count)."""


def read(run):
    records = run.extra.get("records")
    if records is None:
        return None
    its = [res.iterations for _, _, t_d, res, err in records
           if run.t0 <= t_d <= run.t1 and res is not None and err is None]
    return sum(its) / len(its) if its else None
