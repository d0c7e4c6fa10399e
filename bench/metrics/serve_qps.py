"""Queries answered without error in the window, over its seconds
(host clock)."""


def read(run):
    records = run.extra.get("records")
    if records is None:
        return None
    done = sum(1 for _, _, t_d, res, err in records
               if run.t0 <= t_d <= run.t1 and res is not None and err is None)
    return done / run.window_s
