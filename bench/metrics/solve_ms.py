"""The window's milliseconds over the PageRank solves completed in it
(host clock; each solve ends with its ranks on the card)."""


def read(run):
    solves = run.extra.get("solves")
    if not solves:
        return None
    return run.window_s * 1e3 / solves
