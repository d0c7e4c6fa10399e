"""Seconds of host preprocessing spent relabeling the graph for
locality: the ``plan_stage`` spans ``reorder`` (the permutation) and
``relabel`` (the relabeled graph) of ``plan_make``, summed over set-up,
from the records a traced run's load generator kept
(``run.extra["setup_spans"]``). None where the program records no such
stage."""

STAGES = ("reorder", "relabel")


def read(run):
    spans = [r for r in run.extra.get("setup_spans") or ()
             if r.name == "plan_stage" and r.attrs.get("stage") in STAGES]
    if not spans:
        return None
    return sum(r.t_end - r.t_start for r in spans)
