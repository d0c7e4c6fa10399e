"""Weighted-fair stride scheduling over named graphs (a copy of the
JAX package's ``gateway/qos.py``).

The gateway's device loop (and ``GraphRegistry.run_until_drained``)
must interleave stepper chunks across graphs so one hot graph cannot
starve the others.  Classic stride scheduling does exactly that with
O(1) state per graph: each graph advances a virtual "pass" by
``1/share`` per chunk served, and the next chunk goes to the eligible
graph with the smallest pass — over any window, graph i receives
chunks in proportion ``share_i / sum(shares)`` among the graphs that
had work.

A graph that was idle rejoins at the MINIMUM eligible pass (not its
stale own), so it cannot burn banked credit into a monopolizing burst
— the standard lag-capping rule.
"""
from __future__ import annotations


class WeightedFair:
    """Stride scheduler: ``pick(eligible)`` returns the next name to
    serve and charges it ``1/share``.  Deterministic (ties break by
    name) so tests can assert exact interleavings."""

    def __init__(self, shares: dict[str, float]):
        for name, s in shares.items():
            if not s > 0:
                raise ValueError(f"share for {name!r} must be > 0; "
                                 f"got {s}")
        self._shares = dict(shares)
        self._pass: dict[str, float] = {}

    def pick(self, eligible: list[str]) -> str:
        if not eligible:
            raise ValueError("pick() needs at least one eligible name")
        known = [self._pass[n] for n in eligible if n in self._pass]
        floor = min(known) if known else 0.0
        for n in eligible:
            if n not in self._pass:
                self._pass[n] = floor     # rejoin without banked credit
        chosen = min(eligible, key=lambda n: (self._pass[n], n))
        self._pass[chosen] += 1.0 / self._shares.get(chosen, 1.0)
        return chosen
