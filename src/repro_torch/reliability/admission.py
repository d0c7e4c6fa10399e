"""Admission policy knobs of the resilient serve path (a copy of the JAX
package's ``reliability/admission.py``).

One frozen config value carries every resilience knob of
``SlotScheduler``; the defaults are the plain behaviour (unbounded FIFO
queue, no deadlines, one quarantine retry), so handing
``ResilienceConfig()`` to a scheduler changes nothing on the happy path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Resilience knobs of one ``SlotScheduler``.

    Admission / backpressure:

    - ``max_queue``: bound on the admission queue.  A submit past the
      bound is REJECTED EXPLICITLY — the query completes immediately
      with ``QueryResult.error`` set and the rejection counted — never
      silently queued into a timeout.  ``None`` keeps the legacy
      unbounded queue.
    - ``default_deadline_s``: deadline applied to queries submitted
      without one (``None`` = no deadline).  Deadlines are absolute
      wall-clock budgets covering queue wait AND service.

    Graceful degradation (the Fused-PageRank license: an approximate
    answer beats a dropped one):

    - ``degrade_tol``: under measured SLO pressure — the scheduler's
      EWMA service-time model predicts the query cannot finish inside
      its deadline at its requested tolerance — the query's tolerance
      is loosened to this value at admission (counted, and flagged on
      the result).  A query that still overruns its deadline mid-
      flight is finished with its CURRENT iterate as an approximate
      answer rather than cancelled.

    Quarantine / fault policy:

    - ``max_retries``: how many times a NaN/Inf-poisoned slot is
      re-admitted from a clean seed before the query is failed
      explicitly.
    - ``max_step_retries``: transient stepper-dispatch failures
      tolerated (the dispatch is retried next ``step()``) before the
      in-flight pool is declared lost and its queries failed.
    - ``verify_plans``: run ``guardrails.check_plan_integrity`` on
      every plan swapped in by ``apply_delta``. Read only by
      ``apply_delta``, which comes with the streaming slice (and the
      integrity check with the reliability slice).
    """
    max_queue: Optional[int] = None
    default_deadline_s: Optional[float] = None
    degrade_tol: float = 1e-3
    max_retries: int = 1
    max_step_retries: int = 1
    verify_plans: bool = True

    def replace(self, **kw) -> "ResilienceConfig":
        return dataclasses.replace(self, **kw)
