"""Serving resilience (a port of the JAX package's ``reliability``;
DESIGN.md §10).

- ``admission``: ``ResilienceConfig``, the knob set of a bounded
  admission queue, deadlines and priorities, tolerance degradation under
  SLO pressure, and the quarantine and retry policy.
- ``faults``: a deterministic, seedable fault plan (NaN/Inf poisoning of
  slot columns, stepper-call exceptions, failing deltas, corrupted plan
  arrays) threaded through ``SlotScheduler`` by its ``fault_injector``.
- ``guardrails``: host-side structural integrity checks over a
  ``GraphPlan``'s index arrays, so a corrupted plan fails at rebind
  instead of serving wrong preprocessing.
- ``snapshot``: scheduler snapshot/restore (in-flight query specs and
  slot rank columns) and rank checkpoints keyed by the graph's content
  fingerprint, in the JAX package's file format.
"""
from .admission import ResilienceConfig
from .faults import (FaultInjector, FaultPlan, FaultSpec, InjectedFault,
                     corrupt_plan_arrays)
from .guardrails import check_plan_integrity
from .snapshot import (RankCheckpoint, load_rank_checkpoint,
                       restore_scheduler, save_rank_checkpoint,
                       snapshot_scheduler)

__all__ = [
    "ResilienceConfig",
    "FaultInjector", "FaultPlan", "FaultSpec", "InjectedFault",
    "corrupt_plan_arrays", "check_plan_integrity",
    "RankCheckpoint", "load_rank_checkpoint", "save_rank_checkpoint",
    "snapshot_scheduler", "restore_scheduler",
]
