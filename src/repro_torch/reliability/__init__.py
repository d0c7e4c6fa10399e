"""Serving resilience: the admission knobs of ``SlotScheduler`` and the
plan integrity check its ``apply_delta`` runs. Fault injection and
snapshots come with the reliability slice (ROADMAP.md, Queue A)."""
from .admission import ResilienceConfig
from .guardrails import check_plan_integrity

__all__ = ["ResilienceConfig", "check_plan_integrity"]
