"""Serving resilience: the admission knobs of ``SlotScheduler``. Fault
injection, plan guardrails and snapshots come with the reliability slice
(ROADMAP.md, Queue A)."""
from .admission import ResilienceConfig

__all__ = ["ResilienceConfig"]
