"""Deterministic, seedable fault injection for the chaos suite (a copy of
the JAX package's ``reliability/faults.py``).

A ``FaultPlan`` is a declarative list of ``FaultSpec``s — *what* goes
wrong and *when* (scheduler step index / delta index). The scheduler
threads a ``FaultInjector`` through its step and rebind paths; with no
injector attached the hook costs one ``is None`` check. Everything is
deterministic: the same plan and seed produce the same faults at the
same steps, so a faulted run can be compared with a fault-free one
query by query.

Fault kinds:

- ``nan_slot`` / ``inf_slot``: overwrite one active slot column of the
  (n, B) rank pool with NaN/Inf before the next stepper call — device
  memory corruption or overflow in one query's state.
- ``step_error``: raise ``InjectedFault`` in place of the stepper call —
  a failed device launch. The pool is unwritten, so the scheduler may
  retry it.
- ``delta_error``: raise ``InjectedFault`` inside ``apply_delta`` before
  any mutation — a failing plan patch.
- ``corrupt_plan``: hand ``apply_delta`` a structurally corrupted copy of
  the patched plan (``corrupt_plan_arrays``) — what the ``guardrails``
  integrity check exists to catch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

KINDS = ("nan_slot", "inf_slot", "step_error", "delta_error",
         "corrupt_plan")
_POISON = ("nan_slot", "inf_slot")


class InjectedFault(RuntimeError):
    """A fault raised by the injector (never by real serving code)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: ``kind`` at scheduler ``step`` (1-based; for
    ``delta_error``/``corrupt_plan`` it is the 1-based ``apply_delta``
    call index). ``slot`` pins a poison fault to a column; ``None`` picks
    deterministically among the active slots."""
    kind: str
    step: int = 1
    slot: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.step < 1:
            raise ValueError(f"fault step must be >= 1; got {self.step}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic batch of faults and the seed of any unpinned
    choice (which active slot a poison lands on)."""
    specs: tuple[FaultSpec, ...] = ()
    seed: int = 0

    @staticmethod
    def of(specs: Sequence[FaultSpec], *, seed: int = 0) -> "FaultPlan":
        return FaultPlan(tuple(specs), seed)


class FaultInjector:
    """Stateful executor of one ``FaultPlan``: each spec fires exactly
    once. ``fired`` records what triggered, so a run can assert that the
    whole plan was covered."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired: list[FaultSpec] = []

    def _pending(self, kinds: tuple[str, ...], step: int):
        return [s for s in self.plan.specs
                if s.kind in kinds and s.step == step
                and s not in self.fired]

    # ------------------------------------------------- scheduler hooks
    def poisons(self, step: int,
                active_slots: Sequence[int]) -> list[tuple[int, str]]:
        """(slot, kind) poison writes due before stepper call ``step``.
        Unpinned specs pick among ``active_slots`` with
        ``default_rng(plan.seed + step)``, as the JAX package does; a
        spec with no eligible slot stays pending for a later step."""
        out = []
        for spec in self._pending(_POISON, step):
            slot = spec.slot
            if slot is None:
                if not active_slots:
                    continue
                rng = np.random.default_rng(self.plan.seed + step)
                slot = int(rng.choice(np.asarray(active_slots)))
            self.fired.append(spec)
            out.append((slot, spec.kind))
        return out

    def check_step(self, step: int) -> None:
        """Raise ``InjectedFault`` in place of stepper call ``step`` when
        the plan schedules a ``step_error`` there."""
        for spec in self._pending(("step_error",), step):
            self.fired.append(spec)
            raise InjectedFault(f"injected stepper failure at step "
                                f"{step}")

    # --------------------------------------------------- rebind hooks
    def check_delta(self, idx: int) -> None:
        for spec in self._pending(("delta_error",), idx):
            self.fired.append(spec)
            raise InjectedFault(f"injected apply_delta failure at "
                                f"delta {idx}")

    def wants_corrupt(self, idx: int) -> bool:
        for spec in self._pending(("corrupt_plan",), idx):
            self.fired.append(spec)
            return True
        return False

    @property
    def exhausted(self) -> bool:
        return len(self.fired) == len(self.plan.specs)


def corrupt_plan_arrays(plan):
    """A structurally corrupted COPY of ``plan``: the first populated
    index-array family gets an out-of-range entry. The copy's runtime
    cache is empty (``_device={}``), so neither the original's device
    uploads nor its "tile" gather order are ever served for it, and the
    original's arrays and uploads are left as they are (plans are shared
    through the process cache). What ``check_plan_integrity`` must catch
    before a rebind serves it."""
    bad_id = plan.num_nodes + 7
    kw: dict = {"_device": {}}
    if plan.png is not None:
        upd = plan.png.update_src.copy()
        upd[: max(1, upd.size // 64)] = bad_id
        kw["png"] = dataclasses.replace(plan.png, update_src=upd)
    elif plan.csc_src is not None:
        src = plan.csc_src.copy()
        src[:1] = -5
        kw["csc_src"] = src
    elif plan.bv_src is not None:
        src = plan.bv_src.copy()
        src[:1] = bad_id
        kw["bv_src"] = src
    elif plan.sharded is not None:
        send = plan.sharded.send_ids.copy()
        send.reshape(-1)[:1] = plan.sharded.shard_size + 7
        kw["sharded"] = dataclasses.replace(plan.sharded, send_ids=send)
    else:
        raise ValueError("plan has no index arrays to corrupt")
    return dataclasses.replace(plan, **kw)
