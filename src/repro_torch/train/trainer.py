"""Training loop with checkpoint/restart, failure injection, straggler
accounting, and optional gradient compression: the counterpart of the
JAX package's ``train/trainer.py``, with the same logic.

Fault-tolerance model:
- checkpoint every N steps (atomic; ``checkpoint.save``),
- any step may raise (preemption, node loss): a restart resumes from the
  last checkpoint with bit-identical state (tested, on the card too:
  every kernel of the step sums in a fixed order),
- stragglers: per-step wall-time watchdog; steps slower than
  ``straggler_factor`` x the running median are counted and surfaced.

A step's metrics (0-d tensors on the device) are read to the host once
per step, in one copy.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from . import checkpoint as ckpt_lib


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    checkpoint_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro-ckpt")
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


def _host_metrics(metrics: dict) -> dict:
    """The metrics as Python floats, read from the device in one copy."""
    names = list(metrics)
    values = torch.stack([torch.as_tensor(metrics[n]).float().reshape(())
                          for n in names]).tolist()
    return dict(zip(names, values))


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 init_state: tuple, data: Iterator, *,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 log_fn: Callable = print):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = init_state          # (params, opt_state)
        self.data = data
        self.failure_hook = failure_hook
        self.log_fn = log_fn
        self.step = 0
        self.metrics_history: list[dict] = []
        self.straggler_steps: list[int] = []
        self._durations: list[float] = []

    # ------------------------------------------------------------ resume
    def try_resume(self) -> bool:
        last = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return False
        self.state, self.step = ckpt_lib.restore(
            self.cfg.ckpt_dir, self.state, step=last)[0], last
        self.log_fn(f"[trainer] resumed from step {last}")
        return True

    # -------------------------------------------------------------- run
    def run(self) -> dict:
        c = self.cfg
        while self.step < c.total_steps:
            batch = next(self.data)
            if self.failure_hook is not None:
                self.failure_hook(self.step)     # may raise (preemption)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(
                self.state[0], self.state[1], batch)
            metrics = _host_metrics(metrics)
            dt = time.perf_counter() - t0
            self.state = (params, opt_state)
            self.step += 1
            self._watch_stragglers(dt)
            metrics["step_time_s"] = dt
            self.metrics_history.append(metrics)
            if self.step % c.log_every == 0:
                self.log_fn(f"[trainer] step {self.step} "
                            f"loss={metrics.get('loss', float('nan')):.4f} "
                            f"({dt * 1e3:.0f} ms)")
            if self.step % c.checkpoint_every == 0:
                ckpt_lib.save(c.ckpt_dir, self.step, self.state,
                              keep=c.keep_checkpoints)
        ckpt_lib.save(c.ckpt_dir, self.step, self.state,
                      keep=c.keep_checkpoints)
        return {"final_step": self.step,
                "stragglers": list(self.straggler_steps),
                "history": self.metrics_history}

    def _watch_stragglers(self, dt: float):
        self._durations.append(dt)
        if len(self._durations) >= 8:
            med = float(np.median(self._durations[-64:]))
            if dt > self.cfg.straggler_factor * med:
                self.straggler_steps.append(self.step)
                self.log_fn(f"[trainer] straggler step {self.step}: "
                            f"{dt:.3f}s vs median {med:.3f}s")
