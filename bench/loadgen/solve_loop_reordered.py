"""Closed loop of whole PageRank solves from one caller on a plan whose
nodes are relabeled for locality (paper §VI-D1): ``solve_loop``, whose
set-up, window, check and control this module runs unchanged, with the
configuration's ``reorder`` given to ``EngineConfig``. The program
builds its layouts on the relabeled graph, iterates there and maps the
ranks back to the original ids; the check compares them, in the
original ids, with the plain reference's on the original arcs.

A configuration without ``reorder``, or with ``"none"``, is refused: it
is ``solve_loop``'s. In a traced run a ``repro_torch.obs``
``Observability`` bundle is attached from set-up on; it hears host
preprocessing only (no solve is traced), and its records are kept in
``run.extra["setup_spans"]`` for ``reorder_s``.

Traffic keys: ``solve_loop``'s.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

from bench import spec as specs

# solve_loop loaded for this load generator alone, so that its ``run``
# opens the session with this module's ``engine_config``
_loop = specs.load_module(Path(__file__).with_name("solve_loop.py"),
                          "bench_loadgen_solve_loop_for_reordered")
check, control = _loop.check, _loop.control
_plain_engine_config = _loop.engine_config


def ordering(config: dict) -> str:
    """The configuration's node ordering; raises without one."""
    reorder = config.get("reorder", "none")
    if reorder == "none":
        raise ValueError(
            f"configuration {config.get('name')!r} gives no reorder: "
            "solve_loop_reordered needs a node ordering (solve_loop runs "
            "the graph as labeled)")
    return reorder


def engine_config(run):
    return dataclasses.replace(_plain_engine_config(run),
                               reorder=ordering(run.config))


_loop.engine_config = engine_config


def run(run) -> None:
    ordering(run.config)
    obs = None
    if run.trace:
        from repro_torch.obs import Observability
        obs = Observability()
    try:
        _loop.run(run)
    finally:
        if obs is not None:
            run.extra["setup_spans"] = obs.recorder.snapshot()
            obs.close()
