"""Cell bookkeeping: (architecture × input shape) -> the reference's
``model_flops``, ``loop_trip`` and ``skip``, the counterpart of the JAX
package's ``launch/specs.py`` for a benchmark's model-flops share.

The cells, their ``model_flops`` formulas, ``loop_trip``, ``skip``
reasons and padding (``_pad512``) are the reference's. Its cells also
carry each step function with its arguments as shape trees (the inputs
of its HLO dry run), their ``in_shardings`` and ``rule_overrides`` (a
TPU mesh placement); those are left to the TPU (README.md, "Left to the
TPU"). On the card a cell runs its model's own step
(``transformer.make_train_step``, ``gnn.make_gnn_train_step``,
``gnn_dist.make_dist_train_step``, ``recsys.make_train_step``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..configs import GNNConfig, LMConfig, RecSysConfig, get
from ..configs.base import ShapeSpec

ARCHS = ("mixtral-8x7b", "grok-1-314b", "stablelm-1.6b", "tinyllama-1.1b",
         "deepseek-67b", "graphcast", "nequip", "mace", "equiformer-v2",
         "mind")


@dataclasses.dataclass(frozen=True)
class CellSpec:
    arch: str
    shape: str
    skip: Optional[str] = None   # reason if the cell is skipped
    loop_trip: int = 1           # the reference's layer-scan trip count
    model_flops: float = 0.0     # analytic 6*N*D (or family equivalent)


def _pad512(x: int) -> int:
    """Production graphs are padded at load time so node/edge streams
    divide every mesh axis product (512 covers 16x16 and 2x16x16), as
    the reference pads them."""
    return -(-x // 512) * 512


def lm_model_flops(cfg: LMConfig, shape: ShapeSpec) -> float:
    """6·N·D for a train step, 2·N·D for prefill and decode, N the
    active parameters."""
    n_active = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * b * s
    if shape.kind == "prefill":
        return 2.0 * n_active * b * s
    return 2.0 * n_active * b


def gnn_edges(shape: ShapeSpec) -> int:
    """The edges of a GNN cell's batch, padded by ``_pad512``."""
    if shape.kind == "batched_graphs":
        e = shape.n_edges * shape.global_batch
    elif shape.kind == "minibatch":
        e = sum(shape.batch_nodes * int(np.prod(shape.fanout[:i + 1]))
                for i in range(len(shape.fanout)))
    else:
        e = shape.n_edges
    return _pad512(e)


def gnn_model_flops(cfg: GNNConfig, n_edges: int) -> float:
    """The reference's GNN "model flops" proxy for one training step:
    6 x edges x d_hidden^2 x layers."""
    return 6.0 * n_edges * cfg.d_hidden ** 2 * cfg.n_layers


def recsys_model_flops(cfg: RecSysConfig, shape: ShapeSpec) -> float:
    """The capsule routing's 2·B·L·d²·iters, plus the in-batch softmax
    (train) or the candidates' scores (retrieval)."""
    b = shape.global_batch
    mf = 2.0 * b * cfg.hist_len * cfg.embed_dim ** 2 * cfg.capsule_iters
    if shape.kind == "recsys_train":
        return mf + 2.0 * b * b * cfg.embed_dim
    if shape.kind == "retrieval":
        return (mf + 2.0 * b * shape.n_candidates * cfg.embed_dim
                * cfg.n_interests)
    return mf


def skip(cfg, shape: ShapeSpec) -> Optional[str]:
    """Why the reference skips a cell, or None."""
    if (cfg.family == "lm" and shape.kind == "long_decode"
            and not cfg.sub_quadratic):
        return ("full-attention arch: 500k decode designated "
                "sub-quadratic-only (DESIGN.md §4)")
    return None


def make_cell(arch: str, shape_name: str, *, layers: int | None = None,
              engine: str = "xla") -> CellSpec:
    """The cell of ``arch`` at ``shape_name``, its depth cut to
    ``layers``. ``engine="pcpm"`` names the GNN full-graph cell over the
    PCPM-distributed exchange (``models/gnn_dist.py``), whose model
    flops are the same proxy at the same padded edges."""
    cfg = get(arch)
    shape = next(s for s in cfg.shapes if s.name == shape_name)
    work_cfg = cfg if layers is None else dataclasses.replace(
        cfg, n_layers=layers)
    name = cfg.name
    if engine == "pcpm":
        if cfg.family != "gnn" or shape.kind != "full_graph":
            raise ValueError("pcpm engine variant: GNN full-graph cells "
                             "only")
        name += "+pcpm"
    if cfg.family == "lm":
        return CellSpec(name, shape.name, skip(cfg, shape),
                        loop_trip=work_cfg.n_layers,
                        model_flops=lm_model_flops(cfg, shape))
    if cfg.family == "gnn":
        return CellSpec(name, shape.name, None, model_flops=gnn_model_flops(
            work_cfg, gnn_edges(shape)))
    return CellSpec(name, shape.name, None,
                    model_flops=recsys_model_flops(cfg, shape))


def all_cells() -> list[tuple[str, str]]:
    return [(arch, s.name) for arch in ARCHS for s in get(arch).shapes]
