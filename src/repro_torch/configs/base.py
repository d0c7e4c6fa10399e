"""Configurations, input shapes and the ``--arch`` registry.

A copy of the JAX package's ``configs/base.py`` (``ShapeSpec``,
``LM_SHAPES``, ``GNN_SHAPES``, ``RECSYS_SHAPES``, ``LMConfig``,
``GNNConfig``, ``RecSysConfig``, ``register``, ``get``): the port imports
nothing of that package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

_REGISTRY: dict[str, object] = {}


def register(cfg) -> None:
    assert cfg.name not in _REGISTRY, f"duplicate arch {cfg.name}"
    _REGISTRY[cfg.name] = cfg


def get(name: str):
    if name not in _REGISTRY:
        # import side-effect registration
        from . import ALL_ARCHS  # noqa: F401
    return _REGISTRY[name]


def all_archs() -> list[str]:
    from . import ALL_ARCHS  # noqa: F401
    return sorted(_REGISTRY)


# ---------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode | long_decode |
                         # full_graph | minibatch | batched_graphs |
                         # recsys_train | recsys_serve | retrieval
    seq_len: int = 0
    global_batch: int = 0
    # graph shapes
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple = ()
    # recsys shapes
    n_candidates: int = 0


# ``train_4k`` is the LM training shape (``chip_smoke.py`` phase 13 runs
# its sequence of 4096 with the global batch cut); ``train_batch`` is kept
# as data until MIND training runs it
LM_SHAPES = (
    ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeSpec("long_500k", "long_decode", seq_len=524288, global_batch=1),
)

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "full_graph", n_nodes=2708, n_edges=10556,
              d_feat=1433),
    ShapeSpec("minibatch_lg", "minibatch", n_nodes=232965,
              n_edges=114_615_892, batch_nodes=1024, fanout=(15, 10),
              d_feat=602),
    ShapeSpec("ogb_products", "full_graph", n_nodes=2_449_029,
              n_edges=61_859_140, d_feat=100),
    ShapeSpec("molecule", "batched_graphs", n_nodes=30, n_edges=64,
              global_batch=128, d_feat=32),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "recsys_train", global_batch=65536),
    ShapeSpec("serve_p99", "recsys_serve", global_batch=512),
    ShapeSpec("serve_bulk", "recsys_serve", global_batch=262144),
    ShapeSpec("retrieval_cand", "retrieval", global_batch=1,
              n_candidates=1_000_000),
)


# --------------------------------------------------------------- configs
@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    family: str = "lm"
    head_dim: Optional[int] = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # attention
    window: Optional[int] = None       # sliding window (SWA)
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    source: str = ""

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def shapes(self):
        return LM_SHAPES

    @property
    def sub_quadratic(self) -> bool:
        """long_500k eligibility: SWA bounds the KV working set."""
        return self.window is not None

    def param_count(self) -> int:
        d, dh = self.d_model, self.dh
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) \
            + (self.n_heads * dh) * d
        if self.moe:
            ffn = self.n_experts * 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return (self.n_layers * per_layer + 2 * self.vocab * d + d)

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dead = (self.n_experts - self.top_k) * 3 * d * self.d_ff
        return self.param_count() - self.n_layers * dead

    def scaled(self, *, n_layers=2, d_model=128, n_heads=4, n_kv_heads=None,
               d_ff=256, vocab=512, n_experts=None, window=None):
        """Reduced config of the same family for CPU smoke tests."""
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=n_layers,
            d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv_heads or max(1, n_heads // 2), d_ff=d_ff,
            vocab=vocab, head_dim=None,
            n_experts=(self.n_experts and (n_experts or 4)),
            top_k=min(self.top_k, 2) if self.moe else 0,
            capacity_factor=8.0,   # no token drops at smoke-test scale
            window=window if window is not None else
            (64 if self.window else None))


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    family: str = "gnn"
    flavor: str = "mpnn"           # mpnn | equivariant | escn
    # graphcast
    mesh_refinement: int = 0
    aggregator: str = "sum"
    n_vars: int = 0
    # equivariant
    l_max: int = 0
    m_max: int = 0
    n_rbf: int = 0
    cutoff: float = 0.0
    correlation_order: int = 1
    n_heads: int = 0
    act_dtype: str = "float32"     # activation/message dtype (mixed
                                   # precision: bf16 on the big cells)
    source: str = ""

    @property
    def shapes(self):
        return GNN_SHAPES

    def scaled(self, **kw):
        """Reduced config of the same family for CPU smoke tests."""
        return dataclasses.replace(
            self, name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2),
            d_hidden=min(self.d_hidden, 32),
            l_max=min(self.l_max, 2), m_max=min(self.m_max, 1),
            mesh_refinement=min(self.mesh_refinement, 2),
            n_vars=min(self.n_vars, 8) if self.n_vars else 0,
            n_heads=min(self.n_heads, 2) if self.n_heads else 0, **kw)


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    embed_dim: int
    n_interests: int
    capsule_iters: int
    family: str = "recsys"
    vocab: int = 10_000_000        # item vocabulary (embedding rows)
    hist_len: int = 50             # user behaviour sequence length
    source: str = ""

    @property
    def shapes(self):
        return RECSYS_SHAPES

    def scaled(self, **kw):
        return dataclasses.replace(
            self, name=self.name + "-smoke", embed_dim=32, vocab=1000,
            hist_len=8, **kw)
