"""GNN architectures: GraphCast (interaction-network MPNN), NequIP and
MACE (CG tensor-product equivariant), EquiformerV2 (eSCN SO(2) attention).

The counterpart of the JAX package's ``models/gnn.py``: ``GraphBatch``,
``random_graph_batch``, ``aggregate``, ``init_mlp``/``mlp``, the four
models' ``init_*``/``*_forward``, ``init_gnn``, ``gnn_forward``,
``gnn_loss`` and ``make_gnn_train_step``. The parameters live in an
``nn.Module`` (``GNN``) that keeps the reference's pytree: ``GNN.tree``
holds the same nested dicts and lists, its leaves the module's
parameters (named by their path: ``layers.3.edge_mlp.0.w``). The
forwards are plain functions over such a tree, as in the reference.

All message passing runs on the port's embedding-bag kernels, which are
each other's transpose:
- every node gather (``h[edge_src]``, ``h[edge_dst]``, the positions,
  the edge softmax's statistics) is ``embedding_lookup``: kernel B2 on
  one-id bags, and B2-bwd for the gradient of the gathered table;
- every segment-sum (``aggregate``, the softmax's denominators) is
  ``segment_sum``: B2-bwd, sorted and without float atomics, and B2 for
  its gradient.
So a training step repeats bit for bit. Only the edge softmax's
``segment_max`` is a torch op (``scatter_reduce`` "amax", which does not
depend on order); the max is held without a gradient, because the
softmax does not depend on it.

The reference's ``lax.scan`` over layers is a Python loop here, each
layer checkpointed (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``) when gradients are on. Its ``unroll_layers`` switch
serves only its HLO cost pass and is dropped; its ``shard(...)`` calls
place activations on a TPU mesh and are the identity on one card.
EquiformerV2 keeps the reference's edge chunks (8 strided chunks when
E >= 2**23 and 8 divides E), with the two-pass online softmax; with more
than one chunk each chunk's pass is checkpointed too, as the
reference's are, so the chunks bound the memory of the recompute.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import GNNConfig
from ..device import resolve_device
from ..kernels.embedding_bag.ops import embedding_lookup, segment_sum
from .equivariant import (bessel_rbf, cg_real, cg_tensor, rotation_to_z,
                          sh_basis, wigner_d)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the parameters (by the end of their names) whose gradient is zero in
# exact arithmetic, so that any two implementations, or the card and the
# CPU, give rounding noise there: equiformer-v2's attention bias (a
# softmax does not change when each head's logits shift alike) and
# mace's l = 1 third-order weights (CG(1,1 -> 1) is antisymmetric, so
# CG(A¹, A¹ -> 1) vanishes)
ZERO_GRADIENT_LEAVES = {"equiformer-v2": ("attn.1.b",), "mace": ("b3.1",)}
# EquiformerV2's edge chunks: 8 strided chunks from this many edges on
# (the reference's rule, ``models/gnn.py:435``)
_CHUNK_EDGES = 1 << 23
_CHUNKS = 8


# ------------------------------------------------------------------ data
@dataclasses.dataclass(frozen=True)
class GraphBatch:
    edge_src: torch.Tensor         # (E,) int32
    edge_dst: torch.Tensor         # (E,) int32
    edge_mask: torch.Tensor        # (E,) f32
    node_feat: torch.Tensor        # (N, d_feat)
    positions: torch.Tensor        # (N, 3)
    node_mask: torch.Tensor        # (N,) f32
    graph_id: torch.Tensor         # (N,) int32 (0 for single graph)
    n_graphs: int
    labels: torch.Tensor           # (N,) int32 node labels

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    def to(self, device) -> "GraphBatch":
        """The same batch with every tensor on ``device``."""
        dev = torch.device(device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dev)
            for f in dataclasses.fields(self) if f.name != "n_graphs"})

    @classmethod
    def from_numpy(cls, batch, *, device=None) -> "GraphBatch":
        """The batch whose fields are ``batch``'s attributes of the same
        names (the reference's ``GraphBatch``, or any object whose arrays
        numpy can read), copied to ``device`` (default ``"cuda"``)."""
        dev = resolve_device(device)
        return cls(**{
            f.name: (int(batch.n_graphs) if f.name == "n_graphs" else
                     torch.from_numpy(np.array(getattr(batch, f.name)))
                     .to(dev))
            for f in dataclasses.fields(cls)})


def random_graph_batch(rng: np.random.Generator, n_nodes: int,
                       n_edges: int, d_feat: int, *, n_graphs: int = 1,
                       n_classes: int = 8, device=None) -> GraphBatch:
    """The reference's random batch: the same draws from ``rng`` in the
    same order, so a seed gives the same arrays; on ``device`` (default
    ``"cuda"``)."""
    if n_graphs > 1:
        per = n_nodes // n_graphs
        gid = np.repeat(np.arange(n_graphs), per).astype(np.int32)
        src = (rng.integers(0, per, n_edges)
               + np.repeat(np.arange(n_graphs),
                           n_edges // n_graphs) * per)
        dst = (rng.integers(0, per, n_edges)
               + np.repeat(np.arange(n_graphs),
                           n_edges // n_graphs) * per)
    else:
        gid = np.zeros(n_nodes, np.int32)
        src = rng.integers(0, n_nodes, n_edges)
        dst = rng.integers(0, n_nodes, n_edges)
    pos = rng.standard_normal((n_nodes, 3))
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    feat = rng.standard_normal((n_nodes, d_feat))
    labels = rng.integers(0, n_classes, n_nodes)
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)
    return GraphBatch(put(src, np.int32), put(dst, np.int32),
                      torch.ones(n_edges, dtype=torch.float32, device=dev),
                      put(feat, np.float32), put(pos, np.float32),
                      torch.ones(n_nodes, dtype=torch.float32, device=dev),
                      put(gid, np.int32), n_graphs, put(labels, np.int32))


def aggregate(values: torch.Tensor, dst: torch.Tensor, num_nodes: int,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """PCPM-schedule aggregation: segment-sum by destination, each edge's
    values weighted by its mask (B2-bwd; B2 for the gradient)."""
    return segment_sum(values, dst, num_nodes, mask)


def _layers(layer_fn, carry, layers_list):
    """Run the per-layer bodies in order, each checkpointed when
    gradients are on (the reference's ``jax.checkpoint`` under its scan:
    only the layer boundaries stay live)."""
    for lyr in layers_list:
        if torch.is_grad_enabled():
            carry = checkpoint(layer_fn, carry, lyr, use_reentrant=False)
        else:
            carry = layer_fn(carry, lyr)
    return carry


# ------------------------------------------------------------ parameters
class GNN(nn.Module):
    """A GNN's parameters in the reference's pytree: ``tree`` gives the
    nested dicts and lists of ``init_gnn``'s output, its leaves this
    module's parameters (float32; a child module per dict or list, named
    by key or index). No parameter requires a gradient outside
    ``trainable()``."""

    def __init__(self, cfg: GNNConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        _register(self, tree)

    @property
    def tree(self) -> dict:
        return _tree_of(self)

    @contextlib.contextmanager
    def trainable(self):
        """Every parameter requires a gradient inside the block, and none
        after it."""
        self.requires_grad_(True)
        try:
            yield self
        finally:
            self.requires_grad_(False)


def _register(module: nn.Module, tree) -> None:
    """Register ``tree``'s tensors as parameters of ``module``, a child
    module per dict or list."""
    module.is_list = isinstance(tree, list)
    for k, v in (enumerate(tree) if module.is_list else tree.items()):
        if isinstance(v, torch.Tensor):
            module.register_parameter(str(k), nn.Parameter(
                v, requires_grad=False))
        else:
            child = nn.Module()
            module.add_module(str(k), child)
            _register(child, v)


def _tree_of(module: nn.Module):
    """The tree ``_register`` made ``module`` from, its leaves the
    module's parameters as they are now."""
    items = dict(module._parameters)
    items.update((k, _tree_of(c)) for k, c in module._modules.items())
    if module.is_list:
        return [items[str(i)] for i in range(len(items))]
    return items


def tree_map(fn, tree):
    """``fn`` applied to each leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(cfg: GNNConfig, tree: dict, *, device=None) -> GNN:
    """The port's ``GNN`` holding the parameters of the reference's
    ``init_gnn`` pytree given as numpy arrays, copied to ``device``
    (default ``"cuda"``)."""
    dev = resolve_device(device)
    return GNN(cfg, tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev), tree))


class _Init:
    """The reference's initialisers in torch: normal draws from one
    generator, in the reference's shapes and scales (``jax.random``
    cannot be reproduced; parity tests load the reference's parameters
    with ``params_from_numpy``)."""

    def __init__(self, generator, device):
        self.generator, self.device = generator, device

    def normal(self, shape, scale):
        return torch.randn(shape, generator=self.generator,
                           dtype=torch.float32, device=self.device) * scale

    def mlp(self, dims):
        return [{"w": self.normal((i, o), i ** -0.5),
                 "b": torch.zeros(o, dtype=torch.float32,
                                  device=self.device)}
                for i, o in zip(dims[:-1], dims[1:])]


# ------------------------------------------------------------------ MLPs
def init_mlp(dims, *, generator: torch.Generator | None = None,
             device=None) -> list:
    """[{"w": (i, o) normal · i**-0.5, "b": zeros (o,)}] per layer."""
    return _Init(generator, resolve_device(device)).mlp(dims)


def mlp(params, x):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1:
            x = F.silu(x)
    return x


# ============================================================= GraphCast
def init_graphcast(cfg: GNNConfig, init: _Init, d_feat: int,
                   n_out: int) -> dict:
    d = cfg.d_hidden
    return {
        "node_enc": init.mlp((d_feat, d, d)),
        "edge_enc": init.mlp((4, d, d)),       # [dist, unit vec]
        "dec": init.mlp((d, d, n_out)),
        "layers": [{"edge_mlp": init.mlp((3 * d, d, d)),
                    "node_mlp": init.mlp((2 * d, d, d))}
                   for _ in range(cfg.n_layers)],
    }


def _edge_vectors(g: GraphBatch) -> torch.Tensor:
    """positions[src] - positions[dst] (E, 3), both gathers on B2."""
    return (embedding_lookup(g.positions, g.edge_src)
            - embedding_lookup(g.positions, g.edge_dst))


def graphcast_forward(params: dict, cfg: GNNConfig,
                      g: GraphBatch) -> torch.Tensor:
    n = g.num_nodes
    h = mlp(params["node_enc"], g.node_feat)
    rel = _edge_vectors(g)
    dist = torch.sqrt(torch.sum(rel * rel, -1, keepdim=True) + 1e-18)
    e = mlp(params["edge_enc"], torch.cat([dist, rel], -1))

    def layer(carry, lyr):
        h, e = carry
        hs = embedding_lookup(h, g.edge_src)     # PCPM-deduped gather
        hd = embedding_lookup(h, g.edge_dst)
        e = e + mlp(lyr["edge_mlp"], torch.cat([e, hs, hd], -1))
        agg = aggregate(e, g.edge_dst, n, g.edge_mask)
        h = h + mlp(lyr["node_mlp"], torch.cat([h, agg], -1))
        return h, e

    h, e = _layers(layer, (h, e), params["layers"])
    return mlp(params["dec"], h)                 # (N, n_out)


# ====================================================== irreps utilities
def _irreps_cat(xs: list, n: int) -> torch.Tensor:
    """Concat per-l (N, C, 2l+1) irreps into one (N, C*sum(2l+1))."""
    return torch.cat([x.reshape(n, -1) for x in xs], -1)


def _irreps_split(x: torch.Tensor, c: int, l_max: int) -> list:
    out, off = [], 0
    for l in range(l_max + 1):
        d = c * (2 * l + 1)
        out.append(x[:, off:off + d].reshape(-1, c, 2 * l + 1))
        off += d
    return out


def _paths(l_max: int):
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l_max, l1 + l2) + 1):
                if cg_real(l1, l2, l3) is not None:
                    out.append((l1, l2, l3))
    return out


def _zeros_irreps(n: int, c: int, l_max: int, dtype=torch.float32,
                  device=None):
    return [torch.zeros((n, c, 2 * l + 1), dtype=dtype, device=device)
            for l in range(l_max + 1)]


def _edge_geometry(g: GraphBatch, cfg: GNNConfig):
    rel = _edge_vectors(g)
    dist = torch.sqrt(torch.sum(rel * rel, -1) + 1e-18)
    unit = rel / torch.clamp_min(dist[..., None], 1e-9)
    # degenerate (zero-length / self-loop) edges carry no direction:
    # zero their radial weights so every geometric message path vanishes
    # (keeps SO(3) equivariance exact — SH of a zero vector is undefined).
    valid = (dist > 1e-6).to(dist.dtype)
    rbf = bessel_rbf(dist, cfg.n_rbf, cfg.cutoff or 5.0) * valid[:, None]
    return rel, dist, unit, rbf


# ================================================================ NequIP
def init_nequip(cfg: GNNConfig, init: _Init, d_feat: int,
                n_out: int) -> dict:
    c, lm = cfg.d_hidden, cfg.l_max
    paths = _paths(lm)
    return {"embed": init.mlp((d_feat, c)),
            "readout": init.mlp((c, c, n_out)),
            "layers": [{"radial": init.mlp((cfg.n_rbf, c, len(paths) * c)),
                        "mix": [init.normal((c, c), c ** -0.5)
                                for _ in range(lm + 1)],
                        "gate": init.mlp((c, lm * c))}
                       for _ in range(cfg.n_layers)]}


def nequip_forward(params: dict, cfg: GNNConfig,
                   g: GraphBatch) -> torch.Tensor:
    n, c, lm = g.num_nodes, cfg.d_hidden, cfg.l_max
    paths = _paths(lm)
    _, dist, unit, rbf = _edge_geometry(g, cfg)
    sh = sh_basis(unit, lm)                      # per l: (E, 2l+1)
    ad = params["embed"][0]["w"].dtype
    dev = g.node_feat.device
    cgs = [cg_tensor(*p, ad, dev) for p in paths]
    h = _zeros_irreps(n, c, lm, ad, dev)
    h[0] = mlp(params["embed"], g.node_feat)[..., None]  # (N, C, 1)
    e_cnt = g.edge_src.shape[0]

    def layer(h, lyr):
        rw = mlp(lyr["radial"], rbf).reshape(-1, len(paths), c)  # (E,P,C)
        # ONE fused gather and ONE fused aggregate per layer: all l's
        # travel concatenated; per-path work stays edge-local.
        hs = _irreps_split(embedding_lookup(_irreps_cat(h, n), g.edge_src),
                           c, lm)
        msg_e: list = [None] * (lm + 1)
        for pi, (l1, l2, l3) in enumerate(paths):
            m = torch.einsum("eci,ej,ijk->eck", hs[l1], sh[l2], cgs[pi])
            m = m * rw[:, pi, :, None]
            msg_e[l3] = m if msg_e[l3] is None else msg_e[l3] + m
        agg = aggregate(_irreps_cat(msg_e, e_cnt), g.edge_dst, n,
                        g.edge_mask)
        msg = _irreps_split(agg, c, lm)
        # self-interaction + gated nonlinearity
        gates = torch.sigmoid(mlp(lyr["gate"], msg[0][..., 0])
                              ).reshape(n, lm, c) if lm else None
        out = list(h)
        for l in range(lm + 1):
            mixed = torch.einsum("eci,cd->edi", msg[l], lyr["mix"][l])
            if l == 0:
                out[0] = h[0] + F.silu(mixed)
            else:
                out[l] = h[l] + mixed * gates[:, l - 1, :, None]
        return out

    h = _layers(layer, h, params["layers"])
    return mlp(params["readout"], h[0][..., 0])          # (N, n_out)


# ================================================================== MACE
def init_mace(cfg: GNNConfig, init: _Init, d_feat: int, n_out: int) -> dict:
    c, lm = cfg.d_hidden, cfg.l_max

    def mats():
        return [init.normal((c, c), c ** -0.5) for _ in range(lm + 1)]
    return {"embed": init.mlp((d_feat, c)),
            "readout": init.mlp((c, c, n_out)),
            # product-basis weights per correlation order nu=2,3
            "layers": [{"radial": init.mlp((cfg.n_rbf, c, (lm + 1) * c)),
                        "b2": mats(), "b3": mats(), "mix": mats()}
                       for _ in range(cfg.n_layers)]}


def mace_forward(params: dict, cfg: GNNConfig,
                 g: GraphBatch) -> torch.Tensor:
    """Higher-order (ACE) message passing, correlation order 3:
    A-basis = neighbor sum of radial x SH x src scalars;
    B-basis  = A, CG(A,A), CG(CG(A,A),A) — symmetrized products."""
    n, c, lm = g.num_nodes, cfg.d_hidden, cfg.l_max
    nu = cfg.correlation_order
    _, dist, unit, rbf = _edge_geometry(g, cfg)
    sh = sh_basis(unit, lm)
    ad = params["embed"][0]["w"].dtype
    dev = g.node_feat.device
    h0 = mlp(params["embed"], g.node_feat)              # (N, C)
    e_cnt = g.edge_src.shape[0]

    def layer(h0, lyr):
        rw = mlp(lyr["radial"], rbf).reshape(-1, lm + 1, c)   # (E, L, C)
        # A-basis: A^l_i = sum_j R_l(r) Y_l(r̂) * h0_j — all l's
        # aggregate in ONE fused segment-sum.
        hs = embedding_lookup(h0, g.edge_src)
        m_e = [rw[:, l, :, None] * hs[:, :, None] * sh[l][:, None, :]
               for l in range(lm + 1)]
        agg = aggregate(_irreps_cat(m_e, e_cnt), g.edge_dst, n,
                        g.edge_mask)
        A = _irreps_split(agg, c, lm)
        out0 = torch.einsum("nci,cd->ndi", A[0], lyr["mix"][0])
        if nu >= 2:
            # B2^0 via CG(A^l, A^l -> 0); higher outputs folded to l=0
            for l in range(lm + 1):
                cgt = cg_tensor(l, l, 0, ad, dev)
                if cgt is None:
                    continue
                b2 = torch.einsum("nci,ncj,ijk->nck", A[l], A[l], cgt)
                out0 = out0 + torch.einsum("nci,cd->ndi", b2, lyr["b2"][l])
        if nu >= 3:
            for l in range(1, lm + 1):
                # CG(A^l, A^l -> l) then CG(. , A^l -> 0)
                c1 = cg_tensor(l, l, l, ad, dev)
                c2 = cg_tensor(l, l, 0, ad, dev)
                if c1 is None or c2 is None:
                    continue
                t = torch.einsum("nci,ncj,ijk->nck", A[l], A[l], c1)
                b3 = torch.einsum("nci,ncj,ijk->nck", t, A[l], c2)
                out0 = out0 + torch.einsum("nci,cd->ndi", b3, lyr["b3"][l])
        return h0 + F.silu(out0[..., 0])

    h0 = _layers(layer, h0, params["layers"])
    return mlp(params["readout"], h0)                    # (N, n_out)


# ========================================================= EquiformerV2
def init_equiformer(cfg: GNNConfig, init: _Init, d_feat: int,
                    n_out: int) -> dict:
    c, lm, mm = cfg.d_hidden, cfg.l_max, cfg.m_max
    lsz = lm + 1
    scale = (lsz * c) ** -0.5

    def layer():
        lyr = {"radial": init.mlp((cfg.n_rbf, c, c)),
               "attn": init.mlp((2 * c, c, cfg.n_heads)),
               "ffn": init.mlp((c, 2 * c, c)),
               "w0": init.normal((lsz, c, lsz, c), scale)}
        for m in range(1, mm + 1):
            lyr[f"w{m}_re"] = init.normal((lsz, c, lsz, c), scale)
            lyr[f"w{m}_im"] = init.normal((lsz, c, lsz, c), scale)
        return lyr
    return {"embed": init.mlp((d_feat, c)),
            "readout": init.mlp((c, c, n_out)),
            "layers": [layer() for _ in range(cfg.n_layers)]}


def _segment_softmax(logits, seg, num_segments):
    """Edge-softmax per destination; logits (E, ...) segments on axis 0."""
    mx = _segment_max(logits.detach(), seg, num_segments)
    e = torch.exp(logits - embedding_lookup(mx, seg))
    den = segment_sum(e, seg, num_segments)
    return e / torch.clamp_min(embedding_lookup(den, seg), 1e-9)


def _segment_max(values, seg, num_segments):
    """``jax.ops.segment_max`` over (E, k) values: -inf for a segment
    with no entry. ``scatter_reduce`` "amax", whose result does not
    depend on the order of the entries; no gradient."""
    out = torch.full((num_segments,) + values.shape[1:], -math.inf,
                     dtype=values.dtype, device=values.device)
    idx = seg.long()[:, None].expand_as(values)
    return out.scatter_reduce(0, idx, values, "amax", include_self=True)


def edge_chunks(e_cnt: int) -> int:
    """EquiformerV2's edge chunks for ``e_cnt`` edges (the reference's
    rule: a peak-memory knob only, totals are linear in edges)."""
    return _CHUNKS if e_cnt >= _CHUNK_EDGES and e_cnt % _CHUNKS == 0 else 1


def equiformer_forward(params: dict, cfg: GNNConfig,
                       g: GraphBatch) -> torch.Tensor:
    """eSCN attention: rotate source irreps into the edge frame (Wigner
    D), SO(2)-convolve the |m| <= m_max components (O(L^3) instead of the
    O(L^6) dense tensor product), rotate back, edge-softmax aggregate.

    Edges are processed in CHUNKS (strided): at l_max=6 the per-edge
    irreps are 128x49 floats, so a 62M-edge graph holds 1.5 TB of live
    edge features if materialized at once. The edge-softmax is online
    (a running max and rescaled denominator across chunks); the weighted
    aggregate is a second chunked pass that recomputes the edge math and
    accumulates into node space. The first pass needs only each edge's
    attention logits, so it rotates only the m = 0 component of each l
    and mixes only the l = 0 output (the values the logits read).
    """
    n, c, lm, mm = g.num_nodes, cfg.d_hidden, cfg.l_max, cfg.m_max
    nh = cfg.n_heads
    _, dist, unit, rbf = _edge_geometry(g, cfg)
    e_cnt = g.edge_src.shape[0]
    nch = edge_chunks(e_cnt)
    dims_tot = sum(2 * l + 1 for l in range(lm + 1))

    def chunked(x):
        """(E, ...) -> nch tensors of (E/nch, ...), chunk k holding
        edges k, k + nch, ..."""
        if nch == 1:
            return [x]
        return list(x.reshape(e_cnt // nch, nch, *x.shape[1:])
                    .movedim(1, 0).unbind(0))

    ch = [chunked(v) for v in (g.edge_src, g.edge_dst, g.edge_mask, rbf,
                               unit)]
    chunks = list(zip(*ch))

    ad = params["embed"][0]["w"].dtype
    dev = g.node_feat.device
    h = _zeros_irreps(n, c, lm, ad, dev)
    h[0] = mlp(params["embed"], g.node_feat)[..., None]

    def rotated(lyr, hcat, src, rbf_k, unit_k):
        rot = rotation_to_z(unit_k)
        dmats = [wigner_d(l, rot) for l in range(lm + 1)]
        rw = mlp(lyr["radial"], rbf_k)                # (Ek, C)
        hs = _irreps_split(embedding_lookup(hcat, src), c, lm)
        return dmats, rw, hs

    def edge_logits(lyr, hcat, h0row, src, dst, mask, rbf_k, unit_k):
        """The attention logits (Ek, nh): the l = 0 output of the m = 0
        SO(2) mix beside the destination's scalars."""
        dmats, rw, hs = rotated(lyr, hcat, src, rbf_k, unit_k)
        x0 = torch.stack([torch.einsum("ej,ecj->ec", dmats[l][:, l, :],
                                       hs[l]) for l in range(lm + 1)], 1)
        y00 = torch.einsum("elc,lcd->ed", x0, lyr["w0"][:, :, 0, :]) * rw
        inv = torch.cat([y00, embedding_lookup(h0row, dst)], -1)
        return (mlp(lyr["attn"], inv)
                + torch.log(torch.clamp_min(mask, 1e-9))[:, None])

    def edge_out(lyr, hcat, src, rbf_k, unit_k):
        """Heavy per-chunk math -> (out irreps, dmats)."""
        dmats, rw, hs = rotated(lyr, hcat, src, rbf_k, unit_k)
        xr = [torch.einsum("eij,ecj->eci", dmats[l], hs[l])
              for l in range(lm + 1)]
        # SO(2) conv: m=0 real mix across (l, c)
        x0 = torch.stack([xr[l][:, :, l] for l in range(lm + 1)], 1)
        y0 = torch.einsum("elc,lckd->ekd", x0, lyr["w0"]) * rw[:, None, :]
        cols = [[None] * (2 * l + 1) for l in range(lm + 1)]
        for l in range(lm + 1):
            cols[l][l] = y0[:, l, :]
        for m in range(1, mm + 1):
            ls = [l for l in range(lm + 1) if l >= m]
            xp = torch.stack([xr[l][:, :, l + m] for l in ls], 1)
            xm = torch.stack([xr[l][:, :, l - m] for l in ls], 1)
            wre = lyr[f"w{m}_re"][:len(ls), :, :len(ls), :]
            wim = lyr[f"w{m}_im"][:len(ls), :, :len(ls), :]
            yp = (torch.einsum("elc,lckd->ekd", xp, wre)
                  - torch.einsum("elc,lckd->ekd", xm, wim))
            ym = (torch.einsum("elc,lckd->ekd", xp, wim)
                  + torch.einsum("elc,lckd->ekd", xm, wre))
            for li, l in enumerate(ls):
                cols[l][l + m] = yp[:, li] * rw
                cols[l][l - m] = ym[:, li] * rw
        zero = y0.new_zeros(y0.shape[0], c)
        out = [torch.stack([zero if x is None else x for x in cols[l]], -1)
               for l in range(lm + 1)]
        return out, dmats

    def in_chunk(fn, *args):
        # one chunk of many: checkpointed, so a layer's recompute keeps
        # one chunk's edge math live at a time
        if nch > 1 and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def layer(h, lyr):
        hcat = _irreps_cat(h, n)
        h0row = h[0][:, :, 0]                          # (N, C)

        # pass 1: online edge-softmax statistics (running max + denom)
        def p1(mx, den, src, dst, mask, rbf_k, unit_k):
            logits = edge_logits(lyr, hcat, h0row, src, dst, mask, rbf_k,
                                 unit_k)
            mx_k = _segment_max(logits.detach(), dst, n)
            mx_new = torch.maximum(mx, mx_k.to(mx.dtype))
            scale = torch.exp(mx - mx_new)
            e_k = torch.exp(logits - embedding_lookup(mx_new, dst))
            den_new = den * scale + segment_sum(e_k, dst, n)
            return mx_new, den_new, logits

        mx = torch.full((n, nh), -1e30, dtype=torch.float32, device=dev)
        den = torch.zeros((n, nh), dtype=torch.float32, device=dev)
        logits_all = []
        for inp in chunks:
            mx, den, logits = in_chunk(p1, mx, den, *inp)
            logits_all.append(logits)

        # pass 2: recompute edge math, weight by softmax, aggregate
        def p2(acc, den, src, dst, mask, rbf_k, unit_k, logits):
            out, dmats = edge_out(lyr, hcat, src, rbf_k, unit_k)
            alpha = (torch.exp(logits - embedding_lookup(mx, dst))
                     / torch.clamp_min(embedding_lookup(den, dst), 1e-9))
            w_edge = alpha.mean(-1) * mask
            m_back = [torch.einsum("eji,ecj->eci", dmats[l], out[l])
                      * w_edge[:, None, None] for l in range(lm + 1)]
            part = aggregate(_irreps_cat(m_back, m_back[0].shape[0]),
                             dst, n)
            return acc + part.to(acc.dtype)

        acc = torch.zeros((n, c * dims_tot), dtype=torch.float32,
                          device=dev)
        for inp, logits in zip(chunks, logits_all):
            acc = in_chunk(p2, acc, den, *inp, logits)
        msg = _irreps_split(acc, c, lm)
        hn = [h[l] + msg[l].to(h[l].dtype) for l in range(lm + 1)]
        hn[0] = hn[0] + mlp(lyr["ffn"], hn[0][..., 0])[..., None]
        return hn

    h = _layers(layer, h, params["layers"])
    return mlp(params["readout"], h[0][..., 0])


# ----------------------------------------------------------- entry points
FORWARDS = {"graphcast": graphcast_forward, "nequip": nequip_forward,
            "mace": mace_forward, "equiformer-v2": equiformer_forward}
INITS = {"graphcast": init_graphcast, "nequip": init_nequip,
         "mace": init_mace, "equiformer-v2": init_equiformer}


def _arch(cfg: GNNConfig) -> str:
    return cfg.name.replace("-smoke", "")


def init_gnn(cfg: GNNConfig, d_feat: int, n_out: int, *,
             generator: torch.Generator | None = None, device=None) -> GNN:
    """Random float32 parameters in the reference's tree, shapes and
    scales, drawn from ``generator`` on ``device`` (default ``"cuda"``)."""
    init = _Init(generator, resolve_device(device))
    return GNN(cfg, INITS[_arch(cfg)](cfg, init, d_feat, n_out))


def gnn_forward(params, cfg: GNNConfig, g: GraphBatch) -> torch.Tensor:
    """(N, n_out) outputs of ``params`` (a ``GNN`` or its tree) on ``g``.
    With ``cfg.act_dtype`` bfloat16, the float32 parameters and the
    batch's float inputs get bfloat16 compute copies (the gradients flow
    through the casts back to the float32 masters)."""
    tree, cast = compute_copies(params, cfg)
    if cast is not None:
        g = dataclasses.replace(
            g, edge_mask=cast(g.edge_mask), node_feat=cast(g.node_feat),
            positions=cast(g.positions), node_mask=cast(g.node_mask))
    return FORWARDS[_arch(cfg)](tree, cfg, g)


def compute_copies(params, cfg: GNNConfig):
    """(tree, cast): the tree of ``params`` (a ``GNN`` or its tree) and,
    with ``cfg.act_dtype`` bfloat16, its bfloat16 compute copies and the
    cast that makes them of a float32 input (``cast`` None in float32)."""
    tree = params.tree if isinstance(params, GNN) else params
    ad = _DTYPES[cfg.act_dtype]
    if ad == torch.float32:
        return tree, None

    def cast(x):
        return x.to(ad) if x.dtype == torch.float32 else x
    return tree_map(cast, tree), cast


def gnn_loss(params, cfg: GNNConfig, g: GraphBatch, *,
             n_out: int) -> torch.Tensor:
    """Node classification: the mean over unmasked nodes of the
    cross-entropy of the float32 outputs against ``g.labels``."""
    out = gnn_forward(params, cfg, g)                 # (N, n_out)
    logp = torch.log_softmax(out.float(), -1)
    nll = -logp.gather(-1, g.labels.long()[:, None])[:, 0]
    return (torch.sum(nll * g.node_mask)
            / torch.clamp_min(g.node_mask.sum(), 1))


def make_gnn_train_step(cfg: GNNConfig, optimizer, *, n_out: int):
    """The reference's ``make_gnn_train_step``: ``step(params, opt_state,
    g) -> (params, opt_state, {"loss", "gnorm"})``, the metrics 0-d
    float32 tensors on the model's device (no host read). The optimizer
    (``optim.AdamW``) updates the ``GNN``'s parameters in place."""
    def step(params: GNN, opt_state, g: GraphBatch):
        names, tensors = zip(*params.named_parameters())
        with params.trainable():
            loss = gnn_loss(params, cfg, g, n_out=n_out)
            # a parameter that no output reads (the last layer's l > 0
            # weights of nequip, whose readout takes l = 0) gets zeros, as
            # the reference's gradient gives it
            grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                        materialize_grads=True)
        params, opt_state, gnorm = optimizer.update(
            dict(zip(names, grads)), opt_state, params)
        return params, opt_state, {"loss": loss.detach(), "gnorm": gnorm}
    return step


def kernel_calls(cfg: GNNConfig, n_edges: int, *,
                 train: bool = True) -> dict[str, int]:
    """The B2 and B2-bwd calls of one ``gnn_forward`` (``train`` False)
    or one training step at ``n_edges`` edges, counted from the model's
    structure. A forward gathers the positions twice, then per layer:
    graphcast 2 gathers and 1 aggregate; nequip and mace 1 and 1;
    equiformer per chunk 6 gathers and 2 segment-sums (pass 1: sources,
    destinations' scalars, running max, and the denominators' sum; pass
    2: sources, max, denominators, and the aggregate). A step runs each
    layer's forward again in its backward (checkpointed; equiformer's
    chunks once more when there are several), and each gather's gradient
    is one B2-bwd call, each segment-sum's one B2 call (the max has
    none)."""
    n_layers, arch = cfg.n_layers, _arch(cfg)
    if arch == "equiformer-v2":
        nch = edge_chunks(n_edges)
        fwd, bwd = (6 * nch, 2 * nch), (2 * nch, 4 * nch)
        forwards = 3 if nch > 1 else 2
    else:
        gathers = 2 if arch == "graphcast" else 1
        fwd, bwd = (gathers, 1), (1, gathers)
        forwards = 2
    if not train:
        return {"B2": 2 + n_layers * fwd[0], "B2-bwd": n_layers * fwd[1]}
    return {"B2": 2 + n_layers * (forwards * fwd[0] + bwd[0]),
            "B2-bwd": n_layers * (forwards * fwd[1] + bwd[1])}
