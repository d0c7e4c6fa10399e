"""PCPM-distributed GraphCast: message passing over the sharded PNG.

The counterpart of the JAX package's ``models/gnn_dist.py``. A plain
distributed GNN would all-gather the full node tensor for ``h[edge_src]``
and all-reduce full-size partial sums (the distributed analogue of
BVGAS). Here the paper's technique carries the messages instead:

  scatter phase   each shard sends h[u] ONCE per destination shard that
                  needs it (the deduplicated ``send_ids`` of
                  ``core.distributed.ShardedPNG``) in one all-to-all of
                  dense (S, U, c) buffers;
  gather phase    each shard expands its receive buffer over its local
                  edge list (``edge_upd``) and segment-sums into its own
                  destinations only.

The reference drives S devices from one process under ``shard_map``;
here each rank of a ``ShardMesh`` (``core/distributed.py``, one rank a
shard) runs the per-shard body of the reference's ``local`` on its own
rows. Every gather (the send buffers, ``recv[edge_upd]``, ``h[dst]``,
the positions) is ``embedding_lookup``: kernel B2 on the card, B2-bwd for
its gradient. The aggregate is ``segment_sum``: B2-bwd, and B2 for its
gradient. The exchange is an autograd function around
``ShardMesh.all_to_all``, whose backward is the all-to-all of the
incoming gradient (an equal-split all-to-all is its own transpose).

SPMD contract: every rank of the world is in the mesh and makes the same
calls in the same order, so each issues the same collectives, including
the all-to-alls that the checkpointed layers run again in backward.

``dist_graph_shardings`` (a JAX ``NamedSharding`` tree) is left to the
TPU (README.md, "Left to the TPU"): ``DistGraph.from_png`` uploads each
rank's own slices, which is what that placement does on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..configs.base import GNNConfig
from ..core.distributed import ShardedPNG, ShardMesh, _upload
from ..device import _NARROW
from ..kernels.embedding_bag.ops import embedding_lookup, segment_sum
from . import gnn
from .gnn import init_graphcast, mlp

__all__ = ["DistGraph", "graphcast_dist_forward", "dist_loss_and_grads",
           "make_dist_train_step", "estimate_u_max", "init_graphcast",
           "dist_kernel_calls", "dist_collective_calls"]


def _host(a) -> np.ndarray:
    """``a`` as a host array, 64-bit types narrowed as ``jnp.asarray``
    narrows them."""
    a = np.asarray(a)
    return a.astype(_NARROW.get(a.dtype, a.dtype), copy=False)


@dataclasses.dataclass(frozen=True)
class _Shard:
    """This rank's slices of a ``DistGraph`` on its device: the send ids
    with pad -1 moved to ``shard_size`` (an id past the table's rows,
    which B2 reads as a zero row; B2 reads row 0 for a negative id), the
    edge streams, the clipped destinations the gathers read (pad edges
    read row ``shard_size - 1``, as the reference clips), the pad mask,
    and the node rows."""
    shard: int
    send: torch.Tensor          # (S * U,) int32
    edge_upd: torch.Tensor      # (E,) int32, pad S * U
    edge_dst: torch.Tensor      # (E,) int32, pad shard_size
    dst_rows: torch.Tensor      # (E,) int32, clipped to shard_size - 1
    valid: torch.Tensor         # (E,) float32, 0 on pad edges
    node_feat: torch.Tensor     # (shard_size, d_feat)
    positions: torch.Tensor     # (shard_size, 3)
    labels: torch.Tensor        # (shard_size,)


@dataclasses.dataclass(frozen=True, eq=False)
class DistGraph:
    """Per-shard static-shape graph structures (leading axis = shard), as
    the reference's, in host numpy arrays (``from_png``); ``local`` holds
    this rank's slices on its device. The reference's ``abstract`` (the
    fields as shape structs, for its dry run) is left to the TPU
    (README.md, "Left to the TPU")."""
    num_shards: int
    shard_size: int          # nodes per shard
    u_max: int               # updates per (src, dst) shard pair
    e_max: int               # edges per destination shard
    send_ids: Any            # (S, S, U) local src ids, pad -1
    edge_upd: Any            # (S, E) recv-buffer index, pad S*U
    edge_dst: Any            # (S, E) local dst ids, pad shard_size
    node_feat: Any           # (S*shard_size, d_feat)
    positions: Any           # (S*shard_size, 3)
    labels: Any              # (S*shard_size,)
    local: _Shard = dataclasses.field(repr=False)

    @staticmethod
    def from_png(layout: ShardedPNG, node_feat, positions, labels, *,
                 mesh: ShardMesh) -> "DistGraph":
        """The graph of ``layout`` with its padded node arrays
        (``pad_to_shards``), kept on the host; this rank's slices are
        uploaded to ``mesh.device``. Every rank of the world must be in
        the mesh, and the mesh must have the layout's shard count."""
        if mesh.shard is None or mesh.world_size != mesh.num_shards:
            raise ValueError("the distributed GNN needs every rank in the "
                             "mesh (num_shards == world size)")
        if layout.num_shards != mesh.num_shards:
            raise ValueError(f"layout has {layout.num_shards} shards, the "
                             f"mesh {mesh.num_shards}")
        s, ssz = mesh.shard, layout.shard_size
        feat, pos, lab = _host(node_feat), _host(positions), _host(labels)
        if not feat.shape[0] == pos.shape[0] == lab.shape[0] == (
                layout.padded_nodes):
            raise ValueError(f"node arrays must have {layout.padded_nodes} "
                             f"rows (pad_to_shards); got {feat.shape[0]}, "
                             f"{pos.shape[0]}, {lab.shape[0]}")
        send = layout.send_ids[s].reshape(-1)
        dst = layout.edge_dst[s]
        rows = slice(s * ssz, (s + 1) * ssz)
        local = _Shard(
            s, _upload(np.where(send < 0, ssz, send), mesh),
            _upload(layout.edge_upd[s], mesh), _upload(dst, mesh),
            _upload(np.minimum(dst, ssz - 1), mesh),
            _upload((dst < ssz).astype(np.float32), mesh),
            _upload(feat[rows], mesh), _upload(pos[rows], mesh),
            _upload(lab[rows], mesh))
        return DistGraph(layout.num_shards, ssz,
                         int(layout.send_ids.shape[2]),
                         int(layout.edge_upd.shape[1]), layout.send_ids,
                         layout.edge_upd, layout.edge_dst, feat, pos, lab,
                         local)


class _Exchange(torch.autograd.Function):
    """The PCPM wire phase: the (S·U, c) send buffers through one
    all-to-all into a (S·U + 1, c) receive buffer whose last row is the
    zero slot that pad edges read. The backward is the all-to-all of the
    incoming gradient's first S·U rows."""

    @staticmethod
    def forward(ctx, bufs, mesh):
        recv = bufs.new_empty((bufs.shape[0] + 1, bufs.shape[1]))
        recv[-1] = 0
        mesh.all_to_all(recv[:-1], bufs.contiguous())
        ctx.mesh = mesh
        return recv

    @staticmethod
    def backward(ctx, grad):
        out = grad.new_empty((grad.shape[0] - 1, grad.shape[1]))
        ctx.mesh.all_to_all(out, grad[:-1].contiguous())
        return out, None


def _shard_of(g: DistGraph, mesh: ShardMesh) -> _Shard:
    if mesh.num_shards != g.num_shards or mesh.shard != g.local.shard:
        raise ValueError(f"the graph holds shard {g.local.shard} of "
                         f"{g.num_shards}; this rank is shard {mesh.shard} "
                         f"of {mesh.num_shards}")
    return g.local


def _local_forward(params, cfg: GNNConfig, g: DistGraph,
                   mesh: ShardMesh) -> torch.Tensor:
    """This rank's (shard_size, n_out) outputs: the reference's
    per-device ``local``, in ``cfg.act_dtype`` (bfloat16 compute copies
    of the float32 parameters and inputs, as ``gnn.gnn_forward``)."""
    loc = _shard_of(g, mesh)
    ssz = g.shard_size
    tree, cast = gnn.compute_copies(params, cfg)
    node_feat, positions = loc.node_feat, loc.positions
    if cast is not None:
        node_feat, positions = cast(node_feat), cast(positions)
    h = mlp(tree["node_enc"], node_feat)                 # (ssz, d)

    def exchange(x):
        """(ssz, c) -> the receive buffer (S*U + 1, c)."""
        return _Exchange.apply(embedding_lookup(x, loc.send), mesh)

    # edge geometry from exchanged positions
    rel = (embedding_lookup(exchange(positions), loc.edge_upd)
           - embedding_lookup(positions, loc.dst_rows))
    dist = torch.sqrt(torch.sum(rel * rel, -1, keepdim=True) + 1e-18)
    e0 = mlp(tree["edge_enc"], torch.cat([dist, rel], -1))

    def layer(carry, lyr):
        h, e = carry
        hs = embedding_lookup(exchange(h), loc.edge_upd)    # (E, d)
        hd = embedding_lookup(h, loc.dst_rows)
        e = e + mlp(lyr["edge_mlp"], torch.cat([e, hs, hd], -1))
        agg = segment_sum(e, loc.edge_dst, ssz + 1, loc.valid)[:ssz]
        h = h + mlp(lyr["node_mlp"], torch.cat([h, agg], -1))
        return h, e

    h, _ = gnn._layers(layer, (h, e0), tree["layers"])
    return mlp(tree["dec"], h)


def graphcast_dist_forward(params, cfg: GNNConfig, g: DistGraph,
                           mesh: ShardMesh) -> torch.Tensor:
    """GraphCast forward with PCPM-exchange message passing: the math of
    ``gnn.graphcast_forward`` on a graph whose edges are the sharded-PNG
    streams. Returns the full (S·shard_size, n_out) outputs on every
    rank (one all-gather), in ``cfg.act_dtype``. Layers are checkpointed
    when gradients are on; the all-gather passes no gradient."""
    local = _local_forward(params, cfg, g, mesh)
    out = local.new_empty((g.num_shards * g.shard_size, local.shape[1]))
    mesh.all_gather(out, local.detach().contiguous())
    return out


def dist_loss_and_grads(params: gnn.GNN, cfg: GNNConfig, g: DistGraph,
                        mesh: ShardMesh):
    """The loss of ``make_dist_train_step`` and its gradient, the same on
    every rank: (0-d float32 loss, {parameter name: gradient}). The loss
    is the reference's: the mean NLL over all S·shard_size rows, pad rows
    included (zero features, label 0). Each rank takes the gradient of
    its own rows' share of it; the gradients are summed over the mesh in
    one all-reduce of a flat buffer, the detached loss in one more."""
    labels = _shard_of(g, mesh).labels
    names, tensors = zip(*params.named_parameters())
    with params.trainable():
        out = _local_forward(params, cfg, g, mesh)
        logp = torch.log_softmax(out.float(), -1)
        nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
        loss = nll.sum() / (g.num_shards * g.shard_size)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                    materialize_grads=True)
    flat = mesh.all_reduce(torch.cat([x.reshape(-1) for x in grads]))
    grads = {n: part.view_as(t) for n, t, part in zip(
        names, tensors, flat.split([t.numel() for t in tensors]))}
    return mesh.all_reduce(loss.detach().clone()), grads


def make_dist_train_step(cfg: GNNConfig, optimizer, mesh: ShardMesh, *,
                         n_out: int):
    """``step(params, opt_state, g) -> (params, opt_state, {"loss",
    "gnorm"})`` over the mesh, the metrics 0-d float32 tensors (no host
    read): ``dist_loss_and_grads``, then ``optimizer.update`` alike on
    every rank, so the parameters stay the same bits everywhere."""
    def step(params: gnn.GNN, opt_state, g: DistGraph):
        loss, grads = dist_loss_and_grads(params, cfg, g, mesh)
        params, opt_state, gnorm = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}
    return step


# -------------------------------------------------------- launch counts
def dist_kernel_calls(cfg: GNNConfig, *, train: bool = True
                      ) -> dict[str, int]:
    """The B2 and B2-bwd calls of one ``graphcast_dist_forward`` (``train``
    False) or one step of ``make_dist_train_step``, from the structure.
    A forward gathers three times for the geometry (the positions' send
    buffers, ``recv[edge_upd]``, ``positions[dst]``), then per layer
    three times (the send buffers, ``recv[edge_upd]``, ``h[dst]``) and
    aggregates once. A step runs each layer's forward again in its
    backward (checkpointed), then each gather's gradient is one B2-bwd
    call and the aggregate's one B2 call; the positions take no
    gradient."""
    n = cfg.n_layers
    if not train:
        return {"B2": 3 + 3 * n, "B2-bwd": n}
    return {"B2": 3 + n * (2 * 3 + 1), "B2-bwd": n * (2 * 1 + 3)}


def dist_collective_calls(cfg: GNNConfig, *, train: bool = True
                          ) -> dict[str, int]:
    """The collectives of one forward or one training step on a mesh with
    a process group, by ``ShardMesh.counts`` name: an all-to-all for the
    positions and one per layer (a step: per layer again in the
    recompute and once in the backward); a forward all-gathers the
    outputs once, a step all-reduces the gradients and the loss."""
    n = cfg.n_layers
    if not train:
        return {"all_to_all_single": 1 + n, "all_reduce": 0,
                "all_gather": 1}
    return {"all_to_all_single": 1 + 3 * n, "all_reduce": 2,
            "all_gather": 0}


# --------------------------------------------------- layout estimation
def estimate_u_max(n: int, e: int, s: int, *, skew: float = 4.0) -> int:
    """Padded updates per shard pair for a uniform-ish graph: unique
    sources u_p = Ns(1 - exp(-m_p/Ns)), padded by ``skew`` for degree
    skew, rounded to 128."""
    ns, mp = n / s, e / (s * s)
    u = ns * (1.0 - np.exp(-mp / ns)) * skew
    return max(128, int(-(-u // 128) * 128))
