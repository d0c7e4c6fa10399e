"""The GNN slice's parts against the JAX package's: the configurations
(``GNNConfig``, ``GNN_SHAPES`` and the four GNNs), the graph generators
of GraphCast's multimesh and the molecule regime, the neighbor sampler,
``data.graphdata``, the equivariant substrate, and ``segment_sum``, the
GNNs' aggregation on kernels B2-bwd and B2.

Host arrays must be ``np.array_equal`` to the reference's; the torch
functions of ``models/equivariant.py`` are held to their ``jnp``
counterparts within 1e-6 (float32 rounding; measured at most 3e-7).
``segment_sum`` is held to ``jax.ops.segment_sum`` within rtol 1e-6,
atol 1e-6 (float32 sums in two orders), its gradient to torch autograd
through a plain ``index_add_`` within the same, and on sums that are
exact (multiples of 1/16) to B2-bwd's CPU emulation bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, data
from repro_torch.graphs import generators, sampler
from repro_torch.kernels.embedding_bag import (embedding_bag_bwd_emulate,
                                               kernel as b2_kernel,
                                               segment_sum)
from repro_torch.models import equivariant as eq
from repro_torch.models import gnn

from test_torch_gnn import one_torch_thread  # noqa: F401
from test_torch_reference import load_reference

ref_configs = load_reference("configs")
ref_gen = load_reference("graphs.generators")
ref_sampler = load_reference("graphs.sampler")
ref_graphdata = load_reference("data.graphdata")
ref_eq = load_reference("models.equivariant")

GNN_ARCHS = ["graphcast", "nequip", "mace", "equiformer-v2"]
TOL = dict(rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_configs_equal_the_reference(arch):
    mine, ref = configs.get(arch), ref_configs.get(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(mine.scaled())
            == dataclasses.asdict(ref.scaled()))
    assert (dataclasses.asdict(mine.scaled(act_dtype="bfloat16"))
            == dataclasses.asdict(ref.scaled(act_dtype="bfloat16")))
    assert mine.shapes is configs.GNN_SHAPES


def test_gnn_shapes_and_arch_order_equal_the_reference():
    assert ([dataclasses.asdict(s) for s in configs.GNN_SHAPES]
            == [dataclasses.asdict(s) for s in ref_configs.GNN_SHAPES])
    assert ([c.name for c in configs.ALL_ARCHS]
            == [c.name for c in ref_configs.ALL_ARCHS])
    assert configs.all_archs() == ref_configs.all_archs()


# ---------------------------------------------------------- generators
def test_icosahedron_and_subdivision_equal_the_reference():
    v, f = generators.icosahedron()
    rv, rf = ref_gen.icosahedron()
    assert np.array_equal(v, rv) and np.array_equal(f, rf)
    for _ in range(3):
        (v, f), (rv, rf) = (generators._subdivide(v, f),
                            ref_gen._subdivide(rv, rf))
        assert np.array_equal(v, rv) and np.array_equal(f, rf)


@pytest.mark.parametrize("refine", [0, 1, 2, 4])
def test_multimesh_equals_the_reference(refine):
    pos, g = generators.icosahedral_multimesh(refine)
    rpos, rg = ref_gen.icosahedral_multimesh(refine)
    assert g.num_nodes == rg.num_nodes == 10 * 4 ** refine + 2
    assert np.array_equal(pos, rpos)
    assert np.array_equal(g.src, rg.src) and np.array_equal(g.dst, rg.dst)


@pytest.mark.parametrize("n,atoms,edges,seed", [(4, 30, 64, 0),
                                                (128, 30, 64, 3)])
def test_batched_molecules_equal_the_reference(n, atoms, edges, seed):
    g, mol = generators.batched_molecules(n, atoms, edges, seed=seed)
    rg, rmol = ref_gen.batched_molecules(n, atoms, edges, seed=seed)
    assert g.num_nodes == rg.num_nodes
    assert np.array_equal(g.src, rg.src) and np.array_equal(g.dst, rg.dst)
    assert np.array_equal(mol, rmol)


# ------------------------------------------------------------- sampler
def _subgraphs_equal(a, b):
    assert a.seed_count == b.seed_count
    for f in ("nodes", "node_mask", "edge_src", "edge_dst", "edge_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_reference_sampler_fails_to_broadcast():
    """The reference's draw bounds (|F|,) against a size (|F|, f): it
    raises unless |F| == f (``graphs/sampler.py:44``); the port repairs
    it. This test fails if the reference is ever fixed."""
    rg = ref_gen.rmat(8, 8, seed=1)
    with pytest.raises(ValueError, match="broadcast"):
        ref_sampler.sample_neighbors(rg, np.arange(4), (3,),
                                     rng=np.random.default_rng(0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_neighbors_equals_the_reference_where_it_is_right(seed):
    """One seed and fanout 1 a hop: the reference's draw is right, and
    both consume the generator alike."""
    g = generators.rmat(9, 8, seed=seed)
    rg = ref_gen.rmat(9, 8, seed=seed)
    seeds = np.array([int(np.argmax(g.in_degree))])
    rng, ref_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):     # the second draw checks the generator's state
        _subgraphs_equal(sampler.sample_neighbors(g, seeds, (1, 1, 1),
                                                  rng=rng),
                         ref_sampler.sample_neighbors(rg, seeds, (1, 1, 1),
                                                      rng=ref_rng))
    assert rng.integers(1 << 30) == ref_rng.integers(1 << 30)


@pytest.mark.parametrize("fanouts", [(3,), (5, 3), (4, 2, 2)])
def test_sample_neighbors_draws_edges_of_the_graph(fanouts):
    g = generators.rmat(10, 8, seed=1)
    seeds = np.random.default_rng(2).choice(g.num_nodes, 32, replace=False)
    sub = sampler.sample_neighbors(g, seeds, fanouts,
                                   rng=np.random.default_rng(5))
    max_nodes = sampler._max_nodes(32, fanouts)
    assert max_nodes == ref_sampler._max_nodes(32, fanouts)
    max_edges = sum(32 * int(np.prod(fanouts[:i + 1]))
                    for i in range(len(fanouts)))
    assert sub.nodes.shape == sub.node_mask.shape == (max_nodes,)
    # edge slots: |F| x f per hop, at most the draw-free maximum
    assert sub.edge_src.shape == sub.edge_mask.shape
    assert 32 * fanouts[0] <= sub.edge_src.shape[0] <= max_edges
    assert sub.seed_count == 32 and np.array_equal(sub.nodes[:32], seeds)
    n_real = int(sub.node_mask.sum())
    assert np.unique(sub.nodes[:n_real]).size == n_real
    edges = set(zip(g.src.tolist(), g.dst.tolist()))
    ne = int(sub.edge_mask.sum())
    assert sub.edge_mask[:ne].all() and not sub.edge_mask[ne:].any()
    local = np.concatenate([sub.edge_src[:ne], sub.edge_dst[:ne]])
    assert local.max() < n_real
    for s, d in zip(sub.nodes[sub.edge_src[:ne]],
                    sub.nodes[sub.edge_dst[:ne]]):
        assert (int(s), int(d)) in edges
    # the first hop's edges (f for each seed with in-edges) end at the
    # seeds
    n1 = fanouts[0] * int((g.in_degree[seeds] > 0).sum())
    assert set(sub.edge_dst[:n1].tolist()) <= set(range(32))
    again = sampler.sample_neighbors(g, seeds, fanouts,
                                     rng=np.random.default_rng(5))
    _subgraphs_equal(sub, again)


def test_minibatch_stream_is_deterministic():
    g = generators.power_law(800, 6, seed=4)
    a = sampler.minibatch_stream(g, 16, (4, 3), seed=9)
    b = sampler.minibatch_stream(g, 16, (4, 3), seed=9)
    seen = []
    for _ in range(3):
        sa, sb = next(a), next(b)
        _subgraphs_equal(sa, sb)
        seen.append(sa.nodes[:16].tolist())
    assert seen[0] != seen[1]


# ------------------------------------------------------------ graphdata
def _batch_equals(mine, ref):
    assert mine.n_graphs == ref.n_graphs
    for f in dataclasses.fields(gnn.GraphBatch):
        if f.name == "n_graphs":
            continue
        x, y = getattr(mine, f.name).numpy(), np.asarray(getattr(ref, f.name))
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name


@pytest.mark.parametrize("name,d_feat", [("full_graph_sm", None),
                                         ("molecule", None),
                                         ("minibatch_lg", 4)])
def test_batch_for_shape_equals_the_reference(name, d_feat):
    shape = {s.name: s for s in configs.GNN_SHAPES}[name]
    ref_shape = {s.name: s for s in ref_configs.GNN_SHAPES}[name]
    mine = data.batch_for_shape(shape, seed=3, d_feat=d_feat, device="cpu")
    _batch_equals(mine, ref_graphdata.batch_for_shape(ref_shape, seed=3,
                                                      d_feat=d_feat))


def test_graph_for_shape_equals_the_reference():
    shape = {s.name: s for s in configs.GNN_SHAPES}["full_graph_sm"]
    ref_shape = {s.name: s for s in ref_configs.GNN_SHAPES}["full_graph_sm"]
    g = data.graph_for_shape(shape, seed=2)
    rg = ref_graphdata.graph_for_shape(ref_shape, seed=2)
    assert (g.num_nodes, g.num_edges) == (2708, 10556)
    assert np.array_equal(g.src, rg.src) and np.array_equal(g.dst, rg.dst)


@pytest.mark.parametrize("n_graphs", [1, 8])
def test_random_graph_batch_and_from_numpy(n_graphs):
    ref_gnn = load_reference("models.gnn")
    ref = ref_gnn.random_graph_batch(np.random.default_rng(4), 40, 160, 12,
                                     n_graphs=n_graphs)
    mine = gnn.random_graph_batch(np.random.default_rng(4), 40, 160, 12,
                                  n_graphs=n_graphs, device="cpu")
    _batch_equals(mine, ref)
    _batch_equals(gnn.GraphBatch.from_numpy(ref, device="cpu"), ref)
    assert mine.num_nodes == ref.num_nodes == 40
    moved = mine.to("cpu")
    assert moved.n_graphs == n_graphs and torch.equal(moved.labels,
                                                      mine.labels)


# ---------------------------------------------------------- equivariant
def _unit_vectors(n, seed=0):
    v = np.random.default_rng(seed).standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


def test_host_constants_equal_the_reference():
    for l in range(7):
        pts, pinv = eq._sample_points(l)
        rpts, rpinv = ref_eq._sample_points(l)
        assert np.array_equal(pts, rpts) and np.array_equal(pinv, rpinv)
    rot = np.asarray(ref_eq.rotation_to_z(jnp.asarray(_unit_vectors(5))),
                     np.float64)
    for l in range(7):
        assert np.array_equal(eq.wigner_d_np(l, rot),
                              ref_eq.wigner_d_np(l, rot))
    # every coupling the models build (l <= 2), and l = 3 beside them
    for l1 in range(4):
        for l2 in range(3):
            for l3 in range(4):
                mine, ref = eq.cg_real(l1, l2, l3), ref_eq.cg_real(l1, l2, l3)
                assert (mine is None) == (ref is None), (l1, l2, l3)
                if ref is not None:
                    assert np.array_equal(mine, ref), (l1, l2, l3)
    v = _unit_vectors(9, seed=2).astype(np.float64)
    for a, b in zip(eq._sh_numpy(v, 4), ref_eq._sh_numpy(v, 4)):
        assert np.array_equal(a, b)


def test_sh_rotation_and_wigner_match_jnp():
    v = _unit_vectors(64)
    for a, b in zip(eq.sh_basis(torch.from_numpy(v), 6),
                    ref_eq.sh_basis(jnp.asarray(v), 6)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    rot = eq.rotation_to_z(torch.from_numpy(v))
    ref_rot = ref_eq.rotation_to_z(jnp.asarray(v))
    np.testing.assert_allclose(rot.numpy(), np.asarray(ref_rot), **TOL)
    for l in range(7):
        np.testing.assert_allclose(
            eq.wigner_d(l, rot).numpy(),
            np.asarray(ref_eq.wigner_d(l, ref_rot)), **TOL)
    # the rotation takes each vector to z, and D_l(R) Y_l(v) = Y_l(R v)
    z = torch.einsum("eij,ej->ei", rot, torch.from_numpy(v))
    np.testing.assert_allclose(z.numpy(), np.tile([0, 0, 1], (64, 1)),
                               atol=1e-6)
    y2 = eq.sh_basis(torch.from_numpy(v), 2)[2]
    y2z = eq.sh_basis(z, 2)[2]
    np.testing.assert_allclose(
        torch.einsum("eij,ej->ei", eq.wigner_d(2, rot), y2).numpy(),
        y2z.numpy(), atol=1e-5)


def test_couple_and_bessel_match_jnp():
    rng = np.random.default_rng(1)
    for l1, l2, l3 in [(1, 1, 0), (1, 1, 2), (2, 1, 1), (2, 2, 2),
                       (0, 1, 2)]:
        x1 = rng.standard_normal((10, 2 * l1 + 1)).astype(np.float32)
        x2 = rng.standard_normal((10, 2 * l2 + 1)).astype(np.float32)
        mine = eq.couple(torch.from_numpy(x1), torch.from_numpy(x2),
                         l1, l2, l3)
        ref = ref_eq.couple(jnp.asarray(x1), jnp.asarray(x2), l1, l2, l3)
        if ref is None:
            assert mine is None
        else:
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **TOL)
    r = rng.uniform(0.0, 6.0, 50).astype(np.float32)
    r[:3] = 0.0                              # clamped to 1e-9
    np.testing.assert_allclose(
        eq.bessel_rbf(torch.from_numpy(r), 8, 5.0).numpy(),
        np.asarray(ref_eq.bessel_rbf(jnp.asarray(r), 8, 5.0)), **TOL)


def test_constants_take_the_input_dtype():
    v = torch.from_numpy(_unit_vectors(4)).bfloat16()
    rot = eq.rotation_to_z(v)
    assert rot.dtype == torch.bfloat16
    assert eq.wigner_d(3, rot).dtype == torch.bfloat16
    assert eq.cg_tensor(1, 1, 2, torch.bfloat16, "cpu").dtype == torch.bfloat16
    assert eq.cg_tensor(0, 1, 2, torch.float32, "cpu") is None


# ---------------------------------------------------------- segment_sum
def _segments(seed, e=300, n=37, dims=(3, 2)):
    rng = np.random.default_rng(seed)
    values = rng.standard_normal((e,) + dims).astype(np.float32)
    seg = rng.integers(-4, n + 4, e).astype(np.int32)   # some dropped
    mask = rng.uniform(0.0, 1.0, e).astype(np.float32)
    mask[rng.random(e) < 0.2] = 0.0
    return values, seg, mask, n


@pytest.mark.parametrize("dims", [(), (5,), (3, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_sum_matches_jax(dims, masked):
    values, seg, mask, n = _segments(0, dims=dims)
    ref = jax.ops.segment_sum(
        jnp.asarray(values) * (jnp.asarray(mask).reshape(
            (-1,) + (1,) * len(dims)) if masked else 1.0),
        jnp.asarray(seg), num_segments=n)
    mine = segment_sum(torch.from_numpy(values), torch.from_numpy(seg), n,
                       torch.from_numpy(mask) if masked else None)
    assert mine.shape == (n,) + dims and mine.dtype == torch.float32
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **TOL)


def test_segment_sum_drops_out_of_range_ids_and_zero_weights():
    values = torch.arange(1.0, 7.0)[:, None].repeat(1, 2)
    seg = torch.tensor([0, -1, 2, 5, 2, 0])
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 0.5])
    out = segment_sum(values, seg, 3, mask)
    assert torch.equal(out[:, 0], torch.tensor([1.0 + 3.0, 0.0, 5.0]))
    assert torch.equal(segment_sum(values, seg, 3)[:, 1],
                       torch.tensor([7.0, 0.0, 8.0]))


@pytest.mark.parametrize("masked", [False, True])
def test_segment_sum_gradient_matches_index_add(masked):
    values, seg, mask, n = _segments(1)
    gout = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (n, 3, 2)).astype(np.float32))
    v1 = torch.from_numpy(values).requires_grad_(True)
    w = torch.from_numpy(mask) if masked else None
    g1, = torch.autograd.grad(
        segment_sum(v1, torch.from_numpy(seg), n, w), v1, gout)
    v2 = torch.from_numpy(values).requires_grad_(True)
    keep = torch.from_numpy((seg >= 0) & (seg < n))
    scaled = v2 * (w[:, None, None] if masked else 1.0)
    plain = torch.zeros((n, 3, 2)).index_add(
        0, torch.from_numpy(seg)[keep].long(), scaled[keep])
    g2, = torch.autograd.grad(plain, v2, gout)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), **TOL)
    assert not g1[~keep].any()


def test_segment_sum_is_b2_bwd_bit_for_bit_on_exact_sums():
    """The CPU path against B2-bwd's own reduction order (its CPU
    emulation) with the ids and weights ``segment_sum`` hands it, on
    multiples of 1/16 times multiples of 1/4, with runs that cross
    B2-bwd's chunks."""
    rng = np.random.default_rng(3)
    e, n = 3 * b2_kernel.BWD_CHUNK + 17, 11
    values = torch.from_numpy(rng.integers(-16, 17, (e, 6)) / 16.0).float()
    seg = torch.from_numpy(rng.integers(-2, n + 2, e))
    w = torch.from_numpy(rng.integers(0, 5, e) / 4.0).float()
    out = segment_sum(values, seg, n, w)
    ids = torch.where(seg < 0, n, seg)[:, None]
    emulated = embedding_bag_bwd_emulate(values, ids, w[:, None], n,
                                         b2_kernel.BWD_CHUNK)
    assert torch.equal(out, emulated)


def test_segment_sum_rejects_what_it_cannot_take():
    v = torch.zeros((4, 2))
    with pytest.raises(ValueError):
        segment_sum(v, torch.zeros(3, dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        segment_sum(v, torch.zeros(4, dtype=torch.int64), 2, torch.ones(3))
    with pytest.raises(NotImplementedError):
        segment_sum(v, torch.zeros(4, dtype=torch.int64), 2,
                    torch.ones(4, requires_grad=True))
    with pytest.raises(TypeError):
        segment_sum(v.double(), torch.zeros(4, dtype=torch.int64), 2)


# ---------------------------------------------------- model helpers
def test_segment_softmax_matches_the_reference():
    """``gnn._segment_softmax`` (max by ``scatter_reduce``, sums on
    B2-bwd's plain version, gathers on B2's) against the reference's on
    logits with empty segments and a segment of one edge."""
    ref_gnn = load_reference("models.gnn")
    rng = np.random.default_rng(6)
    logits = (3 * rng.standard_normal((200, 4))).astype(np.float32)
    seg = rng.integers(0, 50, 200).astype(np.int32)
    seg[seg == 7] = 8                      # segment 7 empty
    seg[seg == 9] = 10
    seg[0] = 9                             # segment 9 a single edge
    mine = gnn._segment_softmax(torch.from_numpy(logits),
                                torch.from_numpy(seg), 60)
    ref = ref_gnn._segment_softmax(jnp.asarray(logits), jnp.asarray(seg), 60)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(mine.numpy()[0], 1.0, rtol=1e-6)


def test_init_mlp_draws_the_reference_shapes():
    ref_gnn = load_reference("models.gnn")
    dims = (7, 16, 3)
    ref = jax.eval_shape(lambda: ref_gnn.init_mlp(jax.random.key(0), dims))
    mine = gnn.init_mlp(dims, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert [{k: tuple(v.shape) for k, v in lyr.items()} for lyr in mine] == [
        {k: tuple(v.shape) for k, v in lyr.items()} for lyr in ref]
    assert not any(lyr["b"].any() for lyr in mine)
    x = torch.randn(5, 7)
    out = gnn.mlp(mine, x)
    want = ref_gnn.mlp(jax.tree.map(lambda t: jnp.asarray(t.numpy()), mine),
                       jnp.asarray(x.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
