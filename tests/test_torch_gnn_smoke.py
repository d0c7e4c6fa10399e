"""The JAX package's GNN smoke and property tests
(``tests/test_gnn_smoke.py``) run on the port, each protocol with its
tolerance: forward shapes and finite outputs, the batched molecule, a
falling loss over 8 train steps, rotation invariance of the equivariant
models' scalar outputs, graphcast's permutation equivariance, and a
masked padding edge that changes no output. Parameters come from the
port's ``init_gnn`` (a seeded ``torch.Generator``), graphs from
``random_graph_batch`` on the reference's numpy seeds, all on the CPU,
where every gather and segment-sum runs the plain versions of B2 and
B2-bwd."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import gnn
from repro_torch.optim import AdamW

from test_torch_gnn import one_torch_thread  # noqa: F401

GNN_ARCHS = ["graphcast", "nequip", "mace", "equiformer-v2"]


def make_batch(seed=0, n=40, e=160, d_feat=12, n_graphs=1):
    return gnn.random_graph_batch(np.random.default_rng(seed), n, e, d_feat,
                                  n_graphs=n_graphs, device="cpu")


def init(cfg, seed, d_feat, n_out):
    return gnn.init_gnn(cfg, d_feat, n_out, device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def forward(model, cfg, g):
    with torch.no_grad():
        return gnn.gnn_forward(model, cfg, g)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_shapes_finite(arch):
    cfg = configs.get(arch).scaled()
    g = make_batch()
    out = forward(init(cfg, 0, 12, 8), cfg, g)
    assert out.shape == (g.num_nodes, 8)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_batched_molecule_shape(arch):
    cfg = configs.get(arch).scaled()
    g = make_batch(n=64, e=256, n_graphs=8)
    out = forward(init(cfg, 1, 12, 4), cfg, g)
    assert out.shape == (64, 4)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_train_step_decreases_loss(arch):
    cfg = configs.get(arch).scaled()
    g = make_batch(seed=2)
    model = init(cfg, 2, 12, 8)
    opt = AdamW(lr=3e-3, weight_decay=0.0)
    state = opt.init(model)
    step = gnn.make_gnn_train_step(cfg, opt, n_out=8)
    losses = []
    for _ in range(8):
        model, state, m = step(model, state, g)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", ["nequip", "mace", "equiformer-v2"])
def test_rotation_invariance(arch):
    """Scalar (l=0) outputs must be invariant under global rotation of
    positions."""
    cfg = configs.get(arch).scaled()
    g = make_batch(seed=3)
    model = init(cfg, 3, 12, 8)
    out1 = forward(model, cfg, g)
    rng = np.random.default_rng(5)
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    g_rot = dataclasses.replace(
        g, positions=g.positions @ torch.from_numpy(rot).float().T)
    out2 = forward(model, cfg, g_rot)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_permutation_equivariance_graphcast():
    """Relabeling nodes permutes outputs correspondingly."""
    cfg = configs.get("graphcast").scaled()
    g = make_batch(seed=4)
    model = init(cfg, 4, 12, 8)
    out = forward(model, cfg, g)
    perm = torch.from_numpy(
        np.random.default_rng(6).permutation(g.num_nodes).astype(np.int32))
    inv = torch.argsort(perm)
    g_p = dataclasses.replace(
        g, edge_src=perm[g.edge_src.long()], edge_dst=perm[g.edge_dst.long()],
        node_feat=g.node_feat[inv], positions=g.positions[inv],
        node_mask=g.node_mask[inv], labels=g.labels[inv])
    out_p = forward(model, cfg, g_p)
    np.testing.assert_allclose(out_p.numpy(), out[inv].numpy(), rtol=1e-4,
                               atol=1e-5)


def test_edge_mask_zeroes_padding():
    """A padded (masked) edge must not change any output."""
    cfg = configs.get("graphcast").scaled()
    g = make_batch(seed=7)
    model = init(cfg, 7, 12, 8)
    out = forward(model, cfg, g)
    one = torch.ones(1, dtype=torch.int32)
    g2 = dataclasses.replace(
        g, edge_src=torch.cat([g.edge_src, 0 * one]),
        edge_dst=torch.cat([g.edge_dst, one]),
        edge_mask=torch.cat([g.edge_mask, torch.tensor([0.0])]))
    out2 = forward(model, cfg, g2)
    np.testing.assert_allclose(out.numpy(), out2.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_init_gnn_draws_the_reference_shapes():
    """The port's initialiser gives the tree, shapes and scales of the
    reference's ``init_gnn`` (normal weights at fan-in**-0.5, zero
    biases; ``(l+1)·c``-scaled SO(2) weights)."""
    from test_torch_reference import load_reference
    import jax
    ref_gnn = load_reference("models.gnn")
    ref_configs = load_reference("configs")
    for arch in GNN_ARCHS:
        cfg = configs.get(arch)
        ref = jax.eval_shape(lambda: ref_gnn.init_gnn(
            ref_configs.get(arch), jax.random.key(0), 16, 5))
        model = gnn.init_gnn(cfg, 16, 5, device="cpu")
        want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in p): tuple(x.shape)
                for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
        got = {n: tuple(p.shape) for n, p in model.named_parameters()}
        assert got == want, arch
    model = init(configs.get("graphcast").scaled(), 0, 300, 8)
    w = model.tree["node_enc"][0]["w"]
    assert abs(float(w.std()) * 300 ** 0.5 - 1.0) < 0.05
    assert not model.tree["node_enc"][0]["b"].any()
