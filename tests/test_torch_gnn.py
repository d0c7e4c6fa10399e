"""The four GNNs of the port against the JAX package's, on the same
parameters and graphs: ``gnn_forward``, ``gnn_loss`` and the gradient of
``jax.value_and_grad``, in float32 and once in bfloat16.

The reference's ``init_gnn`` draws the parameters at the smoke size
(``get(arch).scaled()``: 2 layers, d 32, l_max 2, m_max 1, 2 heads);
``params_from_numpy`` loads them into the port. Graphs come from
``random_graph_batch`` on one numpy seed in both packages (40 nodes, 160
edges, 12 features, one graph or 8), self-loops included. On the CPU
every gather and segment-sum runs the plain versions of B2 and B2-bwd
through the same autograd functions as on the card. Held:

- outputs and loss within rtol 1e-5 and an atol of 1e-6 times the
  largest output's magnitude (at least 1): an output near zero carries
  the float32 rounding of sums as large as the largest one (measured:
  graphcast, one graph, an output of 0.026 off by 1.45e-6 where outputs
  reach 13.6; mace, 8 graphs, 1.7e-4 on outputs up to 103.5; losses
  within 1e-7);
- each gradient leaf within a relative L2 error of 1e-5 (measured at
  most 3.7e-6, ``layers.0.attn.0.b`` of equiformer-v2; most below 1e-6).
  Two leaves have a gradient that is zero in exact arithmetic, so both
  packages give rounding noise (measured 1e-10 to 8e-10 against norms of
  order 1): equiformer-v2's attention bias ``attn.1.b`` (a softmax does
  not change when each head's logits shift alike) and mace's ``b3.1``
  (CG(1,1 -> 1) is antisymmetric, so CG(A¹, A¹ -> 1) vanishes):
  ``gnn.ZERO_GRADIENT_LEAVES``. Those are held to norms below 1e-8 of
  the whole gradient's on both sides;
- in bfloat16 (``act_dtype``, float32 masters) outputs within a relative
  L2 error of 5e-2: XLA and torch round bfloat16 at other places
  (measured 5.0e-3 to 1.2e-2);
- equiformer-v2's 8-chunk online softmax (forced below its 2**23-edge
  rule) against its one chunk within rtol 1e-5 (measured 4e-7);
- the B2 and B2-bwd calls of a forward and of a train step equal
  ``gnn.kernel_calls``, counted at the autograd functions' entry points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from repro_torch import configs
from repro_torch.kernels.embedding_bag import ops as b2_ops
from repro_torch.models import gnn
from repro_torch.optim import AdamW

from test_torch_reference import load_reference

ref_configs = load_reference("configs")
ref_gnn = load_reference("models.gnn")

GNN_ARCHS = ["graphcast", "nequip", "mace", "equiformer-v2"]
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL_L2 = 1e-5
ZERO_GRAD_NORM = 1e-8
BF16_REL_L2 = 5e-2
N_NODES, N_EDGES, D_FEAT, N_OUT = 40, 160, 12, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One thread for torch's and numpy's BLAS in each module that
    imports this fixture: the port's CPU ops on (40, 32)-sized tensors and
    the equivariant constants' small SVDs gain nothing from threads, and
    under parallel test workers the threads contend (``cg_real`` up to
    l = 3 took 4.3 s with OpenBLAS's threads and 0.2 s with one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def leaf_name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def setup(arch, seed, *, n_graphs=1, **kw):
    """(cfg, model, graph) of the port and (cfg, params, graph) of the
    reference, on the reference's parameters."""
    ref_cfg = ref_configs.get(arch).scaled(**kw)
    cfg = configs.get(arch).scaled(**kw)
    params = ref_gnn.init_gnn(ref_cfg, jax.random.key(seed), D_FEAT, N_OUT)
    model = gnn.params_from_numpy(cfg, jax.tree.map(np.array, params),
                                  device="cpu")
    ref_g = ref_gnn.random_graph_batch(np.random.default_rng(seed), N_NODES,
                                       N_EDGES, D_FEAT, n_graphs=n_graphs)
    g = gnn.random_graph_batch(np.random.default_rng(seed), N_NODES,
                               N_EDGES, D_FEAT, n_graphs=n_graphs,
                               device="cpu")
    return (cfg, model, g), (ref_cfg, params, ref_g)


def port_grads(model, cfg, g):
    names, tensors = zip(*model.named_parameters())
    with model.trainable():
        loss = gnn.gnn_loss(model, cfg, g, n_out=N_OUT)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("n_graphs", [1, 8])
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_loss_and_gradients_match_the_reference(arch, n_graphs):
    (cfg, model, g), (ref_cfg, params, ref_g) = setup(arch, 0,
                                                      n_graphs=n_graphs)
    with torch.no_grad():
        out = gnn.gnn_forward(model, cfg, g)
    ref_out = ref_gnn.gnn_forward(params, ref_cfg, ref_g)
    assert out.shape == (N_NODES, N_OUT) and out.dtype == torch.float32
    ref_out = np.asarray(ref_out)
    scale = max(1.0, float(np.abs(ref_out).max()))
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=OUT_TOL["rtol"],
                               atol=OUT_TOL["atol"] * scale)

    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: ref_gnn.gnn_loss(p, ref_cfg, ref_g, n_out=N_OUT))(params)
    loss, grads = port_grads(model, cfg, g)
    np.testing.assert_allclose(float(loss), float(ref_loss), **OUT_TOL)
    leaves = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert {leaf_name(p) for p, _ in leaves} == set(grads)
    total = np.sqrt(sum(float(jnp.sum(jnp.square(x))) for _, x in leaves))
    zero = gnn.ZERO_GRADIENT_LEAVES.get(arch, ())
    for path, ref in leaves:
        name = leaf_name(path)
        ref, mine = np.asarray(ref), grads[name].numpy()
        if name.endswith(zero) and zero:
            assert np.linalg.norm(ref) <= ZERO_GRAD_NORM * total, name
            assert np.linalg.norm(mine) <= ZERO_GRAD_NORM * total, name
            continue
        gap = np.linalg.norm(mine - ref) / max(np.linalg.norm(ref), 1e-30)
        assert gap <= GRAD_REL_L2, (name, gap)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_bfloat16_forward_matches_the_reference(arch):
    (cfg, model, g), (ref_cfg, params, ref_g) = setup(
        arch, 1, act_dtype="bfloat16")
    with torch.no_grad():
        out = gnn.gnn_forward(model, cfg, g)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref_gnn.gnn_forward(params, ref_cfg, ref_g)
                     .astype(jnp.float32))
    gap = np.linalg.norm(out.float().numpy() - ref) / np.linalg.norm(ref)
    assert gap <= BF16_REL_L2, gap
    # the masters stay float32 and take the gradient through the casts
    loss, grads = port_grads(model, cfg, g)
    assert torch.isfinite(loss)
    assert all(x.dtype == torch.float32 and torch.isfinite(x).all()
               for x in grads.values())


def test_equiformer_chunks_match_one_chunk(monkeypatch):
    (cfg, model, g), _ = setup("equiformer-v2", 2)
    assert gnn.edge_chunks(N_EDGES) == 1
    with torch.no_grad():
        one = gnn.gnn_forward(model, cfg, g)
    loss1, grads1 = port_grads(model, cfg, g)
    monkeypatch.setattr(gnn, "_CHUNK_EDGES", 64)
    assert gnn.edge_chunks(N_EDGES) == 8
    with torch.no_grad():
        eight = gnn.gnn_forward(model, cfg, g)
    loss8, grads8 = port_grads(model, cfg, g)
    np.testing.assert_allclose(eight.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(loss8), float(loss1), rtol=1e-5)
    total = np.sqrt(sum(float(x.square().sum()) for x in grads1.values()))
    for name, x in grads1.items():
        y = grads8[name]
        if name.endswith(gnn.ZERO_GRADIENT_LEAVES["equiformer-v2"]):
            assert float(y.norm()) <= ZERO_GRAD_NORM * total
            continue
        gap = float((y - x).norm()) / max(float(x.norm()), 1e-30)
        assert gap <= GRAD_REL_L2, (name, gap)


class Calls:
    """Counts calls of B2 (``embedding_bag_cuda``,
    ``embedding_lookup_cuda``) and B2-bwd (``embedding_bag_bwd_cuda``)
    at ``kernels/embedding_bag/ops.py``, where the autograd functions
    and the gathers reach them."""

    def __init__(self, monkeypatch):
        self.counts = {"B2": 0, "B2-bwd": 0}
        for name, key in (("embedding_lookup_cuda", "B2"),
                          ("embedding_bag_cuda", "B2"),
                          ("embedding_bag_bwd_cuda", "B2-bwd")):
            monkeypatch.setattr(b2_ops, name, self.counting(
                getattr(b2_ops, name), key))

    def counting(self, fn, key):
        def wrapped(*args, **kwargs):
            self.counts[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    def take(self) -> dict:
        out = dict(self.counts)
        self.counts.update({"B2": 0, "B2-bwd": 0})
        return out


@pytest.mark.parametrize("arch,chunked", [(a, False) for a in GNN_ARCHS]
                         + [("equiformer-v2", True)])
def test_kernel_calls_follow_the_structure(monkeypatch, arch, chunked):
    if chunked:
        monkeypatch.setattr(gnn, "_CHUNK_EDGES", 64)
    cfg = configs.get(arch).scaled()
    model = gnn.init_gnn(cfg, D_FEAT, N_OUT, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    g = gnn.random_graph_batch(np.random.default_rng(0), N_NODES, N_EDGES,
                               D_FEAT, device="cpu")
    opt = AdamW(lr=1e-3)
    state = opt.init(model)
    step = gnn.make_gnn_train_step(cfg, opt, n_out=N_OUT)
    calls = Calls(monkeypatch)
    with torch.no_grad():
        gnn.gnn_forward(model, cfg, g)
    assert calls.take() == gnn.kernel_calls(cfg, N_EDGES, train=False)
    step(model, state, g)
    assert calls.take() == gnn.kernel_calls(cfg, N_EDGES)
