"""MIND training: the port's ``mind_loss``, ``make_train_step`` and
``param_shapes`` against the JAX package's, on the same parameters and
batches, and kernel B2-bwd's plain backward and CPU emulation.

The reference's ``init_mind`` draws the parameters at the smoke size
(``get("mind").scaled()``: vocab 1000, d 32); ``params_from_numpy``
loads them into the port. Held to the reference (float32 throughout):

- ``mind_loss`` within rtol 1e-5 and each gradient leaf of
  ``jax.value_and_grad`` within a relative L2 error of 1e-5 (measured
  2e-7 to 7e-7: float32 sums in two orders), with pads and a negative id
  in the batch, the loss in one block and in row blocks.
- 10 steps of ``make_train_step`` with the reference's ``AdamW(lr=1e-2)``
  at weight decay 0 and 0.1: parameters within atol 1e-5 (measured at
  most 3.9e-7), loss and gnorm within rtol 1e-5.
- The reference's ``tests/test_recsys_smoke.py`` protocols on the port,
  and checkpoints crossing between the packages both ways.

On the CPU the table's gradient goes through the same
``EmbeddingBag`` function as on the card, with the plain backward in
place of B2-bwd. The kernel's own reduction order is held against the
plain backward through ``embedding_bag_bwd_emulate`` on inputs whose sums
are exact (multiples of 1/16 and 1/4, bounded counts), with runs split
across chunks.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import embedding_bag as b2
from repro_torch.models import recsys
from repro_torch.optim import AdamW, AdamWState
from repro_torch.train import checkpoint

from test_torch_reference import load_reference

ref_configs = load_reference("configs")
ref_recsys = load_reference("models.recsys")
ref_optim = load_reference("optim")
ref_ckpt = load_reference("train.checkpoint")

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-5
PARAM_ATOL = 1e-5


def _models(seed=0):
    cfg = configs.get("mind").scaled()
    ref_cfg = ref_configs.get("mind").scaled()
    params = ref_recsys.init_mind(ref_cfg, jax.random.key(seed))
    # copies: JAX on the CPU may alias a numpy array it was given, and the
    # port updates its parameters in place
    model = recsys.params_from_numpy(
        cfg, {k: np.array(v) for k, v in params.items()}, device="cpu")
    return cfg, ref_cfg, params, model


def _batch(cfg, b, seed, *, negative=True):
    """Histories with a random-length tail of pads (and a negative id),
    targets anywhere in the vocabulary."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, cfg.vocab, (b, cfg.hist_len)).astype(np.int32)
    lens = rng.integers(1, cfg.hist_len + 1, b)
    hist[np.arange(cfg.hist_len)[None, :] >= lens[:, None]] = cfg.vocab
    if negative:
        hist[0, 0] = -3                     # reads (and trains) row 0
    target = rng.integers(0, cfg.vocab, b).astype(np.int32)
    return {"hist": hist, "target": target}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_grads(model, cfg, batch):
    names, params = zip(*model.named_parameters())
    with model.trainable():
        loss = recsys.mind_loss(model, cfg, _torch_batch(batch))
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip(names, grads))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("seed,b,block_rows", [
    (0, 16, 8192), (1, 64, 16), (2, 256, 8192), (2, 40, 16)])
def test_mind_loss_and_gradients_match_reference(seed, b, block_rows,
                                                 monkeypatch):
    monkeypatch.setattr(recsys, "LOSS_BLOCK_ROWS", block_rows)
    cfg, ref_cfg, params, model = _models(seed)
    batch = _batch(cfg, b, seed)
    loss, ref_grads = jax.value_and_grad(
        lambda p: ref_recsys.mind_loss(p, ref_cfg, _jax_batch(batch)))(params)
    p_loss, grads = _port_grads(model, cfg, batch)
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=LOSS_RTOL)
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        ref = np.asarray(ref_grads[name])
        assert g.shape == ref.shape and g.dtype == torch.float32, name
        assert np.abs(ref).max() > 0, name
        assert _rel_l2(g.numpy(), ref) <= GRAD_REL_L2, name
    # the negative id's gradient lands in row 0 on both sides
    assert np.abs(np.asarray(ref_grads["table"])[0]).max() > 0
    np.testing.assert_allclose(grads["table"][0].numpy(),
                               np.asarray(ref_grads["table"])[0],
                               rtol=1e-4, atol=1e-7)


def test_rows_no_entry_reads_get_zero_gradient():
    cfg, _, _, model = _models(3)
    batch = _batch(cfg, 16, 3)
    _, grads = _port_grads(model, cfg, batch)
    ids = np.concatenate([batch["hist"].reshape(-1), batch["target"]])
    read = np.zeros(cfg.vocab, bool)
    read[np.clip(ids[ids < cfg.vocab], 0, cfg.vocab - 1)] = True
    g = grads["table"].numpy()
    assert not np.abs(g[~read]).any()
    assert np.abs(g[read]).sum(1).min() >= 0 and np.abs(g[read]).any()


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_train_steps_match_reference(weight_decay):
    cfg, ref_cfg, params, model = _models(4)
    batch = _batch(cfg, 32, 4)
    ref_opt = ref_optim.AdamW(lr=1e-2, weight_decay=weight_decay)
    ref_state = ref_opt.init(params)
    ref_step = jax.jit(ref_recsys.make_train_step(ref_cfg, ref_opt))
    opt = AdamW(lr=1e-2, weight_decay=weight_decay)
    state = opt.init(model)
    step = recsys.make_train_step(cfg, opt)
    tb, jb = _torch_batch(batch), _jax_batch(batch)
    for i in range(10):
        params, ref_state, ref_m = ref_step(params, ref_state, jb)
        model, state, m = step(model, state, tb)
        assert set(m) == {"loss", "gnorm"}
        for k in m:
            assert m[k].dim() == 0 and m[k].dtype == torch.float32
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=LOSS_RTOL, err_msg=f"{k} {i}")
    for name in recsys.PARAM_NAMES:
        p = getattr(model, name)
        assert not p.requires_grad
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[name]), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    assert int(state.step) == 10


def test_param_shapes_equal_the_reference():
    for cfg, ref_cfg in ((configs.get("mind"), ref_configs.get("mind")),
                         (configs.get("mind").scaled(),
                          ref_configs.get("mind").scaled())):
        shapes = recsys.param_shapes(cfg)
        ref = ref_recsys.param_shapes(ref_cfg)
        assert sorted(shapes) == sorted(ref)
        for name, t in shapes.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[name].shape), name
            assert str(t.dtype)[6:] == str(ref[name].dtype), name


def test_trainable_only_inside_the_block_and_lookup_grad_fn():
    cfg, _, _, model = _models()
    ids = torch.tensor([[3, cfg.vocab, -1]])
    with model.trainable():
        assert all(p.requires_grad for p in model.parameters())
        rows = recsys.lookup(model.table, ids)
        assert type(rows.grad_fn).__name__ == "EmbeddingBagBackward"
        with torch.no_grad():
            assert recsys.lookup(model.table, ids).grad_fn is None
    assert not any(p.requires_grad for p in model.parameters())
    assert recsys.lookup(model.table, ids).grad_fn is None
    out = b2.embedding_bag(model.table.detach().requires_grad_(),
                           ids.expand(2, 3), None)
    assert type(out.grad_fn).__name__ == "EmbeddingBagBackward"


def test_weights_gradient_raises_naming_its_roadmap_line():
    table = torch.rand(8, 4, requires_grad=True)
    w = torch.rand(2, 3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="A11.3"):
        b2.embedding_bag(table, torch.zeros((2, 3), dtype=torch.int64), w)
    with open(os.path.join(os.path.dirname(__file__), os.pardir,
                           "ROADMAP.md")) as f:
        assert "B2's weights gradient" in f.read()


def test_train_step_launches_nothing_on_the_cpu():
    cfg, _, _, model = _models()
    before = (b2.kernel.launch_count, b2.kernel.bwd_launch_count)
    opt = AdamW(lr=1e-2)
    recsys.make_train_step(cfg, opt)(model, opt.init(model),
                                     _torch_batch(_batch(cfg, 8, 0)))
    assert (b2.kernel.launch_count, b2.kernel.bwd_launch_count) == before


# ----------------------------------------------------------- B2-bwd alone
def _exact_inputs(seed, b, l, v, d, *, hot=None, weighted=True):
    """dout in multiples of 1/16 in [-1, 1], weights in multiples of 1/4 in
    [0, 1]: every partial sum of a few thousand such products is exact in
    float32, so any order of the sums gives the same bits."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-2, v + 3, (b, l))
    if hot is not None:
        idx[rng.random((b, l)) < 0.6] = hot
    dout = rng.integers(-16, 17, (b, d)).astype(np.float32) / 16
    w = rng.integers(0, 5, (b, l)).astype(np.float32) / 4
    return (torch.from_numpy(dout), torch.from_numpy(idx),
            torch.from_numpy(w) if weighted else None)


@pytest.mark.parametrize("chunk", [1, 3, 4, 16, 256])
@pytest.mark.parametrize("weighted", [False, True])
def test_emulation_equals_plain_backward_on_exact_sums(chunk, weighted):
    dout, idx, w = _exact_inputs(chunk, 61, 5, 23, 10, hot=4,
                                 weighted=weighted)
    want = b2.embedding_bag_bwd_ref(dout, idx, w, 23)
    got = b2.embedding_bag_bwd_emulate(dout, idx, w, 23, chunk)
    assert torch.equal(got, want)
    assert want[4].abs().sum() > 0


def test_plain_backward_is_the_reference_lookups_gradient():
    """Pads add nothing, an id < 0 adds to row 0, the weights scale, and
    the bf16 gradient is the float32 sum rounded once."""
    v, d = 12, 5
    rng = np.random.default_rng(0)
    idx = np.array([[0, 3, v, -1], [3, 3, v + 4, 11]], np.int32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    dout = rng.standard_normal((2, d)).astype(np.float32)
    w = rng.random((2, 4)).astype(np.float32)
    ref_bag = load_reference("kernels.embedding_bag")
    ref = jax.grad(lambda t: jnp.sum(ref_bag.embedding_bag_ref(
        t, jnp.asarray(idx), jnp.asarray(w)) * jnp.asarray(dout)))(
        jnp.asarray(table))
    got = b2.embedding_bag_bwd_ref(torch.from_numpy(dout),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(w), v)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    assert not got[[1, 2, 4, 5, 6, 7, 8, 9, 10]].any()
    bf = b2.embedding_bag_bwd_ref(torch.from_numpy(dout).bfloat16(),
                                  torch.from_numpy(idx), None, v)
    assert bf.dtype == torch.bfloat16
    want = b2.embedding_bag_bwd_ref(torch.from_numpy(dout).bfloat16().float(),
                                    torch.from_numpy(idx), None, v)
    assert torch.equal(bf, want.bfloat16())


def test_emulation_splits_a_hot_run_with_the_same_bits_every_call():
    """One row read by half of 20,000 entries (about 40 chunks of 256)
    beside a uniform spread: equal to the plain backward on exact sums,
    and two calls give the same bits on random ones."""
    n, v, d = 20_000, 64, 8
    rng = np.random.default_rng(5)
    ids = np.where(rng.random(n) < 0.5, 7, rng.integers(0, v + 2, n))
    dout = torch.from_numpy(rng.integers(-16, 17, (n, d)).astype(np.float32)
                            / 16)
    idx = torch.from_numpy(ids.reshape(n, 1))
    got = b2.embedding_bag_bwd_emulate(dout, idx, None, v, 256)
    assert torch.equal(got, b2.embedding_bag_bwd_ref(dout, idx, None, v))
    keys, _ = b2.sorted_keys(idx, v)
    run = int((keys == 7).sum())
    assert run > 30 * 256
    noisy = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    first = b2.embedding_bag_bwd_emulate(noisy, idx, None, v, 256)
    assert torch.equal(first, b2.embedding_bag_bwd_emulate(noisy, idx, None,
                                                           v, 256))
    torch.testing.assert_close(first, b2.embedding_bag_bwd_ref(noisy, idx,
                                                               None, v),
                               rtol=1e-5, atol=1e-4)


def test_sorted_keys_order():
    idx = torch.tensor([[5, -2, 9], [5, 1, 7]])
    keys, perm = b2.sorted_keys(idx, 8)
    assert keys.dtype == torch.int32 and perm.dtype == torch.int64
    assert keys.tolist() == [0, 1, 5, 5, 7, 8]
    assert perm.tolist() == [1, 4, 0, 3, 5, 2]       # stable: 0 before 3


def test_bwd_wrapper_checks_and_counts_no_cpu_launch():
    dout = torch.rand(2, 4)
    idx = torch.zeros((2, 3), dtype=torch.int32)
    before = b2.kernel.bwd_launch_count
    got = b2.embedding_bag_bwd_cuda(dout, idx, None, 5)
    torch.testing.assert_close(got[0], 3 * dout.sum(0))
    assert not got[1:].any() and b2.kernel.bwd_launch_count == before
    with pytest.raises(ValueError, match=r"\(B, d\)"):
        b2.embedding_bag_bwd_cuda(dout[0], idx, None, 5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        b2.embedding_bag_bwd_cuda(dout.half(), idx, None, 5)
    with pytest.raises(ValueError, match="num_rows"):
        b2.embedding_bag_bwd_cuda(dout, idx, None, 0)
    with pytest.raises(ValueError, match="one device"):
        b2.embedding_bag_bwd_cuda(dout, idx.to("meta"), None, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        b2.embedding_bag_bwd_cuda(dout.to("meta"), idx.to("meta"), None, 5)


def test_bwd_packed_arguments_are_the_c_sides_in_its_order():
    import re
    source = b2.kernel.SOURCE.read_text()
    body = re.search(r"enum BwdArg \{(.*?)\};", source, re.S).group(1)
    names = [n.lower() for n in re.findall(r"^\s*kB(\w+),", body, re.M)
             if n != "NumArgs"]
    assert names == [n.replace("_", "").lower()
                     for n in b2.kernel.BWD_ARGS.names]


# ------------------------------------------- the reference's smoke tests
def _smoke_batch(cfg, rng, b):
    """``tests/test_recsys_smoke.py::make_batch``."""
    hist = rng.integers(0, cfg.vocab, (b, cfg.hist_len))
    hist[:, -2:] = cfg.vocab
    return {"hist": torch.from_numpy(hist.astype(np.int32)),
            "target": torch.from_numpy(rng.integers(0, cfg.vocab, (b,))
                                       .astype(np.int32))}


def _smoke_model(cfg, seed):
    ref_cfg = ref_configs.get("mind").scaled()
    params = ref_recsys.init_mind(ref_cfg, jax.random.key(seed))
    return recsys.params_from_numpy(
        cfg, {k: np.array(v) for k, v in params.items()}, device="cpu")


def test_smoke_train_step_decreases_loss():
    cfg = configs.get("mind").scaled()
    model = _smoke_model(cfg, 2)
    opt = AdamW(lr=1e-2, weight_decay=0.0)
    state = opt.init(model)
    step = recsys.make_train_step(cfg, opt)
    batch = _smoke_batch(cfg, np.random.default_rng(2), 32)
    losses = []
    for _ in range(10):
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_smoke_retrieval_finds_history_items():
    cfg = configs.get("mind").scaled()
    model = _smoke_model(cfg, 3)
    opt = AdamW(lr=1e-2, weight_decay=0.0)
    state = opt.init(model)
    step = recsys.make_train_step(cfg, opt)
    batch = _smoke_batch(cfg, np.random.default_rng(3), 32)
    for _ in range(30):
        model, state, _ = step(model, state, batch)
    cand = torch.arange(cfg.vocab, dtype=torch.int32)
    _, idx = recsys.retrieval_step(model, cfg, batch["hist"][:4], cand,
                                   top_k=cfg.vocab)
    ranks = [int(np.where(idx[i].numpy() == int(batch["target"][i]))[0][0])
             for i in range(4)]
    assert np.median(ranks) < cfg.vocab // 2, ranks


# ------------------------------------------------------------ checkpoints
def test_mind_checkpoints_cross_between_packages(tmp_path):
    cfg, ref_cfg, params, model = _models(6)
    batch = _batch(cfg, 16, 6)
    ref_opt = ref_optim.AdamW(lr=1e-3)
    ref_state = ref_opt.init(params)
    params, ref_state, _ = ref_recsys.make_train_step(ref_cfg, ref_opt)(
        params, ref_state, _jax_batch(batch))
    opt = AdamW(lr=1e-3)
    state = opt.init(model)
    model, state, _ = recsys.make_train_step(cfg, opt)(model, state,
                                                       _torch_batch(batch))
    ref_ckpt.save(str(tmp_path / "ref"), 1, (params, ref_state))
    checkpoint.save(str(tmp_path / "port"), 1, (model, state))
    with open(tmp_path / "ref" / "step-00000001.json") as f:
        ref_manifest = f.read()
    with open(tmp_path / "port" / "step-00000001.json") as f:
        assert f.read() == ref_manifest

    # the reference's files restored by the port, into a MIND
    (got, got_state), step = checkpoint.restore(str(tmp_path / "ref"),
                                                (model, state))
    assert step == 1 and isinstance(got, recsys.MIND)
    assert isinstance(got_state, AdamWState) and int(got_state.step) == 1
    for name in recsys.PARAM_NAMES:
        p = getattr(got, name)
        assert not p.requires_grad
        assert np.array_equal(p.detach().numpy(), np.asarray(params[name]))
        assert np.array_equal(got_state.mu[name].numpy(),
                              np.asarray(ref_state.mu[name]))
        assert np.array_equal(got_state.nu[name].numpy(),
                              np.asarray(ref_state.nu[name]))

    # the port's files restored by the reference
    (r_params, r_state), step = ref_ckpt.restore(str(tmp_path / "port"),
                                                 (params, ref_state))
    for name in recsys.PARAM_NAMES:
        assert np.array_equal(np.asarray(r_params[name]),
                              getattr(model, name).detach().numpy())
        assert np.array_equal(np.asarray(r_state.mu[name]),
                              state.mu[name].numpy())
