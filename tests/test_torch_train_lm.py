"""LM training: the port's ``lm_loss`` and ``make_train_step`` against
the JAX package's, on the same parameters and batches.

The reference's ``init_lm`` draws the parameters, cast to float32 on
both sides (the router is float32 already); ``params_from_numpy`` loads
them into the port. Held to the reference:

- ``lm_loss`` (loss, nll, aux) and every gradient leaf of
  ``jax.value_and_grad``, for tinyllama's smoke model and mixtral's at
  capacity 8.0 (nothing dropped) and 0.5 (routes dropped). Tolerances:
  losses within 1e-5 relative; each gradient leaf within 2e-5 of its
  largest magnitude (measured at most 1.2e-6: float32 sums in two
  orders).
- ``make_train_step`` at one and two microbatches: its metrics and the
  gradients its optimizer is handed (a recording AdamW on both sides),
  at the same tolerances; gnorm within 1e-5 relative. Parameters after
  an Adam step are not compared tightly: a gradient near 0 that rounds
  apart moves a parameter by 2·lr on Adam's first step.
- Per-layer checkpointing changes no bit of the loss or the gradients.
- The reference's ``test_train_step_reduces_loss`` on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamW

from test_torch_reference import load_reference

ref_configs = load_reference("configs")
ref_tf = load_reference("models.transformer")
ref_optim = load_reference("optim")

CASES = {"tinyllama": ("tinyllama-1.1b", {}),
         "mixtral-cap8": ("mixtral-8x7b", {"capacity_factor": 8.0}),
         "mixtral-cap0.5": ("mixtral-8x7b", {"capacity_factor": 0.5})}
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5            # of each leaf's largest magnitude


def _models(arch, seed=0, **replace):
    cfg = dataclasses.replace(configs.get(arch).scaled(), **replace)
    ref_cfg = dataclasses.replace(ref_configs.get(arch).scaled(), **replace)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          ref_tf.init_lm(ref_cfg, jax.random.key(seed)))
    model = tf.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return cfg, ref_cfg, params, model


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s), dtype=np.int32),
            rng.integers(0, cfg.vocab, (b, s), dtype=np.int32))


def _port_grads(model, tokens, labels, remat=True):
    names, params = zip(*model.named_parameters())
    with model.trainable():
        loss, (nll, aux) = tf.lm_loss(model, torch.from_numpy(tokens),
                                      torch.from_numpy(labels), remat=remat)
        grads = torch.autograd.grad(loss, params)
    return (loss.detach(), nll.detach(), aux.detach()), dict(zip(names,
                                                                  grads))


def _assert_grads_match(grads, ref_grads):
    """Port gradients (keyed by parameter name) against the reference's
    tree, leaf by leaf, each within GRAD_TOL of its largest magnitude."""
    tree = tf.param_tree(grads)
    flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(flat) == len(tree) - 1 + len(tree["layers"])
    for path, ref in flat:
        keys = [p.key for p in path]
        out = tree
        for k in keys:
            out = out[k]
        ref = np.asarray(ref, np.float32)
        assert out.shape == ref.shape, keys
        err = float(np.abs(out.float().numpy() - ref).max())
        scale = float(np.abs(ref).max())
        assert scale > 0, keys
        assert err <= GRAD_TOL * scale, ("/".join(keys), err, scale)


@pytest.mark.parametrize("case", list(CASES))
def test_lm_loss_and_gradients_match_reference(case):
    arch, replace = CASES[case]
    cfg, ref_cfg, params, model = _models(arch, **replace)
    tokens, labels = _batch(cfg, 2, 32, seed=1)
    (loss, (nll, aux)), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_tf.lm_loss(p, ref_cfg, tokens, labels),
        has_aux=True))(params)
    (p_loss, p_nll, p_aux), grads = _port_grads(model, tokens, labels)
    for out, ref in ((p_loss, loss), (p_nll, nll), (p_aux, aux)):
        np.testing.assert_allclose(float(out), float(ref), rtol=LOSS_RTOL,
                                   atol=1e-7)
    if cfg.moe:
        assert float(p_aux) > 0
    _assert_grads_match(grads, ref_grads)


def test_lm_loss_gold_logit_is_the_one_hot_contraction():
    """The gather takes the value the reference's one-hot product does,
    exactly (one nonzero product per row)."""
    cfg, _, _, model = _models("tinyllama-1.1b")
    tokens, labels = _batch(cfg, 2, 16, seed=2)
    with torch.no_grad():
        logits = tf.forward(model, torch.from_numpy(tokens))[0].float()
        loss, (nll, _) = tf.lm_loss(model, torch.from_numpy(tokens),
                                    torch.from_numpy(labels))
    onehot = torch.nn.functional.one_hot(torch.from_numpy(labels).long(),
                                         cfg.vocab).float()
    gold = (logits * onehot).sum(-1)
    want = (torch.logsumexp(logits, -1) - gold).mean()
    assert torch.equal(nll, want)
    assert torch.equal(loss, nll)              # dense: aux is 0


class _Recording:
    """An optimizer that records the gradients it is handed, then
    delegates."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def update(self, grads, state, params):
        self.grads = grads
        return self.opt.update(grads, state, params)


@pytest.mark.parametrize("nm", [1, 2])
@pytest.mark.parametrize("case", ["tinyllama", "mixtral-cap0.5"])
def test_train_step_matches_reference_loss_and_gradients(case, nm):
    arch, replace = CASES[case]
    cfg, ref_cfg, params, model = _models(arch, **replace)
    tokens, labels = _batch(cfg, 4, 16, seed=3)
    ref_opt = _Recording(ref_optim.AdamW(lr=1e-3))
    ref_step = ref_tf.make_train_step(ref_cfg, ref_opt, num_microbatches=nm)
    _, _, ref_m = ref_step(params, ref_opt.opt.init(params),
                           {"tokens": tokens, "labels": labels})
    opt = _Recording(AdamW(lr=1e-3))
    step = tf.make_train_step(cfg, opt, num_microbatches=nm)
    _, state, m = step(model, opt.opt.init(model),
                       {"tokens": torch.from_numpy(tokens),
                        "labels": torch.from_numpy(labels)})
    assert int(state.step) == 1
    for key in ("loss", "nll", "aux", "gnorm"):
        np.testing.assert_allclose(float(m[key]), float(ref_m[key]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
    want_dtype = torch.float32
    assert {g.dtype for g in opt.grads.values()} == {want_dtype}
    _assert_grads_match(opt.grads, ref_opt.grads)
    # no parameter requires a gradient after the step
    assert not any(p.requires_grad for p in model.parameters())


def test_microbatch_gradients_accumulate_in_float32():
    """With nm = 2 and bfloat16 parameters the optimizer gets float32
    gradients (the float32 buffers, divided by nm); with nm = 1 the
    parameters' dtype, as the reference's."""
    cfg = configs.get("tinyllama-1.1b").scaled()
    model = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    tokens, labels = _batch(cfg, 4, 8, seed=4)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    for nm, dtypes in ((1, {torch.bfloat16}), (2, {torch.float32})):
        opt = _Recording(AdamW(lr=1e-3))
        tf.make_train_step(cfg, opt, num_microbatches=nm)(
            model, opt.opt.init(model), batch)
        assert {g.dtype for g in opt.grads.values()} == dtypes, nm


def test_strided_microbatches_are_the_reference_slicing():
    """Microbatch i holds rows i, i + nm, ...: the step at nm = 2 equals
    the mean of the two strided halves' gradients."""
    cfg, _, _, model = _models("tinyllama-1.1b")
    tokens, labels = _batch(cfg, 4, 8, seed=5)
    opt = _Recording(AdamW(lr=0.0, weight_decay=0.0))
    tf.make_train_step(cfg, opt, num_microbatches=2)(
        model, opt.opt.init(model), {"tokens": torch.from_numpy(tokens),
                                     "labels": torch.from_numpy(labels)})
    halves = [_port_grads(model, tokens[i::2], labels[i::2])[1]
              for i in range(2)]
    for name, g in opt.grads.items():
        want = (halves[0][name].float() + halves[1][name].float()) / 2
        assert torch.equal(g, want), name


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b"])
def test_per_layer_checkpointing_changes_no_bit(arch):
    cfg, _, _, model = _models(arch)
    tokens, labels = _batch(cfg, 2, 16, seed=6)
    (l1, n1, a1), g1 = _port_grads(model, tokens, labels, remat=True)
    (l2, n2, a2), g2 = _port_grads(model, tokens, labels, remat=False)
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "tinyllama-1.1b"])
def test_train_step_reduces_loss(arch):
    """The reference's ``test_train_step_reduces_loss``: five steps on one
    batch at lr 5e-3 lower the loss (bfloat16 parameters)."""
    cfg = configs.get(arch).scaled()
    model = tf.init_lm(cfg, generator=torch.Generator().manual_seed(1),
                       device="cpu")
    opt = AdamW(lr=5e-3)
    state = opt.init(model)
    step = tf.make_train_step(cfg, opt)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)))
    batch = {"tokens": tokens, "labels": tokens}
    losses = []
    for _ in range(5):
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
