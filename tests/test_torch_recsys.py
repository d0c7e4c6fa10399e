"""MIND serving: the port's ``models/recsys.py`` against the JAX package's,
on the same parameters.

The reference's ``init_mind`` draws the parameters (``jax.random``
cannot be reproduced in torch); ``params_from_numpy`` loads them into
the port. Histories are made with numpy and padded with the vocabulary
size, as ``tests/test_recsys_smoke.py`` pads them. Float32 throughout:
``lookup`` is exact, the capsules and scores within rtol 1e-5, atol 1e-6
(einsums summed in another order; measured ≈9e-8 on capsules up to
≈0.4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import embedding_bag as b2
from repro_torch.models import recsys

from test_torch_reference import load_reference

ref_configs = load_reference("configs")
ref_recsys = load_reference("models.recsys")

TOL = dict(rtol=1e-5, atol=1e-6)


def _models(seed=0):
    """(port cfg, reference cfg, reference params, port MIND on the CPU
    holding the same parameters), at the smoke size."""
    cfg = configs.get("mind").scaled()
    ref_cfg = ref_configs.get("mind").scaled()
    params = ref_recsys.init_mind(ref_cfg, jax.random.key(seed))
    model = recsys.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, ref_cfg, params, model


def _hist(cfg, b, seed, pad=None):
    """(B, hist_len) int32 ids with a random-length tail of pads."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, cfg.vocab, (b, cfg.hist_len)).astype(np.int32)
    lens = rng.integers(1, cfg.hist_len + 1, b)
    hist[np.arange(cfg.hist_len)[None, :] >= lens[:, None]] = (
        cfg.vocab if pad is None else pad)
    return hist


def test_config_and_shapes_copied_value_for_value():
    assert (dataclasses.asdict(configs.get("mind"))
            == dataclasses.asdict(ref_configs.get("mind")))
    assert (dataclasses.asdict(configs.get("mind").scaled())
            == dataclasses.asdict(ref_configs.get("mind").scaled()))
    shapes = configs.get("mind").shapes
    assert shapes is configs.RECSYS_SHAPES
    assert ([dataclasses.asdict(s) for s in shapes]
            == [dataclasses.asdict(s) for s in ref_configs.RECSYS_SHAPES])
    assert ([f.name for f in dataclasses.fields(configs.ShapeSpec)]
            == [f.name for f in dataclasses.fields(ref_configs.ShapeSpec)])


def test_params_from_numpy_holds_the_reference_arrays():
    cfg, _, params, model = _models()
    for name in recsys.PARAM_NAMES:
        p = getattr(model, name)
        assert p.dtype == torch.float32 and not p.requires_grad
        np.testing.assert_array_equal(p.numpy(), np.asarray(params[name]))
    assert model.table.shape == (cfg.vocab, cfg.embed_dim)
    assert model.route_init.shape == (cfg.hist_len, cfg.n_interests)


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_lookup_matches_reference(id_dtype):
    cfg, _, params, model = _models()
    ids = np.random.default_rng(0).integers(-2, cfg.vocab + 9, (12, 5)
                                            ).astype(np.int32)
    out = recsys.lookup(model.table, torch.from_numpy(ids).to(id_dtype))
    assert out.shape == (12, 5, cfg.embed_dim)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(ref_recsys.lookup(params["table"],
                                                  jnp.asarray(ids))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serve_step_matches_reference(seed):
    cfg, ref_cfg, params, model = _models(seed)
    hist = _hist(cfg, 16, seed)
    caps = recsys.serve_step(model, cfg, torch.from_numpy(hist))
    ref = ref_recsys.serve_step(params, ref_cfg, jnp.asarray(hist))
    assert caps.shape == (16, cfg.n_interests, cfg.embed_dim)
    np.testing.assert_allclose(caps.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        recsys.interests(model, cfg, torch.from_numpy(hist)).numpy(),
        np.asarray(ref_recsys.interests(params, ref_cfg, jnp.asarray(hist))),
        **TOL)


def test_label_aware_attention_matches_reference():
    rng = np.random.default_rng(3)
    caps = rng.standard_normal((6, 4, 32)).astype(np.float32)
    target = rng.standard_normal((6, 32)).astype(np.float32)
    out = recsys.label_aware_attention(torch.from_numpy(caps),
                                       torch.from_numpy(target))
    ref = ref_recsys.label_aware_attention(jnp.asarray(caps),
                                           jnp.asarray(target))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("b,n,top_k", [(1, 1000, 64), (3, 500, 8)])
def test_retrieval_step_matches_reference(b, n, top_k):
    cfg, ref_cfg, params, model = _models(4)
    rng = np.random.default_rng(n)
    hist = _hist(cfg, b, n)
    cand = rng.permutation(cfg.vocab)[:n].astype(np.int32)
    scores, ids = recsys.retrieval_step(model, cfg, torch.from_numpy(hist),
                                        torch.from_numpy(cand), top_k=top_k)
    ref_scores, ref_ids = ref_recsys.retrieval_step(
        params, ref_cfg, jnp.asarray(hist), jnp.asarray(cand), top_k=top_k)
    ref_scores, ref_ids = np.asarray(ref_scores), np.asarray(ref_ids)
    np.testing.assert_allclose(scores.numpy(), ref_scores, **TOL)
    # the order of (near-)equal scores is the sort's own: compare ids
    # where each score stands apart from its neighbours by more than TOL
    gaps = np.abs(np.diff(ref_scores, axis=1)) > 1e-5
    apart = np.ones_like(ref_scores, dtype=bool)
    apart[:, 1:] &= gaps
    apart[:, :-1] &= gaps
    assert apart.sum() > top_k // 2
    np.testing.assert_array_equal(ids.numpy()[apart], ref_ids[apart])


def test_padding_invariance():
    """Out-of-vocab slots must not affect the capsules: pads are skipped
    by B2 and masked by the routing, so the sentinel changes no bit."""
    cfg, _, _, model = _models(1)
    h1 = _hist(cfg, 16, 5)
    h2 = _hist(cfg, 16, 5, pad=cfg.vocab + 7)
    assert (h1 != h2).any()
    c1 = recsys.serve_step(model, cfg, torch.from_numpy(h1))
    c2 = recsys.serve_step(model, cfg, torch.from_numpy(h2))
    assert torch.equal(c1, c2)


def test_all_pad_history_gives_zero_capsules():
    cfg, ref_cfg, params, model = _models(2)
    hist = _hist(cfg, 4, 6)
    hist[1] = cfg.vocab
    caps = recsys.serve_step(model, cfg, torch.from_numpy(hist))
    assert not caps[1].any()
    assert caps[0].any()
    ref = np.asarray(ref_recsys.serve_step(params, ref_cfg,
                                           jnp.asarray(hist)))
    np.testing.assert_array_equal(ref[1], 0.0)
    np.testing.assert_allclose(caps.numpy(), ref, **TOL)


def test_serve_path_makes_no_launch_on_the_cpu():
    cfg, _, _, model = _models()
    before = b2.kernel.launch_count
    recsys.retrieval_step(model, cfg, torch.from_numpy(_hist(cfg, 2, 0)),
                          torch.arange(100), top_k=4)
    assert b2.kernel.launch_count == before


def test_init_mind_shapes_and_scales_on_the_cpu():
    cfg = configs.get("mind").scaled()
    model = recsys.init_mind(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    d = cfg.embed_dim
    assert model.table.device == torch.device("cpu")
    assert model.table.shape == (cfg.vocab, d)
    assert abs(float(model.table.std()) - d ** -0.5) < 0.01
    assert abs(float(model.route_init.std()) - 1.0) < 0.3
    again = recsys.init_mind(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    assert torch.equal(model.table, again.table)


def test_init_mind_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        recsys.init_mind(configs.get("mind").scaled(),
                         generator=torch.Generator().manual_seed(0))
