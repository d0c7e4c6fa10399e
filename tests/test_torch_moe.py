"""The MoE and sliding-window LMs: the port's configurations and
``models/transformer.py`` against the JAX package's, on the same
parameters.

The reference's ``init_lm`` draws the parameters (the router float32,
the rest cast to the run's dtype); ``params_from_numpy`` loads them into
the port. ``_moe_ffn`` alone is held against the reference's on the
same ``h`` and layer, at a capacity that drops nothing (the smoke
configurations' 8.0), one that drops routes (0.5: the kept routes equal
the reference's rule computed in numpy) and the published 1.25 at
S = 256 (cap 160, rounded up to 256); the chosen experts must be the
same on both sides. The router's product is float64 rounded to float32,
bit for bit, and the aux loss is built only where ``forward`` asks for
it. Then ``forward`` (logits and aux), ``prefill``
(logits and cache) and per-slot ``decode_step`` of the mixtral and grok
smoke models (MoE; grok's with its GQA group of 6) and deepseek's
(dense). Tolerances are those of tests/test_torch_lm.py: float32 1e-3,
bfloat16 5e-2. In bfloat16 the two frameworks round the hidden states
apart, and a router near-tie can send a token to other experts on each
side; ``Routing`` finds such flips, requires each to be a tie within
``NEAR_TIE`` and compares the positions before it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import transformer as tf

from test_torch_reference import load_reference

ref_configs = load_reference("configs")
ref_tf = load_reference("models.transformer")

NEW = ["mixtral-8x7b", "grok-1-314b", "deepseek-67b"]
LMS = NEW + ["tinyllama-1.1b", "stablelm-1.6b"]
MOE = ["mixtral-8x7b", "grok-1-314b"]
# smoke widths; grok-1-314b keeps its GQA group of 6 (48/8 heads at full
# width), so its smoke model differs from mixtral's by more than the window
SMOKE = {"grok-1-314b": dict(d_model=192, n_heads=6, n_kv_heads=1)}
TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
# bfloat16 hidden states that agree within a few ulps move the float32
# router logits by up to ~2e-2 between the two sides (measured 2.0e-2 on
# grok's smoke model, 8.5e-3 on mixtral's); a router flip must be a tie
# within that
NEAR_TIE = 5e-2


def _cast(params, dtype):
    """The reference's parameters in ``dtype`` as numpy, the router kept
    float32 as ``init_lm`` draws it."""
    def cast(path, a):
        keep = any(getattr(p, "key", None) == "router" for p in path)
        return a if keep else a.astype(getattr(jnp, dtype))
    return jax.tree_util.tree_map_with_path(cast, params)


def _models(arch, dtype, seed=0, **replace):
    """(port cfg, reference cfg, reference params, port LM on the CPU
    holding the same parameters), both configurations ``scaled()`` and
    then given ``replace``."""
    smoke = SMOKE.get(arch, {})
    cfg = dataclasses.replace(configs.get(arch).scaled(**smoke), **replace)
    ref_cfg = dataclasses.replace(ref_configs.get(arch).scaled(**smoke),
                                  **replace)
    params = _cast(ref_tf.init_lm(ref_cfg, jax.random.key(seed)), dtype)
    model = tf.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return cfg, ref_cfg, params, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _close(out, ref, dtype):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", NEW)
def test_new_configs_copied_value_for_value(arch):
    assert (dataclasses.asdict(configs.get(arch))
            == dataclasses.asdict(ref_configs.get(arch)))
    assert (dataclasses.asdict(configs.get(arch).scaled())
            == dataclasses.asdict(ref_configs.get(arch).scaled()))
    assert (dataclasses.asdict(configs.get(arch).scaled(window=8))
            == dataclasses.asdict(ref_configs.get(arch).scaled(window=8)))


@pytest.mark.parametrize("arch", LMS)
def test_counts_and_shapes_equal_the_reference(arch):
    for cfg, ref in ((configs.get(arch), ref_configs.get(arch)),
                     (configs.get(arch).scaled(),
                      ref_configs.get(arch).scaled())):
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()
        assert cfg.sub_quadratic == ref.sub_quadratic
        assert ([dataclasses.asdict(s) for s in cfg.shapes]
                == [dataclasses.asdict(s) for s in ref.shapes])


def test_lm_shapes_and_arch_order_equal_the_reference():
    assert ([dataclasses.asdict(s) for s in configs.LM_SHAPES]
            == [dataclasses.asdict(s) for s in ref_configs.LM_SHAPES])
    # the reference's order, its GNN configurations included
    ref_names = [c.name for c in ref_configs.ALL_ARCHS]
    assert [c.name for c in configs.ALL_ARCHS] == ref_names
    assert [n for n in LMS if configs.get(n).sub_quadratic] == [
        "mixtral-8x7b"]


@pytest.mark.parametrize("e,cf,s,cap", [
    (4, 8.0, 64, 256), (4, 0.5, 64, 16), (4, 1.25, 256, 256),
    (8, 1.25, 1, 1), (8, 1.25, 2048, 640), (8, 1.25, 6144, 1920),
    (8, 4.0, 6208, 6272)])
def test_capacity_rounds_as_the_reference(e, cf, s, cap):
    """max(int(cf·s·k/e), 1), rounded up to a multiple of 128 above 128:
    the smoke tests' cases, decode, and chip_smoke.py's prefills."""
    cfg = dataclasses.replace(configs.get("mixtral-8x7b"), n_experts=e,
                              capacity_factor=cf)
    assert tf.capacity(cfg, s) == cap


# ------------------------------------------------------- _moe_ffn alone
def _kept_numpy(experts: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """The reference's rule, route by route: each sequence's routes in
    token-major order take the next slot of their expert; a route is
    kept while its slot < cap."""
    b, s, k = experts.shape
    kept = np.zeros((b, s * k), bool)
    for row in range(b):
        used = np.zeros(n_experts, int)
        for i, ex in enumerate(experts[row].reshape(-1)):
            kept[row, i] = used[ex] < cap
            used[ex] += 1
    return kept


def _margins(logits: np.ndarray, k: int) -> np.ndarray:
    """Gap between the k-th and (k+1)-th router logit of each token."""
    top = -np.sort(-logits, axis=-1)
    return top[..., k - 1] - top[..., k]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf,s", [(8.0, 64), (0.5, 64), (1.25, 256)])
def test_moe_ffn_matches_reference(cf, s, dtype):
    cfg, ref_cfg, params, model = _models("mixtral-8x7b", dtype,
                                          capacity_factor=cf)
    layer = jax.tree.map(lambda a: a[1], params["layers"])
    h = np.random.default_rng(5).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    h_ref = jnp.asarray(h, getattr(jnp, dtype))
    ref_out, ref_aux = ref_tf._moe_ffn(h_ref, layer, ref_cfg)
    h_port = torch.from_numpy(np.array(h_ref.astype(jnp.float32))).to(
        getattr(torch, dtype))
    block = model.layers[1]
    out, aux = tf._moe_ffn(h_port, block, cfg)
    assert out.dtype == h_port.dtype and aux.dtype == torch.float32

    # the same experts on both sides; a flip would be a near-tie
    ref_logits = np.asarray(h_ref.astype(jnp.float32)
                            @ layer["router"].astype(jnp.float32))
    _, ref_experts = jax.lax.top_k(jnp.asarray(ref_logits), cfg.top_k)
    logits, _, experts = tf.route(h_port, block.router, cfg.top_k)
    differ = np.asarray(ref_experts) != experts.numpy()
    assert not differ.any(), (
        f"router flips at {np.argwhere(differ.any(-1)).tolist()} with "
        f"margins {_margins(ref_logits, cfg.top_k)[differ.any(-1)]}")
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-5,
                               atol=1e-5)

    cap = tf.capacity(cfg, s)
    _, kept = tf.expert_slots(experts, cfg.n_experts, cap)
    np.testing.assert_array_equal(
        kept.numpy(), _kept_numpy(np.asarray(ref_experts), cfg.n_experts,
                                  cap))
    assert kept.all() == (cf != 0.5)          # 0.5 drops, the others not
    if cf == 1.25:
        assert cap == 256                     # 160 rounded up
    _close(out, ref_out, dtype)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_product_is_float64_rounded_to_float32(dtype):
    """``route`` takes the product in float64 and rounds it to float32,
    so no TF32 flag of the caller's reaches it: the logits equal numpy's
    float64 product of the same inputs, rounded, bit for bit."""
    cfg, _, _, model = _models("mixtral-8x7b", dtype)
    router = model.layers[0].router
    h = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)).to(getattr(torch, dtype))
    logits, top, experts = tf.route(h, router, cfg.top_k)
    want = (h.double().numpy() @ router.double().numpy()).astype(np.float32)
    assert router.dtype == torch.float32 and logits.dtype == torch.float32
    np.testing.assert_array_equal(logits.numpy(), want)
    np.testing.assert_array_equal(
        experts.numpy(), np.argsort(-want, axis=-1, kind="stable")[
            ..., :cfg.top_k])
    np.testing.assert_array_equal(
        top.numpy(), np.take_along_axis(want, experts.numpy(), -1))


@pytest.mark.parametrize("arch,dtype", [("mixtral-8x7b", "float32"),
                                        ("mixtral-8x7b", "bfloat16"),
                                        ("deepseek-67b", "bfloat16")])
def test_ffn_builds_the_aux_loss_only_when_asked(arch, dtype):
    """``prefill`` and ``decode_step`` call ``Block.ffn`` without the aux
    loss: the same output, and no aux (None) to build; ``forward`` asks
    for it, and a dense layer has none."""
    cfg, _, _, model = _models(arch, dtype)
    block = model.layers[0]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)).to(getattr(torch, dtype))
    plain, none = block.ffn(x)
    with_aux, aux = block.ffn(x, with_aux=True)
    assert none is None
    torch.testing.assert_close(plain, with_aux, rtol=0, atol=0)
    if not cfg.moe:
        assert aux is None
        return
    h = tf.rms_norm(x, block.ffn_norm, cfg.norm_eps)
    out, ref_aux = tf._moe_ffn(h, block, cfg)
    out_only, no_aux = tf._moe_ffn(h, block, cfg, with_aux=False)
    assert no_aux is None and aux.dtype == torch.float32
    torch.testing.assert_close(out_only, out, rtol=0, atol=0)
    torch.testing.assert_close(aux, ref_aux, rtol=0, atol=0)


# --------------------------------------------------------- whole model
class Routing:
    """The router logits of every MoE layer call on both sides, in call
    order (the reference's through a debug callback, which runs inside
    its scan over layers)."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        ref_moe, port_route = ref_tf._moe_ffn, tf.route

        def moe(h, p, cfg):
            logits = h.astype(jnp.float32) @ p["router"].astype(jnp.float32)
            jax.debug.callback(lambda a: self.ref.append(np.asarray(a)),
                               logits)
            return ref_moe(h, p, cfg)

        def route(h, router, k):
            out = port_route(h, router, k)
            self.port.append(out[0].numpy())
            return out
        monkeypatch.setattr(ref_tf, "_moe_ffn", moe)
        monkeypatch.setattr(tf, "route", route)

    def agreed(self, k: int, b: int, s: int) -> np.ndarray:
        """Per batch row, the first position whose top-k experts differ
        in some layer (s where none does). A flip not downstream of an
        earlier one (at an earlier layer and no later position) must be a
        near-tie of the reference's router; positions from the first flip
        on see it through attention and are not compared. Before it, the
        router logits of the two sides agree within ``NEAR_TIE``."""
        assert len(self.ref) == len(self.port)
        first = np.full(b, s)
        for ref, port in zip(self.ref, self.port):       # layers in order
            top_ref = np.argsort(-ref, axis=-1)[..., :k]
            top_port = np.argsort(-port, axis=-1)[..., :k]
            for row, t in np.argwhere((top_ref != top_port).any(-1)):
                if t < first[row]:
                    margin = _margins(ref, k)[row, t]
                    assert margin < NEAR_TIE, (row, t, margin)
                    first[row] = t
        for ref, port in zip(self.ref, self.port):
            for row, n in enumerate(first):
                np.testing.assert_allclose(port[row, :n], ref[row, :n],
                                           rtol=0, atol=NEAR_TIE)
        return first


def _close_rows(out, ref, first, dtype):
    """``out`` against ``ref`` (B, S, ...) at the positions before each
    row's first router flip; returns how many positions were compared."""
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    for row, n in enumerate(first):
        np.testing.assert_allclose(out[row, :n], ref[row, :n], **TOL[dtype])
    return int(first.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW)
def test_forward_matches_reference(arch, dtype, monkeypatch):
    """Logits and aux against the reference's ``forward``. In bfloat16 a
    router near-tie can flip between the frameworks (mixtral's smoke
    model, seed 1: row 0, position 39, layer 0, margin 2.0e-3): the
    logits are then compared before the flip, the aux within 5e-2."""
    cfg, ref_cfg, params, model = _models(arch, dtype)
    routing = Routing(monkeypatch)
    b, s = 2, 64
    tokens = _tokens(cfg, b, s, seed=1)
    ref, ref_aux = ref_tf.forward(params, ref_cfg, jnp.asarray(tokens))
    out, aux = tf.forward(model, torch.from_numpy(tokens))
    assert out.dtype == getattr(torch, dtype)
    assert len(routing.port) == (cfg.n_layers if cfg.moe else 0)
    first = routing.agreed(cfg.top_k, b, s)
    if dtype == "float32":
        assert (first == s).all()
    assert _close_rows(out, ref, first, dtype) >= b * s // 2
    rtol = 1e-4 if (first == s).all() else 5e-2
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=rtol)
    assert (float(aux) > 0) == cfg.moe


@pytest.mark.parametrize("arch", MOE)
def test_forward_with_dropped_routes_matches_reference(arch):
    """capacity_factor 0.5 drops routes in every layer; the chunked path
    too."""
    cfg, ref_cfg, params, model = _models(arch, "float32",
                                          capacity_factor=0.5)
    tokens = _tokens(cfg, 2, 96, seed=7)
    for path in ("dense", "chunked"):
        ref, ref_aux = ref_tf.forward(params, ref_cfg, jnp.asarray(tokens),
                                      attn_path=path)
        out, aux = tf.forward(model, torch.from_numpy(tokens),
                              attn_path=path)
        _close(out, ref, "float32")
        np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-4)
    full, _ = tf.forward(model, torch.from_numpy(tokens))
    undropped = tf.params_from_numpy(
        dataclasses.replace(cfg, capacity_factor=8.0),
        jax.tree.map(np.asarray, params), device="cpu")
    free, _ = tf.forward(undropped, torch.from_numpy(tokens))
    assert float((full - free).abs().max()) > 1e-2   # the drops show


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW)
def test_prefill_matches_reference(arch, dtype, monkeypatch):
    """Logits and cache against the reference's ``prefill``, under
    mixtral's 64-token window; a row with a router near-tie flip (in
    bfloat16, mixtral's smoke model: row 1, position 38, layer 0, margin
    8.6e-5) is compared before the flip."""
    cfg, ref_cfg, params, model = _models(arch, dtype)
    routing = Routing(monkeypatch)
    b, s = 2, 48
    tokens = _tokens(cfg, b, s, seed=2)
    ref_logits, ref_cache = ref_tf.prefill(params, ref_cfg,
                                           jnp.asarray(tokens))
    logits, cache = tf.prefill(model, torch.from_numpy(tokens))
    assert logits.shape == ref_logits.shape == (b, 1, cfg.vocab)
    first = routing.agreed(cfg.top_k, b, s)
    if dtype == "float32":
        assert (first == s).all()
    assert (first == s).any()
    _close_rows(logits, ref_logits, (first == s).astype(int), dtype)
    for name in ("k", "v"):
        assert cache[name].shape == ref_cache[name].shape
        for layer in range(cfg.n_layers):
            assert _close_rows(cache[name][layer], ref_cache[name][layer],
                               first, dtype) >= b * s // 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW)
def test_per_slot_decode_matches_reference(arch, dtype):
    """Six batched steps with a different position in every slot; the
    cache is bfloat16 on both sides whatever the parameters' dtype."""
    cfg, ref_cfg, params, model = _models(arch, dtype)
    b, max_len = 4, 32
    ref_cache = ref_tf.init_cache(ref_cfg, b, max_len)
    cache = tf.init_cache(cfg, b, max_len, device="cpu")
    t = np.array([0, 3, 9, 30], np.int32)
    step = jax.jit(lambda p, c, tok, tt: ref_tf.decode_step(p, ref_cfg, c,
                                                            tok, tt))
    for i in range(6):
        tokens = _tokens(cfg, b, 1, seed=10 + i)
        ref_logits, ref_cache = step(params, ref_cache, jnp.asarray(tokens),
                                     jnp.asarray(t))
        logits, cache = tf.decode_step(model, cache,
                                       torch.from_numpy(tokens),
                                       torch.from_numpy(t))
        _close(logits, ref_logits, dtype)
        t = (t + 1) % max_len                # slot 3 wraps to position 0
    for name in ("k", "v"):
        assert cache[name].dtype == torch.bfloat16
        _close(cache[name], ref_cache[name], "bfloat16")


@pytest.mark.parametrize("arch", MOE)
def test_decode_agrees_with_forward_where_nothing_drops(arch):
    """Lockstep decode over a sequence against the port's own forward at
    a capacity where the forward drops nothing (decode never drops),
    within the gap the bfloat16 cache leaves."""
    cfg, _, _, model = _models(arch, "float32")
    tokens = _tokens(cfg, 2, 12, seed=3)
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    outs = []
    for i in range(tokens.shape[1]):
        logits, cache = tf.decode_step(
            model, cache, torch.from_numpy(tokens[:, i:i + 1]), i)
        outs.append(logits)
    full, _ = tf.forward(model, torch.from_numpy(tokens))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=3e-2, rtol=0)


def test_init_lm_moe_shapes_and_dtypes():
    cfg = configs.get("mixtral-8x7b").scaled()
    model = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    n = sum(p.numel() for p in model.parameters())
    # the reference's count leaves the router out
    assert n == cfg.param_count() + cfg.n_layers * cfg.d_model * \
        cfg.n_experts
    block = model.layers[0]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert block.router.dtype == torch.float32
    assert tuple(block.router.shape) == (d, e)
    assert tuple(block.w_gate.shape) == (e, d, f)
    assert tuple(block.w_down.shape) == (e, f, d)
    assert block.w_up.dtype == torch.bfloat16
    again = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert torch.equal(block.router, again.layers[0].router)


def test_params_from_numpy_keeps_the_router_float32():
    cfg, _, params, _ = _models("mixtral-8x7b", "bfloat16")
    model = tf.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu", dtype=torch.bfloat16)
    assert model.layers[0].router.dtype == torch.float32
    assert model.layers[0].w_gate.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.layers[1].router.numpy(),
        np.asarray(params["layers"]["router"][1]))
