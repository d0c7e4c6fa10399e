"""The optimizer: the port's ``optim.AdamW`` and ``cosine_schedule``
against the JAX package's, on identical numpy inputs.

Three updates of the same parameters with the same gradients on both
sides (a clip that binds, then one that does not), with moments stored
in float32 and in bfloat16, parameters in float32 and bfloat16. The
arithmetic is elementwise float32 on both sides; XLA's ``pow`` and
fused roundings differ from torch's by an ulp, so float32 results are
held to rtol 1e-6 (atol 1e-9 for moments near 0). A bfloat16 value
(moment or parameter) may round one bfloat16 step apart where the two
float32 values straddle a rounding boundary: held within one step
(2**-8 relative). The learning rate of the cosine schedule to rtol 1e-6
at every step of a 0..120 sweep.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.optim import AdamW, AdamWState, cosine_schedule

from test_torch_reference import load_reference

ref_optim = load_reference("optim")

F32 = dict(rtol=1e-6, atol=1e-9)
BF16_STEP = 2.0 ** -8


def _inputs(param_dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (16, 8), "layers.0.wq": (8, 8), "norm": (8,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: (rng.standard_normal(s) * scale).astype(np.float32)
              for n, s in shapes.items()} for scale in (3.0, 0.01, 0.05)]
    if param_dtype == "bfloat16":
        params = {n: np.asarray(jnp.asarray(p, jnp.bfloat16).astype(
            jnp.float32)) for n, p in params.items()}
    return params, grads


def _torch(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _close(out, ref, dtype):
    out = out.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(out, ref, rtol=BF16_STEP, atol=1e-30)
    else:
        np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_update_matches_reference(state_dtype, param_dtype, schedule):
    params, grads = _inputs(param_dtype)
    pt = getattr(torch, param_dtype)
    lr = cosine_schedule(1e-2, 2, 10) if schedule else 1e-2
    ref_lr = ref_optim.cosine_schedule(1e-2, 2, 10) if schedule else 1e-2
    opt = AdamW(lr=lr, state_dtype=state_dtype)
    ref = ref_optim.AdamW(lr=ref_lr, state_dtype=state_dtype)
    p = {n: _torch(a, pt) for n, a in params.items()}
    rp = {n: jnp.asarray(a).astype(getattr(jnp, param_dtype))
          for n, a in params.items()}
    state, rstate = opt.init(p), ref.init(rp)
    assert isinstance(state, AdamWState)
    sd = getattr(torch, state_dtype)
    assert {m.dtype for m in state.mu.values()} == {sd}
    for g in grads:
        p, state, gnorm = opt.update({n: _torch(a, pt) for n, a in g.items()},
                                     state, p)
        rp, rstate, rgnorm = ref.update(
            {n: jnp.asarray(a).astype(getattr(jnp, param_dtype))
             for n, a in g.items()}, rstate, rp)
        np.testing.assert_allclose(float(gnorm), float(rgnorm), rtol=1e-6)
        assert int(state.step) == int(rstate.step)
        for n in params:
            _close(p[n], rp[n], pt)
            _close(state.mu[n], rstate.mu[n], sd)
            _close(state.nu[n], rstate.nu[n], sd)
            assert p[n].dtype == pt and state.mu[n].dtype == sd


def test_adamw_updates_in_place():
    """The port writes the new parameters and moments into the tensors it
    is given (the reference returns new arrays)."""
    params, grads = _inputs("float32")
    p = {n: _torch(a, torch.float32) for n, a in params.items()}
    opt = AdamW(lr=1e-2)
    state = opt.init(p)
    ptrs = {n: t.data_ptr() for n, t in p.items()}
    out, new, _ = opt.update({n: _torch(a, torch.float32)
                              for n, a in grads[0].items()}, state, p)
    assert out is p and new.mu is state.mu
    assert {n: t.data_ptr() for n, t in out.items()} == ptrs
    assert not torch.equal(p["embed"], _torch(params["embed"],
                                              torch.float32))


def test_cosine_schedule_matches_reference():
    for args in ((3e-4, 100, 1000), (1e-2, 0, 50, 0.2), (5e-3, 7, 7)):
        ours, ref = cosine_schedule(*args), ref_optim.cosine_schedule(*args)
        steps = np.arange(0, 121, dtype=np.int32)
        got = np.array([float(ours(torch.tensor(s))) for s in steps])
        want = np.array([float(ref(jnp.asarray(s))) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
