"""Five steps of the port's ``make_gnn_train_step`` against the JAX
package's, for graphcast and nequip here and for mace and equiformer-v2
in ``test_torch_gnn_train_mace_equiformer.py`` (two files, so that
neither runs much over a minute), each GNN at the smoke size on the
reference's parameters and one graph (``test_torch_gnn.py``'s setup),
with the reference's smoke-test optimizer ``AdamW(lr=3e-3,
weight_decay=0.0)`` (``tests/test_gnn_smoke.py``) in both packages. The
reference's step runs as its function is written, without ``jax.jit``:
XLA's fusions round otherwise, and the reference's own jitted and eager
steps end 5.3e-6 apart on graphcast (the port ends 1.38e-5 from the
jitted one and 8.5e-6 from the eager one there).

Held after each step: loss and gnorm within rtol 1e-5 (measured at most
4e-6, graphcast's gnorm at step 5: the first steps move the parameters by
up to lr each, so the two orders of float32 rounding drift apart); after
5 steps every parameter within atol 1e-5 (measured at most 8.5e-6,
graphcast's ``layers.1.node_mlp.0.w``; the others below 5e-6).

The leaves whose gradient is zero in exact arithmetic
(``gnn.ZERO_GRADIENT_LEAVES``: equiformer-v2's ``attn.1.b``, mace's
``b3.1``) get rounding noise for a
gradient, and Adam normalises it into steps of up to ~lr whose signs
depend on the noise (measured gaps up to 4.9e-4 after 5 steps). They are
held to within 5 lr of their start on both sides instead.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.models import gnn
from repro_torch.optim import AdamW

from test_torch_gnn import (N_OUT, leaf_name, one_torch_thread,  # noqa: F401
                            setup)
from test_torch_reference import load_reference

ref_gnn = load_reference("models.gnn")
ref_optim = load_reference("optim")

STEPS = 5
LR = 3e-3
METRIC_RTOL = 1e-5
PARAM_ATOL = 1e-5


def five_steps(arch):
    """Train the port and the reference side by side; hold the metrics
    after each step and the parameters after the last."""
    (cfg, model, g), (ref_cfg, params, ref_g) = setup(arch, 2)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    ref_opt = ref_optim.AdamW(lr=LR, weight_decay=0.0)
    ref_state = ref_opt.init(params)
    ref_step = ref_gnn.make_gnn_train_step(ref_cfg, ref_opt, n_out=N_OUT)
    opt = AdamW(lr=LR, weight_decay=0.0)
    state = opt.init(model)
    step = gnn.make_gnn_train_step(cfg, opt, n_out=N_OUT)
    losses = []
    for i in range(STEPS):
        params, ref_state, ref_m = ref_step(params, ref_state, ref_g)
        model, state, m = step(model, state, g)
        for key in ("loss", "gnorm"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]),
                                       rtol=METRIC_RTOL, err_msg=(i, key))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    mine = dict(model.named_parameters())
    zero = gnn.ZERO_GRADIENT_LEAVES.get(arch, ())
    for path, ref in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = leaf_name(path)
        ref, got = np.asarray(ref), mine[name].detach().numpy()
        if zero and name.endswith(zero):
            moved = np.abs(got - start[name].numpy()).max()
            ref_moved = np.abs(ref - start[name].numpy()).max()
            assert max(moved, ref_moved) <= STEPS * LR, name
            continue
        np.testing.assert_allclose(got, ref, rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["graphcast", "nequip"])
def test_five_train_steps_match_the_reference(arch):
    five_steps(arch)
