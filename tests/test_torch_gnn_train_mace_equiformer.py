"""Five steps of the port's ``make_gnn_train_step`` against the JAX
package's for mace and equiformer-v2, as ``test_torch_gnn_train.py``
holds graphcast and nequip (its docstring states the tolerances and
what was measured)."""
import pytest

from test_torch_gnn import one_torch_thread  # noqa: F401
from test_torch_gnn_train import five_steps


@pytest.mark.parametrize("arch", ["mace", "equiformer-v2"])
def test_five_train_steps_match_the_reference(arch):
    five_steps(arch)
