"""Port vs reference: the cell bookkeeping (``launch/specs.py``) and the
card's constants (``launch/__init__.py``), on the CPU.

Each of the reference's 40 cells (``all_cells()``) and its GNN PCPM cell
(graphcast at ogb_products, ``engine="pcpm"``) is built in both packages,
the reference's under ``use_rules(make_host_mesh(), rule_overrides(arch,
shape))`` on this process's one host device. The names, ``model_flops``,
``loop_trip`` and ``skip`` must be equal.
"""
import pytest

from repro_torch import launch
from repro_torch.launch import specs

from test_torch_reference import load_reference

ref_specs = load_reference("launch.specs")
ref_mesh = load_reference("launch.mesh")
ref_sharding = load_reference("launch.sharding")

CELLS = [(a, s, "xla") for a, s in ref_specs.all_cells()] + [
    ("graphcast", "ogb_products", "pcpm")]


def assert_cells_equal(cell, ref):
    assert cell.arch == ref.arch and cell.shape == ref.shape
    assert cell.skip == ref.skip
    assert cell.loop_trip == ref.loop_trip
    assert cell.model_flops == ref.model_flops


def ref_cell(arch, shape, engine, **kw):
    with ref_sharding.use_rules(ref_mesh.make_host_mesh(),
                                ref_specs.rule_overrides(arch, shape)):
        return ref_specs.make_cell(arch, shape, engine=engine, **kw)


@pytest.mark.parametrize("arch,shape,engine", CELLS,
                         ids=[f"{a}-{s}-{e}" for a, s, e in CELLS])
def test_cell_matches_the_reference(arch, shape, engine):
    cell = specs.make_cell(arch, shape, engine=engine)
    assert_cells_equal(cell, ref_cell(arch, shape, engine))


def test_all_cells_and_the_pcpm_cell():
    assert specs.all_cells() == ref_specs.all_cells()
    assert len(specs.all_cells()) == 40
    cell = specs.make_cell("graphcast", "ogb_products", engine="pcpm")
    plain = specs.make_cell("graphcast", "ogb_products")
    assert cell.arch == "graphcast+pcpm"
    assert cell.model_flops == plain.model_flops
    with pytest.raises(ValueError, match="full-graph"):
        specs.make_cell("graphcast", "minibatch_lg", engine="pcpm")


@pytest.mark.parametrize("mode", ["compile", "cost"])
def test_cost_mode_and_layers_follow_the_reference(mode):
    """The reference's cost pass (one microbatch) keeps the cell's
    bookkeeping; a depth cut moves the LM's trip count and the GNN's
    model flops."""
    for arch, shape in (("tinyllama-1.1b", "train_4k"),
                        ("graphcast", "full_graph_sm")):
        cell = specs.make_cell(arch, shape, layers=2)
        assert_cells_equal(cell, ref_cell(arch, shape, "xla", mode=mode,
                                          layers=2))


def test_card_constants():
    """The H100 80GB HBM3 (SXM5) datasheet's peaks, which ``chip_smoke.py``
    reads from here."""
    assert launch.PEAK_FLOPS_BF16 == 989e12
    assert launch.HBM_BW == 3.35e12
    assert launch.HBM_BYTES == 80e9
    import importlib.util
    from test_torch_reference import REPO
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.PEAK_BF16_PER_S == launch.PEAK_FLOPS_BF16
    assert chip_smoke.PEAK_BYTES_PER_S == launch.HBM_BW
