"""The cell ``kron-solve-degree`` on the CPU at a tiny size: a run is
correct, a traced run reads ``reorder_s`` from the program's spans, the
check fails a wrong map back to the original ids and the bfloat16
control, and the load generator refuses a configuration without a node
ordering."""
import json
import time

import pytest
import torch

from bench import checks, control, harness
from bench import spec as specs
from bench.tests.conftest import ROOT
from bench.tests.test_bench_isolation import FORBIDDEN, loaded_modules

CELL = "kron-solve-degree"
CONFIG = {"scale": 10, "edge_factor": 8, "part_size": 512}
# the trace starts with the window's first solve: on a loaded host one
# tiny solve can outlast a later start and the whole window
TRAFFIC = {"trace_offset_s": 0.0, "trace_seconds": 0.2}


def tiny_run(*, trace=False, config=None, seed=7):
    return harness.run_cell(
        CELL, seed=seed, seconds=1.0, trace=trace, device="cpu",
        t_start=time.perf_counter(), config_overrides={**CONFIG,
                                                       **(config or {})},
        traffic_overrides=TRAFFIC)


def test_the_cell_is_a_reordered_kron_solve():
    spec = specs.load_spec()
    cell = specs.find_cell(spec, CELL)
    config = specs.load_config(spec, cell)
    assert (cell["chips"], config["generator"], config["reorder"],
            config["method"]) == (1, "kron", "degree", "pcpm_pallas")
    kron = specs.load_json(specs.BENCH / "configs" / "kron.json")
    same = ("edge_factor", "a", "b", "c", "part_size", "damping", "dtype",
            "dangling", "reference")
    assert {k: config[k] for k in same} == {k: kron[k] for k in same}
    traffic = specs.load_traffic(cell["traffic"])
    plain = specs.load_traffic("solve_loop")
    assert {k: v for k, v in traffic.items() if k not in ("loadgen", "why")} \
        == {k: v for k, v in plain.items() if k not in ("loadgen", "why")}


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_a_run_is_correct(seed):
    result, compared = tiny_run(seed=seed)
    assert result["correct"] is True, result
    assert {"solve_ms", "setup_s"} <= set(result["metrics"])
    assert all(v["value"] <= v["limit"] for v in compared.values())


def test_a_traced_run_reads_reorder_s():
    result, _ = tiny_run(trace=True)
    assert result["correct"] is True, result
    metrics = result["metrics"]
    assert metrics["reorder_s"]["value"] > 0
    assert metrics["reorder_s"]["unit"] == "s"
    assert metrics["reorder_s"]["value"] < metrics["prep_s"]["value"]


def test_reorder_s_reads_nothing_without_the_spans():
    reader = specs.reader("reorder_s")
    run = harness.Run({}, {}, {}, 7, 1.0, True, torch.device("cpu"), 0.0)
    assert reader.read(run) is None
    run.extra["setup_spans"] = []
    assert reader.read(run) is None


def test_a_wrong_map_back_is_not_correct(monkeypatch):
    """Ranks left in the relabeled ids fail the check, which compares
    them with the reference's in the original ids."""
    from repro_torch.core import backends

    def identity(plan, device):
        ids = torch.arange(plan.num_nodes, device=device)
        return ids, ids

    monkeypatch.setattr(backends, "reorder_device", identity)
    result, compared = tiny_run()
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in compared.values())


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_fails(seed):
    numbers = control.control(CELL, seed, "cpu", config_overrides=CONFIG,
                              traffic_overrides=TRAFFIC)
    limits = specs.load_traffic("solve_loop_reordered")["limits"]
    ok, _ = checks.verdict(numbers, limits)
    assert not ok, numbers


@pytest.mark.parametrize("reorder", ["none", None])
def test_the_load_generator_refuses_a_configuration_without_reorder(
        reorder):
    load = specs.loadgen(specs.load_traffic("solve_loop_reordered"))
    config = dict(specs.load_config(specs.load_spec(),
                                    specs.find_cell(specs.load_spec(), CELL)))
    if reorder is None:
        del config["reorder"]
    else:
        config["reorder"] = reorder
    with pytest.raises(ValueError, match="reorder"):
        load.ordering(config)
    if reorder is not None:
        with pytest.raises(ValueError, match="reorder"):
            tiny_run(config={"reorder": reorder})


def test_a_traced_run_loads_no_jax():
    code = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]\n"
            "from bench.tests import test_bench_reordered as t\n"
            "result, _ = t.tiny_run(trace=True)\n"
            "assert result['correct'], result\n"
            "print(json.dumps(sorted(sys.modules)))")
    tops = loaded_modules(code)
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN


def test_the_result_line_is_json():
    result, _ = tiny_run(trace=True)
    line = json.loads(json.dumps(result))
    assert line["device"]["platform"] == "cpu"
    assert line["checks"].keys() == {"ranks_l1_rel", "ranks_max_rel"}
