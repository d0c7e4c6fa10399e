"""BENCHMARK.json against the benchmark's contract, and finding a
configuration, a traffic mix and a metric by name, also new ones added
as files."""
import json
import re
import shutil

import pytest

from bench import spec as specs
from bench.tests.conftest import ROOT, TINY, spec_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keys_and_names():
    spec = specs.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"][:2] == ["python3", "bench/run.py"]
    assert spec["paths"] == ["bench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (specs.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in {"host_clock", "device_trace"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
        assert m["source"] in SOURCES
        assert (specs.BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    spec = specs.load_spec()
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reported = {x["name"] for x in
                        specs.cell_metrics(spec, cell, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)
    for w in spec["workloads"]:
        reported = {x["name"] for x in
                    specs.cell_metrics(spec, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert specs.cell_metrics(spec, w["name"], "per_layer")


@pytest.mark.parametrize("cell", sorted(TINY))
def test_parts_found_by_name(cell):
    root = spec_root(cell)
    spec = specs.load_spec(root)
    w = specs.find_cell(spec, cell)
    config = specs.load_config(spec, w, root)
    traffic = specs.load_traffic(w["traffic"])
    assert config["name"] == w["config"]
    assert hasattr(specs.loadgen(traffic), "run")
    assert hasattr(specs.generator(config), "make")
    for m in specs.cell_metrics(spec, cell, "per_layer"):
        assert callable(specs.reader(m["name"]).read)


def test_new_config_mix_and_metric_are_only_new_files(tmp_path, tiny):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell as new files and new entries alone, and a run of
    the new cell finds and reports them."""
    bench = tmp_path / "bench"
    shutil.copytree(specs.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = specs.load_spec()
    (bench / "configs" / "kron_b.json").write_text(json.dumps(
        dict(specs.load_json(specs.BENCH / "configs" / "kron.json"),
             name="kron_b", b=0.2, c=0.18)))
    (bench / "traffic" / "solve_loop_5.json").write_text(json.dumps(
        dict(specs.load_traffic("solve_loop"), num_iterations=5)))
    (bench / "metrics" / "solves_counted.py").write_text(
        "def read(run):\n    return float(run.extra['solves'])\n")
    spec["configs"].append({"name": "kron_b", "source": "https://x.org/y",
                            "file": "bench/configs/kron_b.json",
                            "reduced": ["scale"], "why": "a test"})
    spec["workloads"].append({"name": "kron_b-solve5", "config": "kron_b",
                              "traffic": "solve_loop_5", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "solves_counted", "unit": "solves",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["kron_b-solve5"]})
    spec["end_to_end"][0]["workloads"].append("kron_b-solve5")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    TINY["kron_b-solve5"] = TINY["kron-solve"]
    try:
        result, _ = tiny(
            "kron_b-solve5", root=tmp_path, bench=bench)
    finally:
        del TINY["kron_b-solve5"]
    assert result["correct"] is True
    assert result["metrics"]["solves_counted"]["value"] >= 1
    assert {"solve_ms", "setup_s"} <= set(result["metrics"])
