"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names the cells; each cell
names a configuration (``configs[].file``) and a traffic mix. A mix is
``bench/traffic/<name>.json``, whose ``loadgen`` names
``bench/loadgen/<loadgen>.py``; a configuration's ``generator`` names
``bench/gen/<generator>.py``; a metric is read by
``bench/metrics/<metric>.py``. Modules are loaded from their files, so
a name may hold dots (``device_idle_pct.solve``).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_spec(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{[c['name'] for c in spec['workloads']]}")


def config_entry(spec: dict, name: str) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(spec: dict, cell: dict, root: Path = ROOT) -> dict:
    return load_json(Path(root) / config_entry(spec, cell["config"])["file"])


def load_traffic(name: str, bench: Path = BENCH) -> dict:
    return load_json(Path(bench) / "traffic" / f"{name}.json")


def load_module(path: Path, label: str) -> ModuleType:
    """The module in ``path``, loaded under the name ``label``."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loadgen(traffic: dict, bench: Path = BENCH) -> ModuleType:
    name = traffic["loadgen"]
    return load_module(Path(bench) / "loadgen" / f"{name}.py",
                       f"bench_loadgen_{name}")


def generator(config: dict, bench: Path = BENCH) -> ModuleType:
    name = config["generator"]
    return load_module(Path(bench) / "gen" / f"{name}.py",
                       f"bench_gen_{name}")


def reader(metric: str, bench: Path = BENCH) -> ModuleType:
    return load_module(Path(bench) / "metrics" / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_"))


def cell_metrics(spec: dict, cell: str, kind: str) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that ``cell``
    reports: those whose ``workloads`` name it, or that have no
    ``workloads`` key."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]
