"""Import hygiene of the port: it never needs JAX or the JAX package;
and every name the JAX package exports has its counterpart."""
import ast
import importlib
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now fails
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert {"repro_torch.gateway", "repro_torch.obs"} <= set(names), names
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "repro_ref")
             and sys.modules[m] is not None)
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(REPO / "src"),
         str(REPO)], capture_output=True, text=True, timeout=300,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


def test_source_scan_finds_no_jax_or_reference_import():
    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_torch)"
        r"|from\s+(jax|jaxlib|repro)\b(?!_torch))", re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 16
    # the reliability, ingest, gateway and observability slices are in
    # the scan
    scanned = {str(f.relative_to(PORT)) for f in files[:-1]}
    assert {"core/distributed.py",
            "reliability/faults.py", "reliability/snapshot.py",
            "ingest/parse.py", "ingest/idmap.py",
            "ingest/pipeline.py", "gateway/__init__.py",
            "gateway/frontdoor.py", "gateway/autotune.py",
            "gateway/cache.py", "gateway/qos.py", "obs/__init__.py",
            "obs/trace.py", "obs/comm.py", "obs/metrics.py",
            "optim/adamw.py", "data/tokens.py", "train/trainer.py",
            "train/checkpoint.py", "train/compression.py",
            "launch/train.py"} <= scanned
    hits = [(str(f.relative_to(REPO)), m.group(0).strip())
            for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_chip_smoke_refuses_without_cuda():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the script runs for real")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


# names of the JAX package's ``__all__`` lists that the port does not
# have yet, each with the ROADMAP item that brings it
LATER = {}
# names of the JAX package's ``__all__`` lists that have no meaning on one
# card (TPU meshes and sharding rules, the TPU's interconnect, Pallas's
# interpret mode and VMEM tile): each stands in README.md's "Left to the
# TPU" section, with why and the port's nearest counterpart
TPU_ONLY = {
    "launch": ("make_production_mesh", "make_host_mesh", "sharding",
               "ICI_BW_PER_LINK"),
    "kernels.pcpm_spmv": ("default_interpret", "pick_u_tile"),
}
# the other TPU-only parts of the JAX package that the section names
TPU_ONLY_PARTS = ("DCN_BW", "launch/dryrun.py", "sqrt_remat", "remat_dots",
                  "dist_graph_shardings", "in_shardings", "rule_overrides",
                  "param_shapes", "cache_shapes", "param_logical",
                  "shard_params", "DistGraph.abstract", "perf_flags.py",
                  "REPRO_PERF")
# the TPU kernels' entry points and their Hopper counterparts
COUNTERPARTS = {
    ("kernels.pcpm_spmv", "pcpm_gather_pallas"): "pcpm_gather_cuda",
    ("kernels.embedding_bag", "embedding_bag_pallas"): "embedding_bag_cuda",
    ("kernels.flash_attention", "flash_attention_pallas"):
        "flash_attention_cuda",
}
REF_INITS = sorted((REPO / "src" / "repro").rglob("__init__.py"))


def _reference_all(init: Path) -> list:
    """``__all__`` of a JAX-package ``__init__.py``, read from its source
    (``import repro`` fails on this runtime)."""
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


@pytest.mark.parametrize("init", REF_INITS, ids=lambda p: str(
    p.parent.relative_to(REPO / "src" / "repro")))
def test_reference_exports_exist_in_the_port(init):
    rel = init.parent.relative_to(REPO / "src" / "repro")
    sub = ".".join(rel.parts)
    names = _reference_all(init)
    try:
        mod = importlib.import_module(
            "repro_torch" + (f".{sub}" if sub else ""))
    except ModuleNotFoundError:
        mod = None
    later = LATER.get(sub, {})
    tpu_only = set(TPU_ONLY.get(sub, ()))
    assert not tpu_only & set(later)
    missing = set()
    for name in names:
        twin = COUNTERPARTS.get((sub, name), name)
        if mod is None or not hasattr(mod, twin):
            missing.add(name)
    # the exceptions are exactly what is missing: a name that arrives
    # leaves the list with its item
    expected = set(later) | tpu_only
    assert missing == expected, (sub, sorted(missing ^ expected))
    roadmap = (REPO / "ROADMAP.md").read_text()
    for name, item in later.items():
        assert re.fullmatch(r"A11\.\d", item), (name, item)
        assert f"**{item} " in roadmap, item


def test_every_reference_init_is_covered():
    subs = {".".join(p.parent.relative_to(REPO / "src" / "repro").parts)
            for p in REF_INITS}
    assert set(LATER) <= subs
    assert set(TPU_ONLY) <= subs
    assert {sub for sub, _ in COUNTERPARTS} <= subs
    assert len(REF_INITS) >= 18


def test_tpu_only_names_are_documented():
    """Every TPU-only name stands in README.md's "Left to the TPU"
    section (between its heading and the next), and nothing is left to
    port."""
    readme = (REPO / "README.md").read_text()
    head = readme.index("\n## Left to the TPU\n")
    end = readme.find("\n## ", head + 1)
    section = readme[head:end if end >= 0 else len(readme)]
    names = [n for names in TPU_ONLY.values() for n in names]
    for name in names + list(TPU_ONLY_PARTS):
        assert f"`{name}`" in section, name
    assert LATER == {}
