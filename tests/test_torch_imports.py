"""Import hygiene of the port: it never needs JAX or the JAX package."""
import re
import subprocess
import sys
from pathlib import Path

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
    assert {"reliability/faults.py", "reliability/snapshot.py",
            "ingest/parse.py", "ingest/idmap.py",
            "ingest/pipeline.py", "gateway/__init__.py",
            "gateway/frontdoor.py", "gateway/autotune.py",
            "gateway/cache.py", "gateway/qos.py", "obs/__init__.py",
            "obs/trace.py", "obs/comm.py", "obs/metrics.py"} <= scanned
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
