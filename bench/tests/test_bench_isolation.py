"""No module the command loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``repro`` (the part before the first dot,
compared whole: ``repro_torch`` is the program), and the reference loads
nothing of ``repro_torch``. Each case runs in a fresh interpreter."""
import json
import subprocess
import sys

import pytest

from bench.tests.conftest import ROOT, TINY

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_modules(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "",
             "HOME": str(ROOT / "bench"), "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_run_loads_no_jax(cell):
    code = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]\n"
            "from bench.tests.conftest import tiny_run\n"
            f"result, _ = tiny_run({cell!r}, trace=True)\n"
            "assert result['correct'], result\n"
            "print(json.dumps(sorted(sys.modules)))")
    tops = loaded_modules(code)
    assert "repro_torch" in tops                 # the program did run
    assert not tops & FORBIDDEN


def test_the_reference_and_control_load_nothing_of_the_program():
    code = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}]\n"
            "from bench import control\n"
            "from bench.tests.conftest import spec_root\n"
            "for cell, over in [('kron-solve', {'scale': 8, "
            "'edge_factor': 4}), ('kron-serve', {'scale': 8, "
            "'edge_factor': 4})]:\n"
            "    control.control(cell, 3, 'cpu', root=spec_root(cell),\n"
            "                    config_overrides=over,\n"
            "                    traffic_overrides={'sample': 2,\n"
            "                                       'max_queries': 50})\n"
            "print(json.dumps(sorted(sys.modules)))")
    tops = loaded_modules(code)
    assert "torch" in tops
    assert not tops & (FORBIDDEN | {"repro_torch"})
