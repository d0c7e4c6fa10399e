"""The command's refusals, and the serving mix's query draws."""
import shutil
import subprocess
import sys

import numpy as np

from bench import spec as specs
from bench.tests.conftest import ROOT

ENV = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
       "HOME": str(ROOT / "bench")}


def run_command(cwd, *args):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "kron-solve",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=ENV)


def test_no_card_no_result():
    out = run_command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_query_draws():
    gc = specs.load_module(specs.BENCH / "loadgen" / "gateway_closed.py",
                           "bench_loadgen_gc_test")
    tr = {"max_queries": 3000, "seeds_per_query": 4}
    q = gc.draw_queries(2 ** 31 + 5, 1000, tr)
    assert q.shape == (3000, 4) and q.min() >= 0 and q.max() < 1000
    assert np.array_equal(q, gc.draw_queries(2 ** 31 + 5, 1000, tr))
    assert not np.array_equal(q, gc.draw_queries(2 ** 31 + 6, 1000, tr))
    counts = np.bincount(q.reshape(-1), minlength=1000)
    assert counts.min() > 0 and counts.max() < 3 * counts.mean()  # uniform
