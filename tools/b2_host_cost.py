#!/usr/bin/env python3
"""Where the host microseconds of a kernel B2 call go, at MIND's
serve_p99 lookup (25,600 one-id bags on the 10M x 64 float32 table), on
one CUDA card.

    python3 tools/b2_host_cost.py [--src DIR]    # from a checkout's root

Times, with ``time.perf_counter_ns`` around each call, over ``CALLS``
calls each (median and mean per call): the whole wrapper
(``embedding_bag_cuda``), MIND's ``lookup`` (a reshape on each side of
the wrapper in older trees, one ``embedding_lookup`` call in newer
ones), the wrapper's ``_check``, and each step a launch's host side may
take: the capability query, a ``torch.cuda.device`` context,
``current_device``, ``current_stream(...).cuda_stream`` and the raw
stream handle, the output's ``torch.empty``, the two reshapes, a
``ctypes`` call of a no-op C function with the 18 arguments of B2's
unpacked C interface and with the two of the packed one, packing 17
int64s, and ``F.embedding_bag`` on the same ids (the library call). The
steps do not depend on the wrapper's version; ``--src`` points the
wrapper, lookup and check lines at another checkout's ``src`` (e.g. the
parent commit, unpacked by ``git archive``), so two versions are timed
by the same script.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CALLS = 1000
SYNC_EVERY = 100          # keep the launch queue short; not timed

NOOP_SOURCE = r"""
extern "C" int noop18(int a, int b, const void* c, long long d, long long e,
                      const void* f, long long g, long long h, const void* i,
                      long long j, long long k, void* l, long long m, int n,
                      int o, int p, long long q, void* r) {
  return a + n;
}
extern "C" int noop2(const long long* a, void* s) { return (int)a[0]; }
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def per_call_us(fn, sync) -> tuple[float, float]:
    """(median, mean) host microseconds of ``fn()`` over CALLS calls."""
    for _ in range(20):
        fn()
    sync()
    samples = []
    for i in range(CALLS):
        t0 = time.perf_counter_ns()
        fn()
        samples.append(time.perf_counter_ns() - t0)
        if i % SYNC_EVERY == SYNC_EVERY - 1:
            sync()
    sync()
    return statistics.median(samples) / 1e3, statistics.fmean(samples) / 1e3


def main() -> None:
    import torch
    import torch.nn.functional as F
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory whose repro_torch is timed")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        log("b2_host_cost: torch.cuda.is_available() is False: this script "
            "runs on a CUDA card")
        sys.exit(1)
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.configs import RECSYS_SHAPES, get
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import kernel as b2
    from repro_torch.models import recsys

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; timing {Path(b2.__file__).resolve()}")
    noop = _build.BUILD_DIR / "noop_launch.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    noop.write_text(NOOP_SOURCE)
    lib, _ = _build.load(noop)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.noop18.argtypes = ([i32, i32, ptr, i64, i64, ptr, i64, i64, ptr, i64,
                            i64, ptr, i64] + [i32] * 3 + [i64, ptr])
    lib.noop18.restype = i32
    lib.noop2.argtypes = [ptr, ptr]
    lib.noop2.restype = i32

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get("mind")
    shape = {s.name: s for s in RECSYS_SHAPES}["serve_p99"]
    table = torch.randn((cfg.vocab, cfg.embed_dim), device=dev)
    ids = torch.from_numpy(chip_smoke.histories(
        np.random.default_rng(0), shape.global_batch, cfg)).to(dev)
    flat = ids.reshape(-1, 1)
    rows = b2.embedding_bag_cuda(table, flat)
    valid = flat < cfg.vocab
    lib_ids, lib_w = torch.where(valid, flat, 0), valid.to(table.dtype)
    packer = struct.Struct("17q")
    values = list(range(17))
    sync = torch.cuda.synchronize
    p = table.data_ptr()

    def device_context():
        with torch.cuda.device(dev):
            pass

    steps = {
        "wrapper embedding_bag_cuda": lambda: b2.embedding_bag_cuda(table,
                                                                    flat),
        "MIND lookup (recsys.lookup)": lambda: recsys.lookup(table, ids),
        "F.embedding_bag (library)": lambda: F.embedding_bag(
            lib_ids, table, mode="sum", per_sample_weights=lib_w),
        "wrapper _check": lambda: b2._check(table, flat, None),
        "get_device_capability": lambda: torch.cuda.get_device_capability(
            dev),
        "torch.cuda.device context": device_context,
        "current_device": torch.cuda.current_device,
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(
            dev.index),
        "torch.empty (B, d)": lambda: torch.empty(
            (flat.shape[0], cfg.embed_dim), dtype=table.dtype, device=dev),
        "ids.reshape(-1, 1)": lambda: ids.reshape(-1, 1),
        "rows.reshape(B, L, d)": lambda: rows.reshape(*ids.shape,
                                                      cfg.embed_dim),
        "ctypes call, 18 arguments": lambda: lib.noop18(
            0, 0, p, 10, 64, p, 1, 1, None, 0, 0, p, 25600, 1, 64, 16, 1600,
            0),
        "ctypes call, 2 arguments": lambda: lib.noop2(packer.pack(*values),
                                                      0),
        "struct pack of 17 int64": lambda: packer.pack(*values),
    }
    for name, fn in steps.items():
        median, mean = per_call_us(fn, sync)
        log(f"host cost {name}: median {median!r} us, mean {mean!r} us "
            f"over {CALLS} calls ({card})")


if __name__ == "__main__":
    main()
