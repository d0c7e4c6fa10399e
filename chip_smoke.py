#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each of which exits non-zero when it fails:

1. the card's name and power limit, and the nvcc build of the kernels;
2. kernel B1 (the PCPM gather, ``repro_torch/csrc/pcpm_gather.cu``)
   against its plain PyTorch version on the card: the shapes of the JAX
   package's ``TestPCPMKernel``, random unsorted float32 and bfloat16
   streams, an all-pad partition;
3. the main path: ``open(g, EngineConfig(method=m), device="cuda")
   .pagerank()`` for pdpr, bvgas, pcpm and pcpm_pallas on the kron graph
   of ``configs/pagerank_kron.py`` (R-MAT a/b/c = 0.57/0.19/0.19, edge
   factor 31, partitions of 65536 nodes) with the scale cut from 25 to
   21, each result held against a float64 scipy power iteration; B1 must
   have launched once per pcpm_pallas iteration. Then B1 against its
   plain version at the main path's shapes (d = 1 and d = 16);
4. times with CUDA events after warm-up: ms per iteration and GB/s per
   engine, B1's time beside its byte bound, its plain version and a
   ``torch.sparse`` CSR matvec of A^T, which the port never calls.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# configs/pagerank_kron.py: scale 25, edge factor 31, part_size 65536;
# only the scale is cut (host preprocessing is numpy)
SCALE, FULL_SCALE, EDGE_FACTOR, PART_SIZE = 21, 25, 31, 65536
ITERATIONS, DAMPING = 20, 0.85
METHODS = ("pdpr", "bvgas", "pcpm", "pcpm_pallas")
# H100 SXM, NVIDIA data sheet: HBM3 bandwidth, float32 (non-tensor) rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
B1_SHAPES = [(6, 4, 16, 1), (7, 8, 32, 8), (8, 6, 64, 16), (7, 4, 128, 32)]
F32_TOL = dict(rtol=1e-5, atol=1e-6)   # atomics add in run-dependent order
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *, reps: int, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- phase 2
def check_b1(bins, eu, ed, part_size, label) -> float:
    """Launch B1 once, hold it against the plain version; max abs err."""
    import torch
    from repro_torch.kernels.pcpm_spmv import pcpm_gather_cuda, pcpm_gather_ref
    out = pcpm_gather_cuda(bins, eu, ed, part_size=part_size)
    torch.cuda.synchronize()
    ref = pcpm_gather_ref(bins, eu, ed, part_size=part_size)
    torch.cuda.synchronize()
    tol = F32_TOL if bins.dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), ref.float(), **tol,
                               msg=lambda m: f"B1 {label}: {m}")
    err = float((out.float() - ref.float()).abs().max())
    log(f"B1 {label}: bins {tuple(bins.shape)} {str(bins.dtype)[6:]}, "
        f"streams {tuple(eu.shape)}, P={part_size}: max_abs_err={err!r}")
    return err


def check_b1_test_shapes(dev) -> None:
    import torch
    from repro_torch.core import Partitioning, block_png, build_png
    from repro_torch.graphs import generators
    from repro_torch.kernels.pcpm_spmv import pack_blocked
    rng = np.random.default_rng(42)
    for scale, deg, part_size, d in B1_SHAPES:
        g = generators.rmat(scale, deg, seed=scale)
        packed = pack_blocked(block_png(build_png(
            g, Partitioning(g.num_nodes, part_size))), g.num_nodes,
            edge_block=128, device=dev)
        x = torch.from_numpy(rng.random((g.num_nodes, d)).astype(
            np.float32)).to(dev)
        k, u = packed.update_src.shape
        bins = x[packed.update_src.view(-1)].view(k, u, d)
        check_b1(bins, packed.edge_upd, packed.edge_dst, part_size,
                 f"rmat({scale},{deg}) part {part_size} d={d}")
    for dtype in (torch.float32, torch.bfloat16):
        k, U, d, P, Eb, neb = 4, 128, 128, 64, 128, 3
        bins = torch.from_numpy(rng.random((k, U, d))).to(dev, dtype)
        eu = torch.from_numpy(rng.integers(0, U + 1, (k, neb, Eb)).astype(
            np.int32)).to(dev)
        ed = torch.from_numpy(rng.integers(0, P + 1, (k, neb, Eb)).astype(
            np.int32)).to(dev)
        check_b1(bins, eu, ed, P, "random unsorted")
    k, U, d, P, Eb = 2, 128, 128, 8, 128
    bins = torch.rand((k, U, d), device=dev)
    eu = torch.full((k, 1, Eb), U, dtype=torch.int32, device=dev)
    ed = torch.full((k, 1, Eb), P, dtype=torch.int32, device=dev)
    check_b1(bins, eu, ed, P, "all-pad partition")
    from repro_torch.kernels.pcpm_spmv import pcpm_gather_cuda
    if torch.count_nonzero(pcpm_gather_cuda(bins, eu, ed, part_size=P)):
        fail("B1 all-pad partition: nonzero output")


# --------------------------------------------------------------- phase 3
def transpose_adjacency(g):
    """A^T as scipy CSR (row = destination), from the graph's edge list
    alone, so no fault of the port's plans reaches the oracle; repeated
    edges sum."""
    import scipy.sparse as sp
    n = g.num_nodes
    return sp.csr_matrix((np.ones(g.num_edges), (g.dst, g.src)),
                         shape=(n, n))


def oracle_pagerank(at, out_degree: np.ndarray) -> np.ndarray:
    """float64 power iteration with scipy.sparse (dangling mass dropped,
    as the port's default policy does)."""
    n = at.shape[0]
    inv = np.where(out_degree == 0, 0.0, 1.0 / np.maximum(out_degree, 1))
    pr = np.full(n, 1.0 / n)
    for _ in range(ITERATIONS):
        pr = (1.0 - DAMPING) / n + DAMPING * (at @ (pr * inv))
    return pr


def check_against_oracle(method, ranks, ids10, oracle) -> None:
    l1 = float(np.abs(ranks.astype(np.float64) - oracle).sum())
    top = np.lexsort((np.arange(len(oracle)), -oracle))
    top1000 = top[:1000]
    rel = float((np.abs(ranks[top1000] - oracle[top1000])
                 / oracle[top1000]).max())
    same10 = bool(np.array_equal(ids10, top[:10]))
    log(f"{method}: L1 vs float64 oracle {l1!r} (<= 1e-5), top-1000 max "
        f"rel err {rel!r} (<= 1e-4), top-10 ids equal: {same10}")
    if not (l1 <= 1e-5 and rel <= 1e-4 and same10):
        fail(f"{method} disagrees with the float64 oracle")


def model_bytes(method: str, sess) -> int:
    """Per-iteration bytes of the paper's models (§V eqs. 3-5) with this
    graph's n, m, k and r; d_i = d_v = 4 B; pdpr at its best case
    c_mr = d_v / l (each source value fetched once)."""
    n, m = sess.plan.num_nodes, sess.plan.num_edges
    if method == "pdpr":
        return 8 * m + 8 * n
    if method == "bvgas":
        return 16 * m + 12 * n
    return sess.plan.png.model_bytes()["total"]


def profile_iterations(sessions, card) -> None:
    """Device busy share and the top kernels of one 20-iteration solve
    per engine, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for method, sess in sessions.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.pagerank()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in events)
        if not busy_us:
            log(f"profile {method}: no device time in the trace (not "
                "measured)")
            continue
        log(f"profile {method}: device busy {busy_us:.0f} us of "
            f"{wall_us:.0f} us wall ({100 * busy_us / wall_us:.1f}%), "
            f"idle {100 * (1 - busy_us / wall_us):.1f}% ({card})")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"  {e.self_device_time_total / ITERATIONS:9.1f} us/iter "
                f"x{e.count // ITERATIONS:<3d} {e.key[:90]}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs on a "
             "CUDA card")
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(root / "src"))
    from repro_torch import EngineConfig, open as open_session
    from repro_torch.graphs import generators
    from repro_torch.kernels.pcpm_spmv import (kernel as b1, pack_blocked,
                                               pcpm_gather_cuda,
                                               pcpm_gather_ref)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)})")

    # ---------------------------------------------------- 1. build
    b1.load_library()
    log(f"build: nvcc for sm_90a took {b1.build_seconds:.2f} s")
    for line in b1.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---------------------------------------------------- 2. B1 checks
    check_b1_test_shapes(dev)

    # ---------------------------------------------------- 3. main path
    t0 = time.perf_counter()
    g = generators.rmat(SCALE, EDGE_FACTOR, seed=0)
    t_gen = time.perf_counter() - t0
    log(f"graph: rmat(scale={SCALE}, edge_factor={EDGE_FACTOR}, seed=0): "
        f"n={g.num_nodes} m={g.num_edges}, {t_gen:.1f} s; cut from the "
        f"configured scale {FULL_SCALE} to {SCALE} (part_size {PART_SIZE} "
        "and edge factor kept)")
    sessions, results, prep = {}, {}, {}
    b1.launch_count = 0                    # counts of the main path only
    for method in METHODS:
        t0 = time.perf_counter()
        sess = open_session(g, EngineConfig(method=method,
                                            part_size=PART_SIZE,
                                            num_iterations=ITERATIONS),
                            device="cuda")
        prep[method] = time.perf_counter() - t0
        res = sess.pagerank()
        torch.cuda.synchronize()
        sessions[method], results[method] = sess, res
    main_launches = b1.launch_count
    log(f"main path: B1 launches {main_launches}, pcpm_pallas iterations "
        f"{results['pcpm_pallas'].iterations}")
    if main_launches != results["pcpm_pallas"].iterations:
        fail("B1 launch count differs from the pcpm_pallas iterations")
    plan = sessions["pcpm_pallas"].plan
    log(f"layout: U={plan.png.num_updates} r={plan.png.compression_ratio:.3f}"
        f" k={plan.png.num_partitions} edge pad "
        f"{plan.blocked.edge_pad_frac:.4f} update pad "
        f"{plan.blocked.update_pad_frac:.4f}")
    for method in METHODS:
        log(f"host preprocessing {method}: {prep[method]:.1f} s")

    t0 = time.perf_counter()
    at = transpose_adjacency(g)
    oracle = oracle_pagerank(at, g.out_degree)
    log(f"oracle: float64 scipy power iteration, {time.perf_counter() - t0:.1f} s")
    for method in METHODS:
        res = results[method]
        ranks = res.ranks.cpu().numpy()
        if res.iterations != ITERATIONS or not np.isfinite(ranks).all():
            fail(f"{method}: {res.iterations} iterations, finite "
                 f"{np.isfinite(ranks).all()}")
        ids10, _ = sessions[method].top_ranked(10)
        check_against_oracle(method, ranks, ids10, oracle)

    before = b1.launch_count
    res = sessions["pcpm_pallas"].pagerank(tol=1e-7, check_every=5,
                                           num_iterations=200)
    log(f"pcpm_pallas tol=1e-7 check_every=5: {res.iterations} iterations, "
        f"last residual {res.residuals[-1]!r}, B1 launches "
        f"{b1.launch_count - before}")
    if b1.launch_count - before != res.iterations:
        fail("B1 launch count differs from the tol run's iterations")

    # B1 against its plain version at the main path's shapes
    packed = pack_blocked(plan.blocked, g.num_nodes, device=dev)
    k, u = packed.update_src.shape
    gen = torch.Generator(device=dev).manual_seed(0)
    main_bins = {}
    errs = []
    for d in (1, 16):
        # multiples of 1/16 below 1: the largest destination sum here
        # (in-degree ~2e5) stays exact in float32, so every summation
        # order gives the same bits and the comparison is exact; with
        # general floats two orders of 2e5-term sums differ by ~3e-5
        # relative, above the float32 tolerance
        x = torch.randint(0, 16, (g.num_nodes, d), generator=gen,
                          device=dev).float() / 16
        bins = x[packed.update_src.view(-1)].view(k, u, d)
        main_bins[d] = bins
        errs.append(check_b1(bins, packed.edge_upd, packed.edge_dst,
                             PART_SIZE, f"main path d={d}"))

    # ---------------------------------------------------- 4. times
    for method in METHODS:
        sess = sessions[method]
        ms = time_ms(sess.pagerank, reps=3, warmup=1) / ITERATIONS
        nbytes = model_bytes(method, sess)
        log(f"time {method}: {ms!r} ms/iteration, model {nbytes} B/iter -> "
            f"{nbytes / ms / 1e6:.1f} GB/s ({card})")

    profile_iterations(sessions, card)
    bins = main_bins[1]
    args = (bins, packed.edge_upd, packed.edge_dst)
    b1_ms = time_ms(lambda: pcpm_gather_cuda(*args, part_size=PART_SIZE),
                    reps=50, warmup=5)
    plain_ms = time_ms(lambda: pcpm_gather_ref(*args, part_size=PART_SIZE),
                       reps=10)
    # the bound counts the work this run's data needs, not the padded
    # layout: 8 B per real edge (both index streams), one float32 bins
    # value per real update, the (k, P) float32 output; one add per edge
    edges = int(((packed.edge_upd < u) & (packed.edge_dst < PART_SIZE)).sum())
    bytes_moved = (8 * edges + 4 * plan.png.num_updates
                   + 4 * k * PART_SIZE)
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = edges / PEAK_F32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    # library yardstick: one cuSPARSE CSR matvec of A^T (the whole SpMV),
    # built from the graph's edge list like the oracle
    at_dev = torch.sparse_csr_tensor(
        torch.from_numpy(at.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(at.indices.astype(np.int64)).to(dev),
        torch.from_numpy(at.data.astype(np.float32)).to(dev),
        size=(g.num_nodes, g.num_nodes))
    xv = torch.rand((g.num_nodes, 1), generator=gen, device=dev)
    library_ms = time_ms(lambda: at_dev @ xv, reps=20)
    spmv_ms = time_ms(lambda: sessions["pcpm_pallas"].engine(xv[:, 0]),
                      reps=20)
    log(f"B1 at the main path (d=1): {b1_ms!r} ms; bound {bound_ms!r} ms "
        f"({bytes_moved} B for {edges} edges and {plan.png.num_updates} "
        f"updates at {PEAK_BYTES_PER_S / 1e12} TB/s); plain "
        f"version {plain_ms!r} ms; torch.sparse CSR matvec of A^T "
        f"{library_ms!r} ms; whole pcpm_pallas SpMV {spmv_ms!r} ms ({card})")
    torch.cuda.synchronize()

    kernels = [{
        "name": "pcpm_gather",
        "route": "cuda",
        "source": "src/repro_torch/csrc/pcpm_gather.cu",
        "replaces": "src/repro/kernels/pcpm_spmv/kernel.py:96",
        "launches": main_launches,
        "max_abs_err": max(errs),
        "ms": b1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
