#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each of which exits non-zero when it fails:

1. the card's name and power limit, and the nvcc build of the kernels;
2. kernel B1 (the PCPM gather, ``repro_torch/csrc/pcpm_gather.cu``)
   against its plain PyTorch version on the card, each call through the
   path ``b1_path`` names ("warp" for the blocked streams alone or d > 1,
   "tile" for d = 1 with the plan's gather order): the shapes of the JAX
   package's ``TestPCPMKernel`` through "warp" from bins and in its fused
   form (rows of x read through ``update_src``, float32 and bfloat16),
   random unsorted float32 and bfloat16 streams, an all-pad partition
   through both forms of "warp"; the same rmat layouts at d = 1 through
   "tile" (inputs that are multiples of 1/16, so the output must equal
   the plain version's bit for bit);
3. the main path: ``open(g, EngineConfig(method=m), device="cuda")
   .pagerank()`` for pdpr, bvgas, pcpm and pcpm_pallas on the kron graph
   of ``configs/pagerank_kron.py`` (R-MAT a/b/c = 0.57/0.19/0.19, edge
   factor 31, partitions of 65536 nodes) with the scale cut from 25 to
   21, each result held against a float64 scipy power iteration; B1 must
   have launched once per pcpm_pallas iteration, through "tile". Then the
   host time and device bytes of the gather order, and B1 against its
   plain version at the main path's shape (d = 1 through "tile", exact)
   and at the serving stepper's (d = 16 through "warp", from bins and in
   the fused form, exact);
4. times with CUDA events after warm-up: ms per iteration and GB/s per
   engine (bytes of the paper's models, ``core/comm_model.py``), B1's
   time beside its byte bound, its plain version and a ``torch.sparse``
   CSR product with A^T, which the port never calls, at d = 1 ("tile")
   and at d = 16 ("warp" from bins); B1 "warp" at d = 16 in the fused
   form that the serving stepper calls (``pcpm_spmv_cuda``: the kernels
   line's "warp" entry) beside its bound (x and ``update_src`` read
   once), its plain version and the same ``torch.sparse`` product; the
   stepper's whole SpMV (``pcpm_spmv_pallas``) and its peak memory, which
   must stay below half of the bins it no longer makes;
5. the PageRank serving path on the same graph and pcpm_pallas plan:
   ``Session.serve(slots=16, chunk=8)`` drains 64 queries in the mix of
   the JAX package's scheduler test (uniform at 20 iterations; one seed,
   top 10, tol 1e-3, routed to the forward push, on the card; four
   seeds, tol 1e-6; uniform top 10), every query ending exactly once;
   B1 "warp" launched once per chunk iteration and "tile" once per push
   sweep and seeding; uniform results against phase 3's oracle, seeded
   ones against a float64 personalized power iteration on the card (a
   ``torch.sparse`` product over the edge list) at their own iteration
   counts, push results within tol·d/(1−d) of the fixed point. Then
   ``Session.server`` at batch 16 ("warp") and batch 1 ("tile"), and
   times: queries/s over the drain, ms per chunk with 16 active slots,
   ms per ``PageRankServer.query``, and a profile of chunks with B1's
   device time;
6. streaming edge deltas on the same graph and pcpm_pallas session: a
   cold prior at tol 1e-6; two localized deltas (D1: 32,768 insertions
   and 32,768 removals in the two partitions whose edge counts are
   nearest the median, D2: 8,192 + 8,192 in the third) through
   ``Session.apply_delta``, which must patch the plan twice (no rebuild);
   ``pagerank(warm=True)``: B1 "tile" once per push sweep and no "warp",
   fewer sweeps than the prior, L1 to a float64 fixed point of the new
   graph within 75.6·tol and the same top-10 ids; a cold solve on the
   patched plan beside it; the patched plan against a fresh
   ``build_png`` + ``block_png`` (every array) and its "tile" gather
   order against a fresh one, B1 "tile" on it exact against its plain
   version; ``SlotScheduler.apply_delta`` under 16 queries in phase 5's
   mix (every query once, ``rebind_count`` 1, B1 "warp" once per chunk
   iteration on the new plan, answers within tol·d/(1−d) of the new
   graph's float64 fixed points, push answers of the old one's); four
   more deltas with warm updates, the device memory ending no more than
   one plan's uploads above its start. Times: the parts of
   ``apply_delta``, ``seed_residual``, the push, the cold solve, the
   fresh build and the scheduler's rebind;
7. kernel B3 (flash attention, ``repro_torch/csrc/flash_attention.cu``)
   against its plain version on the same inputs upcast to float32, on
   the card, each call through the path ``b3_path`` names ("tc" for
   bfloat16 with Sq > 1, "split" for Sq = 1, "simt" for float32): the
   shapes of the JAX package's ``TestFlashAttention`` (float32 within
   2e-3, windows 64/128/200, unpadded S = 200; in bfloat16 too), the LM
   slice's decode shape (B 8, Hq 32, Hkv 4, Sq 1, 1024 cache slots,
   mixed per-slot lengths) and its prefill shape (4, 2048, causal);
   bfloat16 outputs within rtol 1.6e-2, atol 2e-3 (their rounding; inside
   TestFlashAttention's 5e-2);
8. the LM serving path: TinyLlama-1.1B at its configured widths
   (``configs/tinyllama_1_1b.py``: 22 layers, d_model 2048, 32/4 heads,
   d_ff 5632, vocab 32000), random bfloat16 weights from a seeded
   generator; a ``ServeEngine`` with 8 slots and max_len 1024 drains 16
   requests (prompts of 32-512 tokens, 64 new tokens each) with B3
   launched once per layer per decode step; then ``prefill`` at
   (4, 2048), and ``decode_step`` over 256 tokens against ``forward`` on
   the same tokens;
9. times with CUDA events: ms per decode step and tokens/s, prefill ms,
   B3 beside its bound, its plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick the
   port never calls); the device idle share and top kernels of profiled
   decode steps and prefills, with B3's share of each;
10. kernel B2 (the embedding bag, ``repro_torch/csrc/embedding_bag.cu``)
   against its plain version on the card: the shapes of the JAX
   package's ``TestEmbeddingBag`` with weights (rtol 1e-4, atol 1e-5),
   in float32 and with a bfloat16 table, pad ids and a negative id (row
   0); then MIND's lookups (one-id bags) on its 10M-row table at the
   shapes of phase 11, which must give the plain version's rows exactly;
11. the MIND serving path: ``configs/mind.py`` as it stands (vocab 10M,
   embed_dim 64, 4 interests, 3 routing iterations, hist_len 50),
   float32 parameters from a seeded generator; ``serve_step`` at
   serve_p99 (B 512) and serve_bulk (B 262,144), ``retrieval_step`` for
   one user over 1,000,000 distinct candidates (top 64), on histories of
   Zipf-distributed ids with lengths uniform in 1-50 and pads of V;
   B2 launched once per ``serve_step`` and twice per ``retrieval_step``;
   the capsules held against the port's CPU path, against a pad of
   V + 7, and retrieval against a float64 rescoring. Then times with CUDA
   events: ms per ``serve_step`` (users/s) and per ``retrieval_step``,
   the device idle share of profiled serve_p99 steps with B2's device
   time, and B2 at both serve shapes beside its bound, its plain version
   and ``torch.nn.functional.embedding_bag`` (a yardstick the port never
   calls); at serve_p99, where a call's time is its host cost, B2 and
   ``F.embedding_bag`` are timed in alternating rounds and compared by
   their medians.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the kron cell: the port's configs/pagerank_kron.py (``kron()``) with
# its scale cut from 25 to SCALE, because host preprocessing is numpy
SCALE = 21
METHODS = ("pdpr", "bvgas", "pcpm", "pcpm_pallas")
# H100 SXM, NVIDIA data sheet: HBM3 bandwidth, float32 (non-tensor) rate,
# bfloat16 dense tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
B1_ENTRY = {"name": "pcpm_gather", "route": "cuda",
            "source": "src/repro_torch/csrc/pcpm_gather.cu",
            "replaces": "src/repro/kernels/pcpm_spmv/kernel.py:96"}
B1_SHAPES = [(6, 4, 16, 1), (7, 8, 32, 8), (8, 6, 64, 16), (7, 4, 128, 32)]
F32_TOL = dict(rtol=1e-5, atol=1e-6)   # atomics add in run-dependent order
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# kernel B3 and the LM serving slice: configs/tinyllama_1_1b.py at its
# widths; B3 within TestFlashAttention's float32 tolerance (sums in
# another order)
ARCH, LM_HEADS, LM_KV_HEADS, LM_DH = "tinyllama-1.1b", 32, 4, 64
SLOTS, MAX_LEN, N_REQUESTS, NEW_TOKENS = 8, 1024, 16, 64
PROMPT_LENS = (32, 512)
PREFILL_SHAPE = (4, 2048)
CONSISTENCY_LEN = 256
# decode_step vs forward, bfloat16 weights, activations and cache: the
# max logit gap measured on the H100 was 0.0898 on logits up to 5.03;
# a greedy token can flip only where the top-2 margin is below twice it
DECODE_TOL = 0.2
PROFILE_STEPS = 16
# B2 against F.embedding_bag at serve_p99: alternating rounds of calls
B2_ROUNDS, B2_ROUND_CALLS = 5, 50
B3_F32_TOL = dict(rtol=2e-3, atol=2e-3)
# B3's kernels as the profiler names them (csrc/flash_attention.cu)
B3_KERNELS = ("tc_fwd_kernel", "split_partial_kernel", "split_combine_kernel",
              "flash_fwd_kernel")
# a bfloat16 output against the plain version on the same inputs upcast to
# float32: the kernel sums in float32, so what is left is the output's
# rounding (half an ulp, 2**-9 relative); TestFlashAttention's 5e-2 would
# be as large as a typical |o| at the LM's lengths (~sqrt(e / n))
B3_BF16_TOL = dict(rtol=1.6e-2, atol=2e-3)
# kernel B2 and the MIND serving slice: configs/mind.py as it stands;
# B2 at TestEmbeddingBag's shapes and tolerance (float32 sums in another
# order); a bfloat16 output may differ from the plain version's by one
# bfloat16 step (2**-7 relative) where the two float32 sums round apart
MIND_ARCH = "mind"
B2_TEST_SHAPES = [(512, 128, 8, 4), (1024, 64, 32, 16), (2048, 128, 64, 8)]
B2_TOL = dict(rtol=1e-4, atol=1e-5)
B2_BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
# item popularity: a Zipf law over ranks, each rank folded into [0, V) by
# Fibonacci hashing (a fixed odd 64-bit multiplier), so hot items repeat
# and are spread over the table
ZIPF_A = 1.2
ID_HASH = 0x9E3779B97F4A7C15
TOP_K = 64
# capsules on the card against the port's CPU path on the same
# parameters, float32 without TF32: cuBLAS and the CPU sum the (50, 64)
# products in other orders
MIND_TOL = dict(rtol=1e-4, atol=1e-5)
# retrieval scores (|s| < ~1, 64-term float32 dots) against a float64
# rescoring: ids are compared where neighbouring scores differ by more
SCORE_TOL = 1e-5


def kron():
    """The paper's workload as the port configures it (scale 25, edge
    factor 31, partitions of 65536 nodes, 20 iterations, damping 0.85),
    read once ``src`` is on the path."""
    from repro_torch.configs.pagerank_kron import CONFIG
    return CONFIG


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


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name without its source's anonymous namespace:
    ``warp::gather_kernel IfLi4ELi4E`` (namespace warp; float, 4 values
    a lane, 4 lanes an edge), ``cast_to_bf16_kernel``."""
    found = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)
    rest = mangled[found.end(1) + int(found.group(1)):] if found else mangled
    parts = []
    while found := re.match(r"\d+", rest):
        size = int(found.group(0))
        parts.append(rest[found.end():found.end() + size])
        rest = rest[found.end() + size:]
    args = re.match(r"I.*?E(?=E)", rest)
    return "::".join(parts) + (f" {args.group(0)}" if args else "")


def ptxas_report(build_log: str) -> list[tuple[str, str]]:
    """(kernel, "registers; spills") for each kernel ``nvcc -Xptxas -v``
    compiled (``kernel_name``)."""
    out, name, spills = [], "", ""
    for line in build_log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = kernel_name(found.group(1))
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((name, f"{regs} registers; {spills}"))
    return out


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
def check_b1(bins, eu, ed, part_size, label, schedule=None,
             exact=False, update_src=None) -> float:
    """Launch B1 once through the path ``b1_path`` names (failing if
    another ran), hold it against the plain version (bit for bit when
    ``exact``); max abs err. With ``update_src``, ``bins`` is x (n, d) and
    the call is the "warp" path's fused form (``pcpm_spmv_cuda``)."""
    import torch
    from repro_torch.kernels.pcpm_spmv import (b1_path, kernel,
                                               pcpm_gather_cuda,
                                               pcpm_gather_ref,
                                               pcpm_spmv_cuda, pcpm_spmv_ref)
    fused = update_src is not None
    path = b1_path(bins.shape[-1], schedule is not None and not fused)
    before = dict(kernel.launch_counts)
    if fused:
        out = pcpm_spmv_cuda(bins, update_src, eu, ed, part_size=part_size)
    else:
        out = pcpm_gather_cuda(bins, eu, ed, part_size=part_size,
                               schedule=schedule)
    torch.cuda.synchronize()
    ran = [p for p in kernel.PATHS if kernel.launch_counts[p] != before[p]]
    if ran != [path]:
        fail(f"B1 {label}: expected path {path!r}, launched {ran}")
    ref = (pcpm_spmv_ref(bins, update_src, eu, ed, part_size=part_size)
           if fused else pcpm_gather_ref(bins, eu, ed, part_size=part_size))
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    what = (f"x {tuple(bins.shape)} through update_src "
            f"{tuple(update_src.shape)}" if fused else
            f"bins {tuple(bins.shape)}")
    log(f"B1 {label} via {path!r}{' (fused)' if fused else ''}: {what} "
        f"{str(bins.dtype)[6:]}, streams {tuple(eu.shape)}, P={part_size}: "
        f"max_abs_err={err!r}" + (f", exact {torch.equal(out, ref)}"
                                  if exact else ""))
    if exact and not torch.equal(out, ref):
        fail(f"B1 {label}: not the plain version's output bit for bit")
    tol = F32_TOL if bins.dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), ref.float(), **tol,
                               msg=lambda m: f"B1 {label}: {m}")
    return err


def check_b1_test_shapes(dev) -> None:
    import torch
    from repro_torch.core import Partitioning, block_png, build_png
    from repro_torch.graphs import generators
    from repro_torch.kernels.pcpm_spmv import pack_blocked, tile_schedule
    rng = np.random.default_rng(42)
    for scale, deg, part_size, d in B1_SHAPES:
        g = generators.rmat(scale, deg, seed=scale)
        blocked = block_png(build_png(g, Partitioning(g.num_nodes,
                                                      part_size)))
        packed = pack_blocked(blocked, g.num_nodes, edge_block=128,
                              device=dev)
        x = torch.from_numpy(rng.random((g.num_nodes, d)).astype(
            np.float32)).to(dev)
        k, u = packed.update_src.shape
        bins = x[packed.update_src.view(-1)].view(k, u, d)
        check_b1(bins, packed.edge_upd, packed.edge_dst, part_size,
                 f"rmat({scale},{deg}) part {part_size} d={d}")
        for xd in (x, x.bfloat16()):
            check_b1(xd, packed.edge_upd, packed.edge_dst, part_size,
                     f"rmat({scale},{deg}) part {part_size} d={d}",
                     update_src=packed.update_src)
        # "tile" at d = 1: one tile per partition, and tiles of 16 nodes
        x16 = torch.from_numpy(rng.integers(0, 16, (g.num_nodes, 1)).astype(
            np.float32) / 16).to(dev)
        bins = x16[packed.update_src.view(-1)].view(k, u, 1)
        for tile_bytes in (None, 64):
            schedule = tile_schedule(blocked, device=dev, **(
                {} if tile_bytes is None else {"tile_bytes": tile_bytes}))
            for b in (bins, bins.bfloat16()):
                check_b1(b, packed.edge_upd, packed.edge_dst, part_size,
                         f"rmat({scale},{deg}) part {part_size} d=1 tile "
                         f"{schedule.tile}", schedule=schedule, exact=True)
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
    from repro_torch.kernels.pcpm_spmv import pcpm_gather_cuda, pcpm_spmv_cuda
    if torch.count_nonzero(pcpm_gather_cuda(bins, eu, ed, part_size=P)):
        fail("B1 all-pad partition: nonzero output")
    x = bins.view(-1, d)
    usrc = torch.arange(k * U, dtype=torch.int32, device=dev).view(k, U)
    check_b1(x, eu, ed, P, "all-pad partition", update_src=usrc)
    if torch.count_nonzero(pcpm_spmv_cuda(x, usrc, eu, ed, part_size=P)):
        fail("B1 all-pad partition (fused): nonzero output")


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
    n, cfg = at.shape[0], kron()
    inv = np.where(out_degree == 0, 0.0, 1.0 / np.maximum(out_degree, 1))
    pr = np.full(n, 1.0 / n)
    for _ in range(cfg.num_iterations):
        pr = (1.0 - cfg.damping) / n + cfg.damping * (at @ (pr * inv))
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
    """Per-iteration bytes of the paper's models (§V eqs. 3-5, the port's
    ``core/comm_model.py``) with this graph's n, m, k and r; d_i = d_v =
    4 B; pdpr at its best case c_mr = d_v / l (each source value fetched
    once)."""
    from repro_torch.core import comm_model
    plan = sess.plan
    r = plan.png.compression_ratio if plan.png is not None else 1.0
    params = comm_model.ModelParams(plan.num_nodes, plan.num_edges,
                                    plan.partitioning.num_partitions, r,
                                    c_mr=4 / 64)
    model = {"pdpr": comm_model.pdpr_bytes,
             "bvgas": comm_model.bvgas_bytes}.get(method,
                                                  comm_model.pcpm_bytes)
    return round(model(params))


def profile_iterations(sessions, card) -> None:
    """Device busy share and the top kernels of one 20-iteration solve
    per engine, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    iterations = kron().num_iterations
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
            log(f"  {e.self_device_time_total / iterations:9.1f} us/iter "
                f"x{e.count // iterations:<3d} {e.key[:90]}")


def pagerank_phases(dev, card):
    """Phases 3 and 4: the PageRank main path and its times. Returns B1's
    entry of the kernels line at the main path's shape ("tile", d = 1),
    B1's check and times at the serving stepper's shape ("warp",
    d = 16), and what phase 5 reuses: the graph, the pcpm_pallas
    session, the float64 oracle and A^T on the card."""
    import torch
    from repro_torch import EngineConfig, open as open_session
    from repro_torch.graphs import generators
    from repro_torch.kernels.pcpm_spmv import (kernel as b1, pack_blocked,
                                               pcpm_gather_cuda,
                                               pcpm_gather_ref,
                                               pcpm_spmv_cuda,
                                               pcpm_spmv_pallas,
                                               pcpm_spmv_ref,
                                               tile_schedule)
    # ---------------------------------------------------- 3. main path
    cfg = kron()
    edge_factor, part_size = cfg.edge_factor, cfg.part_size
    iterations = cfg.num_iterations
    t0 = time.perf_counter()
    g = generators.rmat(SCALE, edge_factor, seed=0)
    t_gen = time.perf_counter() - t0
    log(f"graph: rmat(scale={SCALE}, edge_factor={edge_factor}, seed=0): "
        f"n={g.num_nodes} m={g.num_edges}, {t_gen:.1f} s; cut from the "
        f"configured scale {cfg.scale} to {SCALE} (part_size {part_size} "
        "and edge factor kept)")
    sessions, results, prep = {}, {}, {}
    b1.launch_count = 0                    # counts of the main path only
    b1.launch_counts = dict.fromkeys(b1.PATHS, 0)
    for method in METHODS:
        t0 = time.perf_counter()
        sess = open_session(g, EngineConfig(method=method,
                                            part_size=part_size,
                                            num_iterations=iterations),
                            device="cuda")
        prep[method] = time.perf_counter() - t0
        res = sess.pagerank()
        torch.cuda.synchronize()
        sessions[method], results[method] = sess, res
    main_launches = b1.launch_count
    main_by_path = dict(b1.launch_counts)
    log(f"main path: B1 launches {main_launches} (by path {main_by_path}), "
        f"pcpm_pallas iterations {results['pcpm_pallas'].iterations}")
    if main_launches != results["pcpm_pallas"].iterations:
        fail("B1 launch count differs from the pcpm_pallas iterations")
    if main_by_path["tile"] != main_launches:
        fail("the main path's B1 launches did not all take path 'tile'")
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
        if res.iterations != iterations or not np.isfinite(ranks).all():
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

    # the gather order of the "tile" path, built again to time it (the
    # engine built its own at its first solve)
    t0 = time.perf_counter()
    schedule = tile_schedule(plan.blocked, device=dev)
    torch.cuda.synchronize()
    t_sched = time.perf_counter() - t0
    packed = pack_blocked(plan.blocked, g.num_nodes, device=dev)
    packed_bytes = sum(t.numel() * t.element_size() for t in (
        packed.update_src, packed.update_valid, packed.edge_upd,
        packed.edge_dst))
    log(f"host preprocessing pcpm_pallas gather order (tile_schedule): "
        f"{t_sched:.1f} s; tile {schedule.tile} destinations, "
        f"{schedule.chunks.shape[0]} chunks over {schedule.blocks} blocks; "
        f"device bytes kept by the engine: packed streams {packed_bytes} + "
        f"gather order {schedule.nbytes} = "
        f"{packed_bytes + schedule.nbytes}")

    # B1 against its plain version at the main path's shape (d = 1) and
    # at the serving stepper's (d = 16: phase 5's 16 slots)
    k, u = packed.update_src.shape
    gen = torch.Generator(device=dev).manual_seed(0)
    main_bins = {}
    errs = {}
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
        errs[d] = check_b1(bins, packed.edge_upd, packed.edge_dst, part_size,
                           "main path d=1" if d == 1 else
                           "serving path d=16", schedule=schedule,
                           exact=True)
    # the serving path's own form at d = 16: x read through update_src
    x16 = torch.randint(0, 16, (g.num_nodes, 16), generator=gen,
                        device=dev).float() / 16
    errs["fused"] = check_b1(x16, packed.edge_upd, packed.edge_dst,
                             part_size, "serving path d=16", exact=True,
                             update_src=packed.update_src)

    # ---------------------------------------------------- 4. times
    for method in METHODS:
        sess = sessions[method]
        ms = time_ms(sess.pagerank, reps=3, warmup=1) / iterations
        nbytes = model_bytes(method, sess)
        log(f"time {method}: {ms!r} ms/iteration, model {nbytes} B/iter -> "
            f"{nbytes / ms / 1e6:.1f} GB/s ({card})")

    profile_iterations(sessions, card)
    # library yardstick: one cuSPARSE CSR product with A^T (the whole
    # SpMV), built from the graph's edge list like the oracle
    at_dev = torch.sparse_csr_tensor(
        torch.from_numpy(at.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(at.indices.astype(np.int64)).to(dev),
        torch.from_numpy(at.data.astype(np.float32)).to(dev),
        size=(g.num_nodes, g.num_nodes))
    # the bound counts the work this run's data needs, not the padded
    # layout: 8 B per real edge (both index streams), the function's row
    # input read once, the (k, P, d) float32 output; d adds per edge
    edges = int(((packed.edge_upd < u) & (packed.edge_dst < part_size)).sum())
    num_updates = plan.png.num_updates

    def bound(d, row_bytes):
        bytes_moved = 8 * edges + row_bytes + 4 * d * k * part_size
        bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
        ops_ms = d * edges / PEAK_F32_PER_S * 1e3
        return bytes_moved, max(bytes_ms, ops_ms), (
            "bytes" if bytes_ms >= ops_ms else "operations")

    # B1 from bins, the gather's own input: d float32 values per real
    # update; at d = 1 the main path's "tile", at d = 16 "warp" (the
    # serving path does not call this form)
    timed = {}
    for d, path_schedule in ((1, schedule), (16, None)):
        args = (main_bins[d], packed.edge_upd, packed.edge_dst)
        ms = time_ms(lambda: pcpm_gather_cuda(
            *args, part_size=part_size, schedule=path_schedule),
            reps=50 if d == 1 else 20, warmup=5)
        plain_ms = time_ms(lambda: pcpm_gather_ref(*args,
                                                   part_size=part_size),
                           reps=10 if d == 1 else 3)
        bytes_moved, bound_ms, bound_by = bound(d, 4 * d * num_updates)
        xv = torch.rand((g.num_nodes, d), generator=gen, device=dev)
        library_ms = time_ms(lambda: at_dev @ xv, reps=20 if d == 1 else 5)
        path = "tile" if path_schedule is not None else "warp"
        timed[d] = {"path": path, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms, "max_abs_err": errs[d]}
        where = "on the main path" if d == 1 else "at the serving width"
        log(f"B1 from bins {where} (d={d}, path {path!r}): {ms!r} ms; "
            f"bound {bound_ms!r} ms "
            f"({bytes_moved} B for {edges} edges and {num_updates} updates "
            f"at {PEAK_BYTES_PER_S / 1e12} TB/s); plain version {plain_ms!r} "
            f"ms; torch.sparse CSR product with A^T (n, {d}) "
            f"{library_ms!r} ms ({card})")
    # B1 "warp" as the serving stepper calls it at d = 16: the fused form
    # (x read through update_src, no bins). Its bound reads the function's
    # own inputs once: one update_src entry per real update and x (n, 16);
    # the PCPM layout re-reads a row of x once per partition that it
    # feeds, which is printed beside the bound and not counted in it
    fused_args = (x16, packed.update_src, packed.edge_upd, packed.edge_dst)
    ms = time_ms(lambda: pcpm_spmv_cuda(*fused_args, part_size=part_size),
                 reps=20, warmup=5)
    plain_ms = time_ms(lambda: pcpm_spmv_ref(*fused_args,
                                             part_size=part_size), reps=3)
    bytes_moved, bound_ms, bound_by = bound(
        16, 4 * num_updates + 4 * 16 * g.num_nodes)
    layout_bytes = bound(16, 4 * num_updates + 4 * 16 * num_updates)[0]
    library_ms = time_ms(lambda: at_dev @ x16, reps=5)
    # the whole SpMV as the stepper calls it (pcpm_spmv_pallas: the fused
    # form plus its view); its peak memory must stay well below the
    # (k, U, 16) bins that it no longer makes
    spmv16 = lambda: pcpm_spmv_pallas(packed, x16)          # noqa: E731
    spmv_ms = time_ms(spmv16, reps=20, warmup=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    spmv16()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    bins_bytes = k * u * 16 * 4
    from_bins = timed[16]
    timed[16] = {"path": "warp", "form": "fused", "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms,
                 "max_abs_err": max(errs[16], errs["fused"]),
                 "from_bins_ms": from_bins["ms"],
                 "from_bins_bound_ms": from_bins["bound_ms"],
                 "spmv_ms": spmv_ms, "spmv_bound_ms": bound_ms,
                 "spmv_peak_bytes": peak}
    log(f"B1 'warp' fused at the serving path (d=16, x read through "
        f"update_src; pcpm_spmv_cuda): {ms!r} ms; bound {bound_ms!r} ms "
        f"({bytes_moved} B: x and update_src read once); the layout's "
        f"traffic with one row read per update {layout_bytes} B = "
        f"{layout_bytes / PEAK_BYTES_PER_S * 1e3!r} ms; plain version "
        f"{plain_ms!r} ms; torch.sparse CSR product with A^T (n, 16) "
        f"{library_ms!r} ms; kernel from bins {from_bins['ms']!r} ms; "
        f"pcpm_spmv_pallas {spmv_ms!r} ms, peak memory of one call {peak} "
        f"B (bins would be {bins_bytes} B) ({card})")
    if peak >= bins_bytes // 2:
        fail("the fused SpMV's peak memory is that of a bins tensor")
    xv = torch.rand((g.num_nodes,), generator=gen, device=dev)
    spmv_ms = time_ms(lambda: sessions["pcpm_pallas"].engine(xv), reps=20)
    log(f"whole pcpm_pallas SpMV (d=1): {spmv_ms!r} ms ({card})")
    torch.cuda.synchronize()

    entry = {**B1_ENTRY, "launches": main_launches,
             "launches_by_path": main_by_path, **timed[1]}
    reuse = {"g": g, "sess": sessions["pcpm_pallas"], "oracle": oracle,
             "at_dev": at_dev}
    return entry, timed[16], reuse


# --------------------------------------------------------------- phase 5
SERVE_SLOTS, SERVE_CHUNK, SERVE_QUERIES = 16, 8, 64
PUSH_TOL = 1e-3
FIXED_POINT_ITERATIONS = 150          # 0.85**150 * 2 < 1e-10


def personalized_oracle(at64, inv64, cols, counts, damping):
    """float64 personalized power iteration on the card: ``at64`` is A^T
    as a torch.sparse CSR built from the graph's edge list (independent
    of the port's plans), ``cols`` the seed sets; column j is taken after
    ``counts[j]`` iterations. A yardstick: nothing on the served path
    calls it."""
    import torch
    n = at64.shape[0]
    v = torch.zeros((n, len(cols)), dtype=torch.float64, device=at64.device)
    for j, ids in enumerate(cols):
        v[torch.as_tensor(ids, device=at64.device).long(), j] = 1.0
    v /= v.sum(0, keepdim=True)
    x, out = v.clone(), torch.empty_like(v)
    counts = np.asarray(counts)
    for it in range(int(counts.max()) + 1):
        if it:
            x = (1.0 - damping) * v + damping * (at64 @ (x * inv64[:, None]))
        for j in np.nonzero(counts == it)[0]:
            out[:, j] = x[:, j]
    return out


def serving_phase(dev, card, reuse, warp_timed) -> dict:
    """Phase 5: PageRank query serving on phase 3's kron graph and
    pcpm_pallas plan. A ``SlotScheduler`` (16 slots, chunks of 8) drains
    64 queries in the reference test's mix; ``PageRankServer`` answers 16
    seeds at batch 16 and one at batch 1; then times and a profile of
    chunks. Returns B1's entry of the kernels line at the serving
    stepper's shape ("warp", d = 16)."""
    import torch
    from repro_torch.kernels.pcpm_spmv import kernel as b1
    from repro_torch.serve import PushQueryEngine
    from repro_torch.serve import scheduler as sched_mod
    from repro_torch.serve.topk import host_topk
    g, sess, oracle, at_dev = (reuse[k] for k in ("g", "sess", "oracle",
                                                  "at_dev"))
    n, damping = g.num_nodes, kron().damping
    t_phase = time.perf_counter()

    def reset_counts():
        b1.launch_count = 0
        b1.launch_counts = dict.fromkeys(b1.PATHS, 0)

    def seed_vector(ids):
        s = np.zeros(n, np.float32)
        s[ids] = 1.0
        return s

    # ------------------------------------------- the scheduler's drain
    # the entry point as a user calls it: its push (``push_mode="auto"``)
    # runs on the card, B1 "tile" once per sweep
    sch = sess.serve(slots=SERVE_SLOTS, chunk=SERVE_CHUNK)
    rng = np.random.default_rng(3)
    work = []                                  # (kind, seed ids, kwargs)
    for i in range(SERVE_QUERIES):
        kind = i % 4
        if kind == 0:                          # uniform, fixed iterations
            work.append((kind, None, dict(tol=0.0, max_iters=20)))
        elif kind == 1:                        # one seed, top-k: push
            work.append((kind, [int(rng.integers(0, n))],
                         dict(top_k=10, tol=PUSH_TOL)))
        elif kind == 2:                        # four seeds, tight tol
            work.append((kind, rng.integers(0, n, size=4).tolist(),
                         dict(tol=1e-6, max_iters=200)))
        else:                                  # uniform top-k
            work.append((kind, None, dict(top_k=10, tol=0.0,
                                          max_iters=20)))
    chunk_iters = []
    read_chunk = sched_mod._read_chunk

    def counted_read(*args):
        out = read_chunk(*args)
        chunk_iters.append(int(out[1].max()))
        return out

    sched_mod._read_chunk = counted_read
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        uids = [sch.submit(None if ids is None else seed_vector(ids), **kw)
                for _, ids, kw in work]
        submit_s = time.perf_counter() - t0    # the pushes run inline
        sch.run_until_drained()
        torch.cuda.synchronize()
    finally:
        sched_mod._read_chunk = read_chunk
    drain_s = time.perf_counter() - t0
    drain_counts = dict(b1.launch_counts)
    done = {r.uid: r for r in sch.completed}
    summary = sch.metrics.summary()
    log(f"serving drain: {SERVE_QUERIES} queries, {len(chunk_iters)} "
        f"chunks ({sum(chunk_iters)} iterations), {drain_s:.3f} s "
        f"({submit_s:.3f} s of submits with the 16 pushes inline, "
        f"{drain_s - submit_s:.3f} s of stepper chunks), "
        f"{SERVE_QUERIES / drain_s!r} queries/s; p50 "
        f"{summary['p50_ms']!r} ms, p99 {summary['p99_ms']!r} ms; "
        f"counters {dict(sch.metrics.counters)}; B1 launches by path "
        f"{drain_counts} ({card})")
    if (sorted(done) != sorted(uids) or len(sch.completed) != len(uids)
            or any(r.error for r in sch.completed)):
        fail("serving drain: not every query ended exactly once, error-free")
    sch.metrics.reconcile()
    routes = [sch.metrics.traces[u].route for u in uids]
    fallbacks = sch.metrics.counters["push_fallbacks"]
    push_sweeps = sum(done[u].iterations + 1 for (kind, _, _), u, route
                      in zip(work, uids, routes) if route == "push")
    want_tile = push_sweeps + fallbacks * (sch.push_max_sweeps + 1)
    log(f"serving drain: routes {sum(r == 'push' for r in routes)} push, "
        f"{sum(r is None for r in routes)} stepper; B1 'warp' "
        f"{drain_counts['warp']} (= the chunks' iterations "
        f"{sum(chunk_iters)}: {drain_counts['warp'] == sum(chunk_iters)}), "
        f"'tile' {drain_counts['tile']} (= push sweeps + seedings "
        f"{want_tile}: {drain_counts['tile'] == want_tile})")
    if drain_counts["warp"] != sum(chunk_iters) or not chunk_iters:
        fail("serving drain: B1 'warp' launches differ from the chunks' "
             "iterations")
    if drain_counts["tile"] != want_tile:
        fail("serving drain: B1 'tile' launches differ from the push sweeps")
    if [r == "push" for r in routes] != [k == 1 for k, _, _ in work]:
        fail("serving drain: the single-seed top-k queries were not all "
             "routed to push, or others were")

    # the yardsticks: A^T in float64 on the card, from the edge list
    at64 = torch.sparse_csr_tensor(at_dev.crow_indices(),
                                   at_dev.col_indices(),
                                   at_dev.values().double(),
                                   size=at_dev.shape)
    deg = np.asarray(g.out_degree)
    inv64 = torch.from_numpy(np.where(deg == 0, 0.0, 1.0 / np.maximum(
        deg, 1))).to(dev)
    top10 = np.lexsort((np.arange(n), -oracle))[:10]
    worst = {0: 0.0, 2: 0.0, 3: 0.0, 1: 0.0}
    for (kind, _, _), u in zip(work, uids):
        r = done[u]
        if kind == 0:
            l1 = float(np.abs(r.ranks.astype(np.float64) - oracle).sum())
            ids, _ = host_topk(r.ranks, 10)
            if r.iterations != 20 or not np.array_equal(ids, top10):
                fail(f"serving drain uid {u}: {r.iterations} iterations, "
                     "top-10 ids differ from the float64 oracle's")
        elif kind == 3:
            l1 = float(np.abs(r.top_scores - oracle[r.top_ids]).sum())
            if r.iterations != 20 or not np.array_equal(r.top_ids, top10):
                fail(f"serving drain uid {u}: top-10 ids differ from the "
                     "float64 oracle's")
        else:
            continue
        worst[kind] = max(worst[kind], l1)
    stepped = [(u, ids) for (kind, ids, _), u in zip(work, uids)
               if kind == 2]
    want = personalized_oracle(at64, inv64, [ids for _, ids in stepped],
                               [done[u].iterations for u, _ in stepped],
                               damping).cpu().numpy()
    for j, (u, _) in enumerate(stepped):
        if not done[u].converged:
            fail(f"serving drain uid {u}: not converged")
        worst[2] = max(worst[2], float(np.abs(
            done[u].ranks.astype(np.float64) - want[:, j]).sum()))
    pushed = [(u, ids) for (kind, ids, _), u in zip(work, uids)
              if kind == 1]
    fixed = personalized_oracle(at64, inv64, [ids for _, ids in pushed],
                                [FIXED_POINT_ITERATIONS] * len(pushed),
                                damping).cpu().numpy()
    bound = PUSH_TOL * damping / (1.0 - damping)
    push_l1 = 0.0
    engine = PushQueryEngine(g, sess.engine)
    if engine.mode != "device":
        fail("push on a plan on the card did not pick the device loop")
    for j, (u, ids) in enumerate(pushed):
        r = done[u]
        worst[1] = max(worst[1], float(np.abs(
            r.top_scores - fixed[r.top_ids, j]).sum()))
        est = engine.query(seed_vector(ids), tol=PUSH_TOL).estimate
        push_l1 = max(push_l1, float(np.abs(est - fixed[:, j]).sum()))
    log(f"serving drain vs float64: uniform L1 {worst[0]!r}, uniform top-10 "
        f"scores L1 {worst[3]!r} (<= 1e-5, top-10 ids equal); stepper "
        f"seeded L1 at each query's iterations {worst[2]!r} (<= 1e-5); push "
        f"top-10 scores L1 {worst[1]!r}, whole push estimates L1 "
        f"{push_l1!r} vs the fixed point (<= tol*d/(1-d) = {bound!r})")
    if max(worst[0], worst[2], worst[3]) > 1e-5 or max(
            worst[1], push_l1) > bound:
        fail("serving drain disagrees with the float64 oracle")
    del fixed, want

    # ------------------------------------------------- the server
    server_ids = rng.integers(0, n, size=SERVE_SLOTS).tolist()
    seeds16 = np.zeros((n, SERVE_SLOTS), np.float32)
    seeds16[server_ids, np.arange(SERVE_SLOTS)] = 1.0
    srv16 = sess.server(batch=SERVE_SLOTS)
    srv1 = sess.server(batch=1)
    server_counts = {}
    for name, srv, arg in (("batch 16", srv16, seeds16),
                           ("batch 1", srv1, seeds16[:, 0].copy())):
        torch.cuda.synchronize()
        reset_counts()
        pr, it, _ = srv.query(arg)
        torch.cuda.synchronize()
        server_counts[name] = dict(b1.launch_counts)
        got = pr.cpu().numpy().reshape(n, -1)
        want = personalized_oracle(at64, inv64,
                                   [[i] for i in server_ids[:got.shape[1]]],
                                   [it] * got.shape[1], damping).cpu().numpy()
        l1 = float(np.abs(got.astype(np.float64) - want).sum(0).max())
        path = "warp" if srv is srv16 else "tile"
        log(f"PageRankServer {name}: {it} iterations, B1 launches by path "
            f"{server_counts[name]}, max column L1 vs float64 {l1!r} "
            f"(<= 1e-5)")
        if server_counts[name][path] != it or sum(
                server_counts[name].values()) != it:
            fail(f"PageRankServer {name}: B1 {path!r} not launched once per "
                 "iteration")
        if l1 > 1e-5:
            fail(f"PageRankServer {name} disagrees with the float64 oracle")
    del at64, want

    # ------------------------------------------------- times
    # uniform queries reuse the server's device start vector: their time
    # is the device loop's; seeded ones add the host's normalization and
    # the upload of the (n, batch) seeds
    srv_ms = {name: time_ms(lambda: srv.query(arg), reps=reps, warmup=1)
              for name, srv, arg, reps in (
                  ("batch 16", srv16, seeds16, 3),
                  ("batch 16 uniform", srv16, None, 3),
                  ("batch 1", srv1, seeds16[:, 0].copy(), 5),
                  ("batch 1 uniform", srv1, None, 5))}
    for name, ms in srv_ms.items():
        log(f"time PageRankServer.query {name} (20 iterations): {ms!r} ms "
            f"({card})")
    pool = sess.serve(slots=SERVE_SLOTS, chunk=SERVE_CHUNK, route="stepper")
    for _ in range(SERVE_SLOTS):
        pool.submit(tol=0.0, max_iters=10 ** 6)
    pool.step()                                # admit all 16
    chunk_ms = time_ms(pool.step, reps=5, warmup=1)
    log(f"time serving chunk ({SERVE_SLOTS} active slots, {SERVE_CHUNK} "
        f"iterations): {chunk_ms!r} ms, {chunk_ms / SERVE_CHUNK!r} "
        f"ms/iteration ({card})")
    profile_steps(pool.step, f"serving chunk ({SERVE_SLOTS} slots)", card,
                  names=("warp::gather_kernel",))
    del pool, srv16, srv1
    torch.cuda.synchronize()
    log(f"phase 5 (PageRank serving): {time.perf_counter() - t_phase:.1f} s")
    return {**B1_ENTRY, "path": "warp",
            "shape": f"kron-{SCALE}, d={SERVE_SLOTS} (the serving "
                     "stepper's slots)",
            "launches": drain_counts["warp"],
            "launches_by_path": {"drain": drain_counts, **server_counts},
            **warp_timed,
            "serving": {"queries_per_s": SERVE_QUERIES / drain_s,
                        "submit_s": submit_s, "drain_s": drain_s,
                        "chunk_ms": chunk_ms,
                        "query_ms": srv_ms}}


# --------------------------------------------------------------- phase 6
STREAM_TOL = 1e-6
STREAM_ITERATIONS = 200
D1_EDGES, DELTA_EDGES, STREAM_DELTAS = 32768, 8192, 4


def warm_bound(tol: float, damping: float) -> float:
    """L1 bound of a warm update against the new graph's fixed point: the
    push's own stop, tol·d/(1−d), plus (1+d)/(1−d) times the prior's
    tol·d/(1−d) error, which the warm seed carries (75.6·tol at 0.85)."""
    stop = tol * damping / (1.0 - damping)
    return stop + (1.0 + damping) / (1.0 - damping) * stop


def card_transpose64(g, dev):
    """A^T in float64 as a torch.sparse CSR on the card, built from the
    graph's edge list alone (repeated edges sum), and 1/out-degree: the
    yardsticks of phase 6, which nothing on the served path calls."""
    import torch
    n = g.num_nodes
    idx = torch.stack([torch.from_numpy(g.dst).to(dev).long(),
                       torch.from_numpy(g.src).to(dev).long()])
    ones = torch.ones(g.num_edges, dtype=torch.float64, device=dev)
    at64 = torch.sparse_coo_tensor(idx, ones, (n, n)).coalesce()
    del idx, ones
    at64 = at64.to_sparse_csr()
    deg = np.asarray(g.out_degree)
    inv64 = torch.from_numpy(np.where(deg == 0, 0.0, 1.0 / np.maximum(
        deg, 1))).to(dev)
    return at64, inv64


def uniform_fixed_point(at64, inv64, damping) -> np.ndarray:
    """The float64 global fixed point: ``personalized_oracle`` with every
    node a seed (uniform teleport), FIXED_POINT_ITERATIONS steps."""
    n = at64.shape[0]
    return personalized_oracle(at64, inv64, [np.arange(n)],
                               [FIXED_POINT_ITERATIONS],
                               damping)[:, 0].cpu().numpy()


def local_delta(rng, g, parts, count, part_size):
    """``count`` insertions (sources uniform in [0, n), destinations
    uniform in ``parts``) and ``count`` removals of distinct existing
    edges whose destinations lie in ``parts``: a recrawl of a few sites
    whose ids are contiguous."""
    from repro_torch.stream import GraphDelta
    n = g.num_nodes
    dst = (rng.choice(parts, count) * part_size
           + rng.integers(0, part_size, count))
    add = np.stack([rng.integers(0, n, count), np.minimum(dst, n - 1)],
                   axis=1).astype(np.int32)
    pool = np.flatnonzero(np.isin(g.dst // part_size, parts))
    ridx = rng.choice(pool, size=count, replace=False)
    return GraphDelta.of(add=add, remove=np.stack([g.src[ridx],
                                                   g.dst[ridx]], axis=1))


class StageTimer:
    """Seconds spent in named module functions while installed: each
    ``(module, name)`` is wrapped (the card synchronized around each
    call) and restored on exit. The push loop's sweeps are timed with
    CUDA events instead (``push_ms``, ``push_sweeps``)."""

    def __init__(self, *targets):
        self.targets, self.seconds, self.saved = targets, {}, []
        self.push_ms, self.push_sweeps = 0.0, 0

    def __enter__(self):
        import torch
        from repro_torch.stream import incremental
        for mod, name in self.targets:
            real = getattr(mod, name)

            def timed(*a, _real=real, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(*a, **kw)
                torch.cuda.synchronize()
                self.seconds[_name] = (self.seconds.get(_name, 0.0)
                                       + time.perf_counter() - t0)
                return out

            self.saved.append((mod, name, real))
            setattr(mod, name, timed)
        real_loop = incremental.residual_push_loop

        def push_loop(*a, **kw):
            run = real_loop(*a, **kw)

            def timed_run(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = run(*args)
                end.record()
                torch.cuda.synchronize()
                self.push_ms += start.elapsed_time(end)
                self.push_sweeps += int(out[1])
                return out

            return timed_run

        self.saved.append((incremental, "residual_push_loop", real_loop))
        incremental.residual_push_loop = push_loop
        return self

    def __exit__(self, *exc):
        for mod, name, real in reversed(self.saved):
            setattr(mod, name, real)
        self.saved.clear()

    def get(self, name) -> float:
        return self.seconds.get(name, 0.0)


def plan_device_tensors(plan, dev) -> list:
    """A pcpm_pallas plan's uploads: the packed streams and the "tile"
    gather order."""
    packed = plan._device[("packed", str(dev))]
    schedule = plan._device[("tile_schedule", str(dev))]
    return [packed.update_src, packed.update_valid, packed.edge_upd,
            packed.edge_dst, schedule.edge_upd, schedule.edge_dst,
            schedule.chunks, schedule.block_chunks, schedule.hubs]


def streaming_phase(dev, card, reuse, tile_entry, warp_entry) -> None:
    """Phase 6: streaming edge deltas on phase 3's kron graph and
    pcpm_pallas session: two localized deltas patched into the plan, a
    warm update (B1 "tile" once per push sweep) against a float64 fixed
    point, the patched plan against a fresh build, a scheduler rebind
    under in-flight queries (B1 "warp" on the new plan), and the device
    memory across a stream of four more deltas. Adds the launch counts
    and times to B1's two entries of the kernels line."""
    import torch
    import repro_torch.kernels.pcpm_spmv as b1_pkg
    from repro_torch.core import Partitioning, block_png, build_png
    from repro_torch.core.pagerank import pagerank
    from repro_torch.core.plan import evict_plans, plan_cache_stats
    from repro_torch.kernels.pcpm_spmv import kernel as b1, tile_schedule
    from repro_torch.serve import scheduler as sched_mod
    from repro_torch.stream import delta as delta_mod
    from repro_torch.stream import incremental
    from repro_torch.stream import patch as patch_mod
    g0, sess = reuse["g"], reuse["sess"]
    n, damping, psz = g0.num_nodes, kron().damping, kron().part_size
    tol, budget = STREAM_TOL, STREAM_ITERATIONS
    t_phase = time.perf_counter()

    def reset_counts():
        b1.launch_count = 0
        b1.launch_counts = dict.fromkeys(b1.PATHS, 0)

    # ------------------------------------------------- 1. the cold prior
    t0 = time.perf_counter()
    prior = sess.pagerank(num_iterations=budget, tol=tol)
    torch.cuda.synchronize()
    log(f"streaming prior: cold pcpm_pallas solve at tol {tol}: "
        f"{prior.iterations} iterations, last residual "
        f"{prior.residuals[-1]!r}, {time.perf_counter() - t0:.2f} s "
        f"({card})")
    if not prior.residuals[-1] <= tol:
        fail("streaming prior: the cold solve did not reach its tol")

    # ------------------------------------------------- 2. the deltas
    counts = np.diff(sess.plan.png.edge_offsets)
    near = np.argsort(np.abs(counts - np.median(counts)), kind="stable")[:3]
    pa, pb, pc = (int(p) for p in near)
    log(f"streaming: edges per partition {counts.tolist()}; partitions "
        f"nearest the median: P_a {pa}, P_b {pb}, P_c {pc}")
    rng = np.random.default_rng(5)
    d1 = local_delta(rng, g0, [pa, pb], D1_EDGES, psz)

    # ------------------------------------------------- 3. patch, warm
    stats = plan_cache_stats()
    patches0, builds0 = stats.plan_patches, stats.plan_builds
    stages = ((delta_mod, "apply_delta"), (patch_mod, "patch_png"),
              (patch_mod, "block_png"), (b1_pkg, "pack_blocked"),
              (b1_pkg, "tile_schedule"), (incremental, "seed_residual"))
    with StageTimer(*stages) as timer:
        t0 = time.perf_counter()
        sess.apply_delta(d1)
        t_d1 = time.perf_counter() - t0
        d2 = local_delta(rng, sess.graph, [pc], DELTA_EDGES, psz)
        t0 = time.perf_counter()
        sess.apply_delta(d2)
        t_d2 = time.perf_counter() - t0
        patched, g2 = sess.plan, sess.graph
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        warm = sess.pagerank(warm=True, tol=tol, num_iterations=budget)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        warm_counts = dict(b1.launch_counts)
    push_ms = timer.push_ms
    patches = stats.plan_patches - patches0
    log(f"streaming deltas: D1 {d1.num_added} + {d1.num_removed} in "
        f"partitions {pa}, {pb}; D2 {d2.num_added} + {d2.num_removed} in "
        f"{pc}: m {g0.num_edges} -> {g2.num_edges}; plan patches {patches} "
        f"(plan builds {stats.plan_builds - builds0})")
    if patches != 2 or stats.plan_builds != builds0:
        fail("streaming: the two deltas were not both patched by the splice")
    sec = timer.get
    log(f"time Session.apply_delta: D1 {t_d1!r} s, D2 {t_d2!r} s; of the "
        f"two: the edge list's update (apply_delta: multiset removal and "
        f"the fingerprint shift) {sec('apply_delta')!r} s, the splice "
        f"(patch_png) {sec('patch_png')!r} s, block_png "
        f"{sec('block_png')!r} s ({card})")
    log(f"time warm update (pagerank(warm=True)): {t_warm!r} s: "
        f"pack_blocked with its upload {sec('pack_blocked')!r} s, "
        f"tile_schedule {sec('tile_schedule')!r} s (the patched plan's "
        f"first use), seed_residual with g_old.csr {sec('seed_residual')!r}"
        f" s, the push {timer.push_sweeps} sweeps in {timer.push_ms!r} ms "
        f"({timer.push_ms / max(timer.push_sweeps, 1)!r} ms/sweep) ({card})")

    at2, inv2 = card_transpose64(g2, dev)
    fixed2 = uniform_fixed_point(at2, inv2, damping)
    top10 = np.lexsort((np.arange(n), -fixed2))[:10]
    bound = warm_bound(tol, damping)
    warm_l1 = float(np.abs(warm.ranks.cpu().numpy().astype(np.float64)
                           - fixed2).sum())
    ids10, _ = sess.top_ranked(10)
    log(f"warm update: {warm.iterations} sweeps (cold prior "
        f"{prior.iterations} iterations), last residual "
        f"{warm.residuals[-1]!r}; L1 vs the float64 fixed point of g2 "
        f"{warm_l1!r} (<= {bound!r} = 75.6 tol); top-10 ids equal: "
        f"{np.array_equal(ids10, top10)}; B1 launches by path {warm_counts}")
    if not 0 < warm.iterations < prior.iterations:
        fail("warm update: not fewer sweeps than the cold prior")
    if warm_l1 > bound or not np.array_equal(ids10, top10):
        fail("warm update disagrees with the float64 fixed point")
    warm_sweeps = warm.iterations
    if warm_counts != {"tile": warm_sweeps, "warp": 0}:
        fail("warm update: B1 'tile' not launched once per sweep, or "
             "'warp' launched")
    reset_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    cold = pagerank(g2, engine=sess.engine, num_iterations=budget, tol=tol)
    end.record()
    torch.cuda.synchronize()
    cold_ms, cold_counts = start.elapsed_time(end), dict(b1.launch_counts)
    cold_l1 = float(np.abs(cold.ranks.cpu().numpy().astype(np.float64)
                           - fixed2).sum())
    log(f"cold solve on the patched plan at tol {tol}: {cold.iterations} "
        f"iterations, {cold_ms!r} ms, L1 vs the fixed point {cold_l1!r} "
        f"(warm {warm_l1!r}); B1 launches by path {cold_counts} ({card})")
    if cold_counts["tile"] != cold.iterations:
        fail("cold solve on the patched plan: B1 'tile' launches differ "
             "from its iterations")

    # ------------------------------------------------- 4. the plan itself
    t0 = time.perf_counter()
    png = build_png(g2, Partitioning(n, psz))
    fresh = block_png(png)
    t_fresh = time.perf_counter() - t0
    same = all(np.array_equal(getattr(patched.png, f), getattr(png, f))
               for f in ("update_src", "update_offsets", "edge_update_idx",
                         "edge_dst", "edge_offsets"))
    same &= all(np.array_equal(getattr(patched.blocked, f),
                               getattr(fresh, f))
                for f in ("update_src", "edge_update_local",
                          "edge_dst_local"))
    sched = patched._device[("tile_schedule", str(dev))]
    fresh_sched = tile_schedule(fresh, device=dev)
    same_order = (sched.tile, sched.blocks) == (fresh_sched.tile,
                                                fresh_sched.blocks) and all(
        torch.equal(getattr(sched, f), getattr(fresh_sched, f))
        for f in ("edge_upd", "edge_dst", "chunks", "block_chunks", "hubs"))
    del fresh_sched, png, fresh
    log(f"patched plan vs a fresh build_png + block_png of g2 "
        f"({t_fresh!r} s on the host, the cost a patch replaces; {card}): "
        f"arrays equal {same}, 'tile' gather order equal {same_order}")
    if not (same and same_order):
        fail("the patched plan is not the fresh build")
    packed = patched._device[("packed", str(dev))]
    k, u = packed.update_src.shape
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randint(0, 16, (n, 1), generator=gen, device=dev).float() / 16
    bins = x[packed.update_src.view(-1)].view(k, u, 1)
    patched_err = check_b1(bins, packed.edge_upd, packed.edge_dst, psz,
                           "patched plan d=1", schedule=sched, exact=True)
    del bins, x, packed, sched

    # ------------------------------------------------- 5. serving, delta
    sch = sess.serve(slots=SERVE_SLOTS, chunk=SERVE_CHUNK)
    work = []
    for i in range(SERVE_SLOTS):
        kind = i % 4
        if kind == 0:                          # uniform
            work.append((kind, None, dict(tol=tol, max_iters=budget)))
        elif kind == 1:                        # one seed, top-k: push
            work.append((kind, [int(rng.integers(0, n))],
                         dict(top_k=10, tol=PUSH_TOL)))
        elif kind == 2:                        # four seeds
            work.append((kind, rng.integers(0, n, size=4).tolist(),
                         dict(tol=tol, max_iters=budget)))
        else:                                  # uniform top-k
            work.append((kind, None, dict(top_k=10, tol=tol,
                                          max_iters=budget)))

    def seed_vector(ids):
        s = np.zeros(n, np.float32)
        s[ids] = 1.0
        return s

    uids = [sch.submit(None if ids is None else seed_vector(ids), **kw)
            for _, ids, kw in work]
    sch.step()
    inflight, queued = sch.active_slots, sch.queued
    d3 = local_delta(rng, g2, [pa], DELTA_EDGES, psz)
    t0 = time.perf_counter()
    sch.apply_delta(d3)
    torch.cuda.synchronize()
    t_rebind = time.perf_counter() - t0
    g3 = sch.g
    chunk_iters = []
    read_chunk = sched_mod._read_chunk

    def counted_read(*args):
        out = read_chunk(*args)
        chunk_iters.append(int(out[1].max()))
        return out

    sched_mod._read_chunk = counted_read
    reset_counts()
    try:
        sch.run_until_drained()
        torch.cuda.synchronize()
    finally:
        sched_mod._read_chunk = read_chunk
    rebind_counts = dict(b1.launch_counts)
    done = {r.uid: r for r in sch.completed}
    if (sorted(done) != sorted(uids) or len(sch.completed) != len(uids)
            or any(r.error for r in sch.completed)):
        fail("serving across a delta: not every query ended exactly once")
    sch.metrics.reconcile()
    log(f"time SlotScheduler.apply_delta (D3 {d3.num_added} + "
        f"{d3.num_removed} in partition {pa}, {inflight} queries in "
        f"flight, {queued} queued): {t_rebind!r} s ({card}); rebind_count "
        f"{sch.rebind_count}; B1 launches by path after it {rebind_counts} "
        f"(chunk iterations {sum(chunk_iters)})")
    if sch.rebind_count != 1:
        fail("serving across a delta: rebind_count is not 1")
    if rebind_counts != {"warp": sum(chunk_iters), "tile": 0} or \
            not chunk_iters:
        fail("serving across a delta: B1 'warp' not once per chunk "
             "iteration on the new plan")
    at3, inv3 = card_transpose64(g3, dev)
    fixed3 = uniform_fixed_point(at3, inv3, damping)
    top3 = np.lexsort((np.arange(n), -fixed3))[:10]
    stop = tol * damping / (1.0 - damping)
    push_stop = PUSH_TOL * damping / (1.0 - damping)
    worst = dict.fromkeys(range(4), 0.0)
    for (kind, ids, _), u in zip(work, uids):
        r = done[u]
        if kind == 0:
            worst[0] = max(worst[0], float(np.abs(
                r.ranks.astype(np.float64) - fixed3).sum()))
        elif kind == 3:
            worst[3] = max(worst[3], float(np.abs(
                r.top_scores - fixed3[r.top_ids]).sum()))
            if not np.array_equal(r.top_ids, top3):
                fail(f"serving across a delta uid {u}: top-10 ids differ "
                     "from the float64 fixed point's")
        if kind in (0, 2, 3) and not r.converged:
            fail(f"serving across a delta uid {u}: not converged")
    seeded = [(u, ids) for (kind, ids, _), u in zip(work, uids) if kind == 2]
    want = personalized_oracle(at3, inv3, [ids for _, ids in seeded],
                               [FIXED_POINT_ITERATIONS] * len(seeded),
                               damping).cpu().numpy()
    for j, (u, _) in enumerate(seeded):
        worst[2] = max(worst[2], float(np.abs(
            done[u].ranks.astype(np.float64) - want[:, j]).sum()))
    del at3, inv3, want
    pushed = [(u, ids) for (kind, ids, _), u in zip(work, uids) if kind == 1]
    routes = [sch.metrics.traces[u].route for u, _ in pushed]
    want = personalized_oracle(at2, inv2, [ids for _, ids in pushed],
                               [FIXED_POINT_ITERATIONS] * len(pushed),
                               damping).cpu().numpy()
    for j, (u, _) in enumerate(pushed):
        r = done[u]
        worst[1] = max(worst[1], float(np.abs(
            r.top_scores - want[r.top_ids, j]).sum()))
    del at2, inv2, want
    log(f"serving across a delta vs float64 fixed points of g3: uniform L1 "
        f"{worst[0]!r}, uniform top-10 scores L1 {worst[3]!r}, seeded "
        f"{worst[2]!r} (<= tol*d/(1-d) = {stop!r}); push (answered at "
        f"submit, before D3; routes {routes}) top-10 scores L1 vs g2's "
        f"{worst[1]!r} (<= {push_stop!r})")
    if max(worst[0], worst[2], worst[3]) > stop or worst[1] > push_stop \
            or routes != ["push"] * len(pushed):
        fail("serving across a delta disagrees with the float64 fixed "
             "points")
    # what the stream is measured against: the session's state alone (its
    # graph, plan and ranks; the dropped scheduler's last plan keeps its
    # uploads in the plan cache and counts as part of the start)
    sweeps0 = prior.iterations
    del sch, patched, g2, g3, warm, cold, prior
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ------------------------------------------------- 6. memory, stream
    mem0 = torch.cuda.memory_allocated()
    parts = [pa, pb, pc, pa]
    stream = []
    first_stages = dict(timer.seconds)
    with StageTimer(*stages) as timer:
        for i in range(STREAM_DELTAS):
            d = local_delta(rng, sess.graph, [parts[i]], DELTA_EDGES, psz)
            t0 = time.perf_counter()
            sess.apply_delta(d)
            res = sess.pagerank(warm=True, tol=tol, num_iterations=budget)
            torch.cuda.synchronize()
            stream.append((time.perf_counter() - t0, res.iterations,
                           torch.cuda.memory_allocated()))
            log(f"session delta {i + 3} (partition {parts[i]}): apply_delta "
                f"+ warm update {stream[-1][0]:.2f} s, {res.iterations} "
                f"sweeps, last residual {res.residuals[-1]!r}; "
                f"torch.cuda.memory_allocated() {stream[-1][2]} "
                f"(start {mem0}) ({card})")
            if not 0 < res.iterations < sweeps0:
                fail(f"session delta {i + 3}: not a warm update")
    uploads = plan_device_tensors(sess.plan, dev)
    one_plan = sum(t.numel() * t.element_size() for t in uploads)
    # torch's caching allocator keeps a block whole when less than 1 MiB
    # of it would be left over, and counts the whole block as allocated:
    # each of the plan's tensors, and the session's new rank and degree
    # vectors, may count up to 1 MiB more than its bytes
    slack = (len(uploads) + 2) << 20
    log(f"stream of {STREAM_DELTAS} deltas after the scheduler's: device "
        f"memory {mem0} -> {stream[-1][2]} B (+{stream[-1][2] - mem0}; one "
        f"plan's uploads {one_plan} B in {len(uploads)} tensors, the "
        f"allocator's block slack <= {slack} B); stage seconds over the "
        f"stream { {k: round(v, 3) for k, v in timer.seconds.items()} }, "
        f"push {timer.push_ms!r} ms for {timer.push_sweeps} sweeps "
        f"({card})")
    if stream[-1][2] - mem0 > one_plan + slack:
        fail("streaming: device memory grew by more than one plan's "
             "uploads across the stream")
    # the version chain's cached plans (host arrays, and the first graph's
    # plans of the four engines with their uploads) go with the phase
    evict_plans(g0)
    torch.cuda.synchronize()
    log(f"phase 6 (streaming): {time.perf_counter() - t_phase:.1f} s")
    tile_entry["streaming"] = {
        "warm_launches": warm_counts, "warm_sweeps": warm_sweeps,
        "cold_launches_on_patched": cold_counts,
        "patched_max_abs_err": patched_err,
        "stream_sweeps": [s[1] for s in stream],
        "apply_delta_s": [t_d1, t_d2], "warm_update_s": t_warm,
        "stages_s": first_stages, "stream_stages_s": timer.seconds,
        "push_ms": push_ms, "cold_ms": cold_ms,
        "fresh_build_s": t_fresh}
    warp_entry["streaming"] = {"rebind_launches": rebind_counts,
                               "rebind_s": t_rebind}


# --------------------------------------------------------------- phase 7
def b3_inputs(dev, gen, b, hq, hkv, sq, skv, d, dtype):
    """q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), standard normal."""
    import torch

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    return normal(b, sq, hq, d), normal(b, skv, hkv, d), normal(b, skv, hkv, d)


def check_b3(args, label, **kw) -> float:
    """Launch B3 once, hold it against the plain version on the same
    inputs upcast to float32, and check that it took the path
    ``b3_path`` names; max abs err."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    from repro_torch.kernels.flash_attention import kernel as b3
    path = b3.b3_path(args[0].dtype, args[1].dtype, args[0].shape[1])
    before = dict(b3.launch_counts)
    out = flash_attention_cuda(*args, **kw)
    torch.cuda.synchronize()
    if b3.launch_counts != {**before, path: before[path] + 1}:
        fail(f"B3 {label}: launched {b3.launch_counts} from {before}, "
             f"not once through {path!r}")
    ref = attention_ref(*(a.float() for a in args), **kw)
    torch.cuda.synchronize()
    tol = B3_F32_TOL if out.dtype == torch.float32 else B3_BF16_TOL
    err = float((out.float() - ref).abs().max())
    shapes = " ".join(str(tuple(a.shape)) for a in args)
    log(f"B3 {label} via {path!r}: q k v {shapes} {str(args[0].dtype)[6:]}, "
        f"{ {k: v for k, v in kw.items() if not torch.is_tensor(v)} }: "
        f"max_abs_err={err!r} (rtol {tol['rtol']}, atol {tol['atol']}; "
        f"mean |ref| {float(ref.abs().mean())!r}, max |ref| "
        f"{float(ref.abs().max())!r})")
    torch.testing.assert_close(out.float(), ref, **tol,
                               msg=lambda m: f"B3 {label}: {m}")
    return err


def check_b3_shapes(dev) -> dict:
    """B3 against its plain version at TestFlashAttention's shapes and at
    the LM slice's decode and prefill shapes; returns those two cases as
    {name: (args, kwargs, max abs err)}."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    for b, hq, hkv, s, d in ((1, 4, 4, 256, 64), (2, 8, 2, 128, 64),
                             (1, 4, 1, 384, 128)):
        check_b3(b3_inputs(dev, gen, b, hq, hkv, s, s, d, f32),
                 "causal", causal=True)
    for window in (64, 128, 200):
        check_b3(b3_inputs(dev, gen, 1, 2, 2, 384, 384, 64, f32),
                 f"window {window}", causal=True, window=window)
    check_b3(b3_inputs(dev, gen, 1, 2, 2, 200, 200, 64, f32), "unpadded",
             causal=True)
    check_b3(b3_inputs(dev, gen, 1, 2, 2, 256, 256, 64, bf16), "bf16",
             causal=True)
    # the same shapes in bfloat16, through "tc" (float32 went to "simt")
    for window in (64, 128, 200):
        check_b3(b3_inputs(dev, gen, 1, 2, 2, 384, 384, 64, bf16),
                 f"bf16 window {window}", causal=True, window=window)
    check_b3(b3_inputs(dev, gen, 2, 8, 2, 128, 128, 64, bf16), "bf16 GQA",
             causal=True)
    check_b3(b3_inputs(dev, gen, 1, 2, 2, 200, 200, 64, bf16),
             "bf16 unpadded", causal=True)
    cfg_heads = (LM_HEADS, LM_KV_HEADS)
    lens = np.random.default_rng(1).integers(1, MAX_LEN + 1, SLOTS)
    lens[:2] = (1, MAX_LEN)                  # the two ends of the range
    decode = (b3_inputs(dev, gen, SLOTS, *cfg_heads, 1, MAX_LEN, LM_DH, bf16),
              dict(causal=False, kv_len=torch.tensor(
                  lens, dtype=torch.int32, device=dev)))
    cases = {"decode": decode + (check_b3(decode[0], "decode shape",
                                          **decode[1]),)}
    b, s = PREFILL_SHAPE
    prefill = (b3_inputs(dev, gen, b, *cfg_heads, s, s, LM_DH, bf16),
               dict(causal=True))
    cases["prefill"] = prefill + (check_b3(prefill[0], "prefill shape",
                                           **prefill[1]),)
    return cases


# --------------------------------------------------------------- phase 8
def sdpa_call(q, k, v, *, causal, kv_len=None):
    """``scaled_dot_product_attention`` on the same inputs, the
    yardstick: heads-major views of the (B, S, H, D) tensors, GQA by
    ``enable_gqa``, per-row lengths as a boolean mask."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if kv_len is not None:
        mask = (torch.arange(k.shape[1], device=q.device)[None, :]
                < kv_len[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal, enable_gqa=True)


def b3_entry(case, name, launches, card) -> dict:
    """Time B3, its plain version and SDPA at one shape; its bound from
    this case's inputs: the bytes of q, o and the live K/V rows, and the
    4·D operations of every visible (query, key) pair."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    from repro_torch.kernels.flash_attention import kernel as b3
    (q, k, v), kw, err = case
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    ms = time_ms(lambda: flash_attention_cuda(q, k, v, **kw), reps=20)
    plain_ms = time_ms(lambda: attention_ref(q, k, v, **kw), reps=5)
    library_ms = time_ms(sdpa_call(q, k, v, **kw), reps=20)
    if "kv_len" in kw:                       # decode: Sq = 1, no causal
        live = int(kw["kv_len"].clamp(max=skv).sum())
        pairs = hq * live
    else:                                    # causal, Sq = Skv
        live = b * skv
        pairs = b * hq * sq * (sq + 1) // 2
    nbytes = q.element_size() * (2 * q.numel() + 2 * live * hkv * d)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops = 4 * d * pairs
    ops_ms = ops / PEAK_BF16_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    path = b3.b3_path(q.dtype, k.dtype, sq)
    log(f"B3 at {name} via {path!r}: {ms!r} ms; bound {bound_ms!r} ms "
        f"({nbytes} B at "
        f"{PEAK_BYTES_PER_S / 1e12} TB/s, {ops} operations at "
        f"{PEAK_BF16_PER_S / 1e12:.0f} TFLOP/s bf16); plain version "
        f"{plain_ms!r} ms; scaled_dot_product_attention {library_ms!r} ms "
        f"({card})")
    return {
        "name": f"flash_attention/{name}",
        "path": path,
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def profile_steps(step, label, card, names=()) -> None:
    """Device busy share and top kernels of PROFILE_STEPS calls of
    ``step()``; with ``names``, also the device time of the kernels whose
    name holds one of them (one kernel's, e.g. B3's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if not busy_us:
        log(f"profile {label}: no device time in the trace (not measured)")
        return
    log(f"profile {label} ({PROFILE_STEPS} steps): device busy "
        f"{busy_us:.0f} us of {wall_us:.0f} us wall "
        f"({100 * busy_us / wall_us:.1f}%), idle "
        f"{100 * (1 - busy_us / wall_us):.1f}% ({card})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / PROFILE_STEPS:9.1f} us/step "
            f"x{e.count / PROFILE_STEPS:<5.1f} {e.key[:90]}")
    if names:
        mine = [e for e in events if any(n in e.key for n in names)]
        us = sum(e.self_device_time_total for e in mine) / PROFILE_STEPS
        log(f"profile {label}: kernels {'/'.join(names)} {us:.1f} us/step "
            f"of device time ({100 * us * PROFILE_STEPS / busy_us:.1f}% of "
            f"the busy time) in "
            f"{sum(e.count for e in mine) / PROFILE_STEPS:.1f} launches per "
            f"step")


def lm_phases(dev, card, b3_cases) -> list[dict]:
    """Phases 7 and 8: TinyLlama-1.1B serving, prefill and the decode
    consistency check, then their times; returns B3's entries of the
    kernels line (decode and prefill shapes)."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, ServeEngine
    cfg = get(ARCH)
    t0 = time.perf_counter()
    model = tf.init_lm(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {cfg.name} at its configured widths (layers {cfg.n_layers}, "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}): {n_params} bfloat16 parameters "
        f"from torch.Generator seed 0, {time.perf_counter() - t0:.1f} s")
    if n_params != cfg.param_count():
        fail(f"{n_params} parameters, the config counts {cfg.param_count()}")
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def greedy(logits):                  # argmax on the card; finiteness
        finite.logical_and_(torch.isfinite(logits).all())   # read at the end
        return logits.argmax(-1)

    def engine():
        return ServeEngine(cfg, model, batch_slots=SLOTS, max_len=MAX_LEN,
                           sample=greedy)

    engine().run_until_drained([Request(uid=-1, prompt=[1] * 4,
                                        max_new_tokens=4)])   # warm-up
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(
        1, cfg.vocab, int(rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
    ).tolist(), max_new_tokens=NEW_TOKENS) for i in range(N_REQUESTS)]
    eng = engine()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    b3.launch_count = 0                  # counts of the serving path only
    start.record()
    eng.run_until_drained(reqs)
    end.record()
    torch.cuda.synchronize()
    decode_launches = b3.launch_count
    drain_ms = start.elapsed_time(end)
    generated = sum(len(r.generated) for r in reqs)
    prompts = sum(len(r.prompt) for r in reqs)
    log(f"main path (LM serving): {N_REQUESTS} requests (prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, {prompts} in all) over "
        f"{SLOTS} slots, max_len {MAX_LEN}: {eng.steps} decode steps, "
        f"{generated} generated tokens, B3 launches {decode_launches} "
        f"(= {cfg.n_layers} x {eng.steps}: "
        f"{decode_launches == cfg.n_layers * eng.steps}), logits finite "
        f"{bool(finite)}")
    if not all(r.done and r.error is None
               and len(r.generated) == NEW_TOKENS for r in reqs):
        fail("a request did not finish with its 64 tokens")
    if decode_launches != cfg.n_layers * eng.steps:
        fail("B3 launches differ from layers x decode steps")
    if not bool(finite):
        fail("non-finite logits in the drain")

    b, s = PREFILL_SHAPE
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    b3.launch_count = 0                  # counts of prefill only
    logits, cache = tf.prefill(model, tokens)
    torch.cuda.synchronize()
    prefill_launches = b3.launch_count
    log(f"main path (prefill {PREFILL_SHAPE}): B3 launches "
        f"{prefill_launches}, logits {tuple(logits.shape)} finite "
        f"{bool(torch.isfinite(logits).all())}, cache "
        f"{tuple(cache['k'].shape)}")
    if (prefill_launches != cfg.n_layers or logits.shape != (b, 1, cfg.vocab)
            or not bool(torch.isfinite(logits).all())
            or cache["k"].shape != (cfg.n_layers, b, s, cfg.n_kv_heads,
                                    cfg.dh)):
        fail("prefill")
    del logits, cache

    # decode_step token by token against forward on the same tokens
    seq = torch.from_numpy(rng.integers(0, cfg.vocab, (1, CONSISTENCY_LEN))
                           ).to(dev)
    b3.launch_count = 0
    full = tf.forward(model, seq)[0][0].float()
    cache = tf.init_cache(cfg, 1, CONSISTENCY_LEN, device=dev)
    steps = []
    for i in range(CONSISTENCY_LEN):
        step_logits, cache = tf.decode_step(model, cache, seq[:, i:i + 1], i)
        steps.append(step_logits[0, 0].float())
    dec = torch.stack(steps)
    torch.cuda.synchronize()
    gap = float((dec - full).abs().max())
    top2 = full.topk(2, -1).values
    decided = (top2[:, 0] - top2[:, 1]) > DECODE_TOL
    differ = int(((dec.argmax(-1) != full.argmax(-1)) & decided).sum())
    log(f"decode vs forward over {CONSISTENCY_LEN} tokens: max abs logit gap "
        f"{gap!r} (tol {DECODE_TOL}; logits up to "
        f"{float(full.abs().max()):.3f}); greedy tokens differ at {differ} "
        f"of {int(decided.sum())} positions whose top-2 margin exceeds the "
        f"tol; B3 launches {b3.launch_count} "
        f"(= {cfg.n_layers} x {CONSISTENCY_LEN + 1})")
    if gap > DECODE_TOL or differ or \
            b3.launch_count != cfg.n_layers * (CONSISTENCY_LEN + 1):
        fail("decode_step disagrees with forward")
    del cache, steps, dec, full

    # ---------------------------------------------------- 8. times
    log(f"time LM drain: {drain_ms / eng.steps!r} ms per decode step over "
        f"the drain, {generated / drain_ms * 1e3!r} generated tokens/s, "
        f"{(generated + prompts) / drain_ms * 1e3!r} tokens/s fed and "
        f"generated ({card})")
    steady = engine()
    for i in range(SLOTS):
        steady.add_request(Request(uid=i, prompt=[1 + i] * PROMPT_LENS[1],
                                   max_new_tokens=NEW_TOKENS))
    step_ms = time_ms(steady.step, reps=32, warmup=2)
    log(f"time decode step, {SLOTS} active slots: {step_ms!r} ms, "
        f"{SLOTS / step_ms * 1e3!r} tokens/s ({card})")
    prefill_ms = time_ms(lambda: tf.prefill(model, tokens), reps=3, warmup=1)
    log(f"time prefill {PREFILL_SHAPE}: {prefill_ms!r} ms, "
        f"{b * s / prefill_ms * 1e3!r} tokens/s ({card})")
    profile_steps(lambda: tf.prefill(model, tokens),
                  f"prefill {PREFILL_SHAPE}", card, names=B3_KERNELS)
    profile_steps(steady.step, f"decode, {steady.active} active slots",
                  card, names=B3_KERNELS)
    return [b3_entry(b3_cases["decode"], "decode", decode_launches, card),
            b3_entry(b3_cases["prefill"], "prefill", prefill_launches, card)]


# --------------------------------------------------------------- phase 10
def check_b2(table, idx, w, label, tol) -> float:
    """Launch B2 once, hold it against the plain version; max abs err."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag_cuda,
                                                   embedding_bag_ref)
    out = embedding_bag_cuda(table, idx, w)
    torch.cuda.synchronize()
    ref = embedding_bag_ref(table, idx, w)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    log(f"B2 {label}: table {tuple(table.shape)} {str(table.dtype)[6:]}, ids "
        f"{tuple(idx.shape)} {str(idx.dtype)[6:]}, weights "
        f"{w is not None}: max_abs_err={err!r} (rtol {tol['rtol']}, atol "
        f"{tol['atol']})")
    torch.testing.assert_close(out.float(), ref.float(), **tol,
                               msg=lambda m: f"B2 {label}: {m}")
    return err


def check_b2_shapes(dev) -> None:
    """B2 against its plain version at TestEmbeddingBag's shapes (with
    weights), on pad ids, a negative id and a bfloat16 table."""
    import torch
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    gen = torch.Generator(device=dev).manual_seed(2)
    for v, d, b, l in B2_TEST_SHAPES:
        table = torch.rand((v, d), generator=gen, device=dev)
        idx = torch.randint(0, v, (b, l), generator=gen, device=dev,
                            dtype=torch.int32)
        w = torch.rand((b, l), generator=gen, device=dev)
        check_b2(table, idx, w, f"TestEmbeddingBag V={v} d={d} B={b} L={l}",
                 B2_TOL)
        check_b2(table.bfloat16(), idx.long(), w, "bfloat16 table",
                 B2_BF16_TOL)
    v = 512
    table = torch.rand((v, 128), generator=gen, device=dev)
    pads = torch.tensor([[0, 1, v, v], [2, v, v, v]], dtype=torch.int32,
                        device=dev)
    check_b2(table, pads, None, "pad ids", B2_TOL)
    out = embedding_bag_cuda(table, pads)
    if not (torch.allclose(out[0], table[0] + table[1], rtol=1e-6)
            and torch.equal(out[1], table[2])):
        fail("B2 pad ids: not the sums of the valid rows")
    neg = torch.tensor([[-1, 3, v, v + 88]], device=dev)
    check_b2(table, neg, None, "negative id", B2_TOL)
    if not torch.allclose(embedding_bag_cuda(table, neg)[0],
                          table[0] + table[3], rtol=1e-6):
        fail("B2 negative id: not row 0 (the reference's clip)")


# --------------------------------------------------------------- phase 11
def zipf_ids(rng, shape, vocab) -> np.ndarray:
    """int32 item ids in [0, vocab) whose popularity follows Zipf(ZIPF_A)."""
    ranks = rng.zipf(ZIPF_A, size=shape).astype(np.uint64)
    return ((ranks * np.uint64(ID_HASH)) % np.uint64(vocab)).astype(np.int32)


def histories(rng, batch, cfg) -> np.ndarray:
    """(batch, hist_len) int32 histories with lengths uniform in
    1..hist_len, the tail padded with ``cfg.vocab``."""
    hist = zipf_ids(rng, (batch, cfg.hist_len), cfg.vocab)
    lens = rng.integers(1, cfg.hist_len + 1, batch)
    hist[np.arange(cfg.hist_len)[None, :] >= lens[:, None]] = cfg.vocab
    return hist


def b2_entry(table, ids, name, launches, err, card) -> dict:
    """Time B2 as MIND's lookup calls it (``embedding_lookup_cuda`` on
    ``ids``: one-id bags), its plain version and ``F.embedding_bag`` on
    the same ids; its bound from this run's ids: 4 B per id, one row per
    distinct valid id, the output."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import (embedding_bag_ref,
                                                   embedding_lookup_cuda)
    flat = ids.reshape(-1, 1)
    v, d = table.shape
    n = flat.shape[0]
    # the yardstick, never called by the port: pads clamped to row 0 with
    # weight 0
    valid = flat < v
    lib_ids = torch.where(valid, flat, 0)
    lib_w = valid.to(table.dtype)

    def b2_call():
        return embedding_lookup_cuda(table, ids)

    def library_call():
        return F.embedding_bag(lib_ids, table, mode="sum",
                               per_sample_weights=lib_w)
    if n < 10 ** 6:
        # host-bound: alternating rounds, compared by their medians
        rounds = {"B2": [], "F.embedding_bag": []}
        for r in range(B2_ROUNDS):
            order = (("B2", b2_call), ("F.embedding_bag", library_call))
            for key, fn in order if r % 2 == 0 else reversed(order):
                rounds[key].append(time_ms(fn, reps=B2_ROUND_CALLS))
        ms = float(np.median(rounds["B2"]))
        library_ms = float(np.median(rounds["F.embedding_bag"]))
        log(f"B2 at {name} vs F.embedding_bag, {B2_ROUNDS} alternating "
            f"rounds of {B2_ROUND_CALLS} calls: medians {ms!r} ms vs "
            f"{library_ms!r} ms (rounds {rounds['B2']!r} vs "
            f"{rounds['F.embedding_bag']!r}) ({card})")
        plain_ms = time_ms(lambda: embedding_bag_ref(table, flat), reps=10)
    else:
        ms = time_ms(b2_call, reps=5)
        plain_ms = time_ms(lambda: embedding_bag_ref(table, flat), reps=2)
        library_ms = time_ms(library_call, reps=5)
    lib_gap = float((library_call() - b2_call().view(n, d)).abs().max())
    n_valid = int(valid.sum())
    distinct = int(torch.unique(flat[valid]).numel())
    nbytes = (flat.element_size() * n + table.element_size() * d * distinct
              + table.element_size() * d * n)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops = n_valid * d                        # one add per valid id, column
    ops_ms = ops / PEAK_F32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"B2 at {name}: {ms!r} ms; bound {bound_ms!r} ms ({nbytes} B for "
        f"{n} ids, {n_valid} valid, {distinct} distinct, at "
        f"{PEAK_BYTES_PER_S / 1e12} TB/s); plain version {plain_ms!r} ms; "
        f"F.embedding_bag {library_ms!r} ms (max gap to B2 {lib_gap!r}) "
        f"({card})")
    return {
        "name": f"embedding_bag/{name}",
        "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:49",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def mind_phases(dev, card) -> list[dict]:
    """Phases 9 (B2 at MIND's lookup shapes) and 10: MIND serving at full
    width, its checks and times; returns B2's entries of the kernels
    line (serve_p99 and serve_bulk)."""
    import torch
    from repro_torch.configs import RECSYS_SHAPES, get
    from repro_torch.kernels.embedding_bag import (embedding_bag_ref,
                                                   embedding_lookup_cuda)
    from repro_torch.kernels.embedding_bag import kernel as b2
    from repro_torch.models import recsys
    cfg = get(MIND_ARCH)
    shapes = {s.name: s for s in RECSYS_SHAPES}
    t0 = time.perf_counter()
    model = recsys.init_mind(cfg, generator=torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    log(f"model: {cfg.name} at its configured widths (vocab {cfg.vocab}, "
        f"embed_dim {cfg.embed_dim}, interests {cfg.n_interests}, routing "
        f"iterations {cfg.capsule_iters}, hist_len {cfg.hist_len}): float32 "
        f"table {tuple(model.table.shape)} "
        f"({model.table.numel() * 4 / 1e9:.2f} GB) from torch.Generator seed "
        f"0, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    hist = {name: torch.from_numpy(histories(
        rng, shapes[name].global_batch, cfg)).to(dev)
        for name in ("serve_p99", "serve_bulk")}
    user = torch.from_numpy(histories(
        rng, shapes["retrieval_cand"].global_batch, cfg)).to(dev)
    cand = torch.from_numpy(rng.choice(
        cfg.vocab, shapes["retrieval_cand"].n_candidates, replace=False
    ).astype(np.int32)).to(dev)
    lens = (hist["serve_bulk"] < cfg.vocab).sum(1).float()
    log(f"traffic: Zipf({ZIPF_A}) ids folded into [0, {cfg.vocab}), "
        f"lengths 1-{cfg.hist_len} (serve_bulk mean "
        f"{float(lens.mean()):.2f}), pad {cfg.vocab}; "
        f"{cand.numel()} distinct candidates; {time.perf_counter() - t0:.1f} "
        "s on the host")

    # ------------------------------ 9. B2 exact at MIND's lookup shapes
    errs = {}
    for name, ids in (("serve_p99", hist["serve_p99"]),
                      ("serve_bulk", hist["serve_bulk"]),
                      ("retrieval_cand", cand)):
        out = embedding_lookup_cuda(model.table, ids)
        ref = embedding_bag_ref(model.table, ids.reshape(-1, 1)).reshape(
            out.shape)
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        errs[name] = float((out - ref).abs().max())
        log(f"B2 MIND lookup at {name}: {ids.numel()} one-id bags of ids "
            f"{tuple(ids.shape)} on the {tuple(model.table.shape)} table: "
            f"exact rows {same}, max_abs_err={errs[name]!r}")
        if not same:
            fail(f"B2 at MIND's {name} lookup: not the plain version's rows")
        del out, ref

    # ------------------------------ 10. main path: serve and retrieve
    launches, caps = {}, {}
    for name in ("serve_p99", "serve_bulk"):
        b2.launch_count = 0              # counts of this call only
        caps[name] = recsys.serve_step(model, cfg, hist[name])
        torch.cuda.synchronize()
        launches[name] = b2.launch_count
    b2.launch_count = 0
    scores, ids = recsys.retrieval_step(model, cfg, user, cand, top_k=TOP_K)
    torch.cuda.synchronize()
    launches["retrieval_cand"] = b2.launch_count
    finite = all(bool(torch.isfinite(t).all())
                 for t in (*caps.values(), scores))
    log(f"main path (MIND serving): serve_step at serve_p99 "
        f"{tuple(caps['serve_p99'].shape)}, at serve_bulk "
        f"{tuple(caps['serve_bulk'].shape)}, retrieval_step over "
        f"{cand.numel()} candidates top-{TOP_K}; B2 launches "
        f"{launches['serve_p99']}, {launches['serve_bulk']}, "
        f"{launches['retrieval_cand']} (expected 1, 1, 2); outputs finite "
        f"{finite}")
    if (launches["serve_p99"], launches["serve_bulk"],
            launches["retrieval_cand"]) != (1, 1, 2):
        fail("B2 launches differ from 1 per serve_step, 2 per "
             "retrieval_step")
    if not finite or scores.shape != (1, TOP_K):
        fail("MIND outputs not finite or of the wrong shape")
    del caps["serve_bulk"]

    # the card against the port's CPU path on the same parameters
    cpu_model = recsys.MIND(cfg, *(getattr(model, name).cpu()
                                   for name in recsys.PARAM_NAMES))
    on_cpu = recsys.serve_step(cpu_model, cfg, hist["serve_p99"].cpu())
    gap = float((caps["serve_p99"].cpu() - on_cpu).abs().max())
    log(f"serve_p99 capsules, card vs CPU: max abs gap {gap!r} (rtol "
        f"{MIND_TOL['rtol']}, atol {MIND_TOL['atol']}; max |caps| "
        f"{float(on_cpu.abs().max())!r})")
    torch.testing.assert_close(caps["serve_p99"].cpu(), on_cpu, **MIND_TOL,
                               msg=lambda m: f"MIND card vs CPU: {m}")
    del cpu_model, on_cpu

    # padding invariance: the sentinel V + 7 instead of V
    h7 = torch.where(hist["serve_p99"] < cfg.vocab, hist["serve_p99"],
                     cfg.vocab + 7)
    caps7 = recsys.serve_step(model, cfg, h7)
    same = torch.equal(caps7, caps["serve_p99"])
    gap7 = float((caps7 - caps["serve_p99"]).abs().max())
    log(f"padding invariance (pad {cfg.vocab} -> {cfg.vocab + 7}): "
        f"bitwise equal {same}, max abs gap {gap7!r}")
    torch.testing.assert_close(caps7, caps["serve_p99"], rtol=1e-5,
                               atol=1e-6, msg=lambda m: f"padding: {m}")

    # retrieval against a float64 rescoring of the same candidates
    user_caps = recsys.interests(model, cfg, user).double()
    s64 = torch.einsum("bkd,nd->bkn", user_caps,
                       model.table[cand.long()].double()).amax(1)
    top64 = s64.topk(TOP_K + 1, dim=-1)
    apart = torch.ones((1, TOP_K + 1), dtype=torch.bool, device=dev)
    gaps = top64.values.diff(dim=1).abs() > SCORE_TOL
    apart[:, 1:] &= gaps
    apart[:, :-1] &= gaps
    apart = apart[:, :TOP_K]
    same_ids = torch.equal(ids[apart], top64.indices[:, :TOP_K][apart])
    score_gap = float((scores.double() - top64.values[:, :TOP_K]).abs().max())
    log(f"retrieval vs float64 rescoring: top-{TOP_K} ids equal at "
        f"{int(apart.sum())} separated positions: {same_ids}; max score gap "
        f"{score_gap!r} (tol {SCORE_TOL}); scores "
        f"{float(scores[0, -1])!r}..{float(scores[0, 0])!r}")
    if not same_ids or score_gap > SCORE_TOL:
        fail("retrieval disagrees with the float64 rescoring")
    del user_caps, s64, top64

    # ------------------------------ 10. times
    torch.cuda.empty_cache()
    for name, reps in (("serve_p99", 50), ("serve_bulk", 5)):
        ms = time_ms(lambda: recsys.serve_step(model, cfg, hist[name]),
                     reps=reps, warmup=1)
        b = hist[name].shape[0]
        log(f"time serve_step {name} (B {b}): {ms!r} ms, "
            f"{b / ms * 1e3!r} users/s ({card})")
    torch.cuda.empty_cache()
    ms = time_ms(lambda: recsys.retrieval_step(model, cfg, user, cand,
                                               top_k=TOP_K), reps=20)
    log(f"time retrieval_step ({cand.numel()} candidates, top-{TOP_K}): "
        f"{ms!r} ms ({card})")
    profile_steps(lambda: recsys.serve_step(model, cfg, hist["serve_p99"]),
                  "serve_step serve_p99", card, names=("embedding_bag",))
    entries = [b2_entry(model.table, hist[name], name, launches[name],
                        errs[name], card)
               for name in ("serve_p99", "serve_bulk")]
    torch.cuda.synchronize()
    return entries


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
    from repro_torch.kernels import build_all
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)})")

    # ---------------------------------------------------- 1. build
    # one nvcc per kernel source, all started together
    for built in build_all():
        log(f"build: nvcc for sm_90a: {built.path.name} took "
            f"{built.seconds:.2f} s")
        for name, props in ptxas_report(built.log):
            log(f"  ptxas {name}: {props}")

    # ---------------------------------------------------- 2. B1 checks
    check_b1_test_shapes(dev)
    # ---------------------------------------------------- 3-4. PageRank
    tile_entry, warp_timed, reuse = pagerank_phases(dev, card)
    torch.cuda.empty_cache()
    # ---------------------------------------------------- 5. PageRank serving
    kernels = [tile_entry, serving_phase(dev, card, reuse, warp_timed)]
    torch.cuda.empty_cache()
    # ---------------------------------------------------- 6. streaming
    streaming_phase(dev, card, reuse, *kernels)
    del reuse
    torch.cuda.empty_cache()
    # ---------------------------------------------------- 7. B3 checks
    b3_cases = check_b3_shapes(dev)
    # ---------------------------------------------------- 8-9. LM serving
    kernels += lm_phases(dev, card, b3_cases)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # ---------------------------------------------------- 10. B2 checks
    check_b2_shapes(dev)
    # ---------------------------------------------------- 10-11. MIND serving
    kernels += mind_phases(dev, card)
    log(f"phases 10-11 (B2, MIND serving): {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
