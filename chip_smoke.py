#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each of which exits non-zero when it fails:

1. the card's name and power limit, and the nvcc build of the kernels;
2. kernel B1 (the PCPM gather, ``repro_torch/csrc/pcpm_gather.cu``)
   against its plain PyTorch version on the card, each call through the
   path ``b1_path`` names ("warp" for the blocked streams alone or d > 1,
   "tile" for d = 1 with a PNG's gather order and its ragged (U,) bins,
   ``tile_gather_cuda``): the shapes of the JAX
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
   have launched once per pcpm_pallas iteration, through "tile". The
   second solve of each session captures the fixed-count loop as a CUDA
   graph and replays it, the third replays it (``core/pagerank.py``):
   both held to the same gate and within 1e-6 of the first, one capture
   and two replays a session, and each replay counted as one "tile"
   launch per pcpm_pallas iteration and none on the others. Then the
   host time and device bytes of the gather order, and B1 against its
   plain version at the main path's shape (d = 1 through "tile", exact)
   and at the serving stepper's (d = 16 through "warp", from bins and in
   the fused form, exact): "tile" through ``tile_gather_cuda`` over the
   engine's own ragged bins and gather order, as the solve calls it;
4. times with CUDA events after warm-up: ms per iteration and GB/s per
   engine (bytes of the paper's models, ``core/comm_model.py``), B1's
   time beside its byte bound, its plain version and a ``torch.sparse``
   CSR product with A^T, which the port never calls, at d = 1 ("tile"
   over the engine's ragged bins, the kernels line's "tile" entry) and at
   d = 16 ("warp" from bins); B1 "warp" at d = 16 in the fused
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
   ``build_png`` (every array; no blocked form held) and its "tile"
   gather order against a fresh one, B1 "tile" over its ragged bins
   exact against its plain version; ``SlotScheduler.apply_delta`` under 16 queries in phase 5's
   mix (every query once, ``rebind_count`` 1, B1 "warp" once per chunk
   iteration on the new plan, answers within tol·d/(1−d) of the new
   graph's float64 fixed points, push answers of the old one's); four
   more deltas with warm updates, the device memory ending no more than
   one plan's uploads above its start. Times: the parts of
   ``apply_delta``, ``seed_residual``, the push, the cold solve, the
   fresh build and the scheduler's rebind;
6b. reliability on phase 3's graph and pcpm_pallas plan (its uploads made
   again): ``SlotScheduler(slots=16, chunk=8, route="stepper")`` drains
   32 queries in phase 5's seeded mix at converging tolerances, twice
   fault-free (equal iteration counts, or the phase fails); (a) under a
   fault plan (NaN at step 2, Inf at step 3, a stepper failure at step
   5) with one stepper retry: two quarantines, one failure, every query
   converged with the fault-free ranks (≤ 1e-6) and iterations (plus
   those the poisoned columns burned), B1 "warp" once per chunk
   iteration; (b) the same plan without retries: exactly the 16 queries
   in flight fail, the rest converge; (c) a failing and a corrupted
   ``apply_delta`` of phase 6's first delta leave the old plan serving;
   (d) ``snapshot_scheduler`` three chunks in, ``restore_scheduler``
   into a fresh scheduler: the uninterrupted drain's iterations and
   ranks, uids kept, refused on another graph; (e) ``save_checkpoint`` /
   ``load_checkpoint`` of a pcpm_pallas solve, a warm restart on the same
   graph and across the first delta (B1 "tile" once per push sweep,
   within 75.6·tol of a float64 fixed point), wrong lineage refused;
6c. ingest: the kron graph at scale 18 written as ~8.1M tab-separated
   lines in sparse 64-bit ids (dense id times an odd constant mod 2**61)
   under a comment header; ``ingest_edge_list`` with an offsite filter
   (~5% of the edges), self-loops dropped and duplicates removed; the
   stats balance, the id map survives save/load, ``res.open(method=
   "pcpm_pallas")`` solves to phase 3's gate against a float64 oracle of
   the ingested graph (B1 "tile" once an iteration), and ``top_ranked``
   and serving (a stepper top 10, a push seeded at one external id)
   answer in external ids. Times: writing, parsing, id mapping, dedup,
   edges/s;
7. the gateway and observability on phase 3's graph and pcpm_pallas
   plan: an observed session's ``gateway()`` autotunes the slot pool
   (B in 2-64 under a 25 ms chunk of 8; its probe times the stepper's own
   SpMV, B1 "warp" fused) with 2 push workers and 1,024 cached results;
   B1 "warp" at the chosen width against its plain version; 4 submitter
   threads x 32 queries in phase 5's mix then 32 repeats: every future
   once with a distinct uid, phase 5's accuracy gates, repeats
   bit-identical cache hits, B1 "warp" once per chunk iteration and
   "tile" once per push sweep and seeding, one stepper build; a NaN
   through phase 6b's fault plan leaves a ``flight-*.jsonl`` dump;
   queries/s of one gateway without the cache, its observability switched
   off and on between storms in alternating order, each storm after a
   full ``gc.collect()`` (on >= 0.95 x off, over 16 storms a side);
   inline push latency with the stepper idle and loaded; phase 6's D2
   through ``gateway.apply_delta`` under a second storm: the cache
   invalidated at the commit, repeats re-solved on the new graph within
   the gates of its float64 oracles; a complete span
   tree per query, the metrics endpoint as Prometheus text, and
   ``measure_plan`` of the pcpm plan within 2x of eq. 5;
7b. the sharded path at world size 1 on phase 3's graph, through a
   one-rank NCCL process group: ``open(g, EngineConfig(method=
   "pcpm_sharded", num_shards=1)).pagerank()`` held to phase 3's oracle
   gate and within 1e-6 of phase 3's pcpm and pcpm_pallas ranks, with
   exactly one NCCL ``all_to_all_single`` an iteration by the mesh's
   counter; a tol=1e-6 run stopping where pcpm's does; ms per iteration
   beside pcpm's (CUDA events), the host seconds of ``build_sharded_png``
   and the bytes it uploads; ``SlotScheduler(sharded=True, slots=16,
   chunk=8)`` draining 16 queries of phase 5's mix on the stepper, within
   1e-6 of an unsharded pcpm scheduler and stopping where it stops (or
   one iteration apart at a rounding stop, named); one sharded
   ``PageRankServer`` query; the wire accounting of the JAX package's
   8-shard layout of the same graph (``benchmarks/dist_wire.py``'s
   numbers), on the host;
8. kernel B3 (flash attention, ``repro_torch/csrc/flash_attention.cu``)
   against its plain version on the same inputs upcast to float32, on
   the card, each call through the path ``b3_path`` names ("tc" for
   bfloat16 with Sq > 1, "split" for Sq = 1, "simt" for float32): the
   shapes of the JAX package's ``TestFlashAttention`` (float32 within
   2e-3, windows 64/128/200, unpadded S = 200; in bfloat16 too), the LM
   slice's decode shape (B 8, Hq 32, Hkv 4, Sq 1, 1024 cache slots,
   mixed per-slot lengths) and its prefill shape (4, 2048, causal), and
   every shape at which phase 10b launches it: mixtral-8x7b's decode
   (Hq 32, Hkv 8, dh 128, 1024 slots), its (1, 6144) prefill and its
   forward over 6208 tokens under its 4096 window (whole key tiles
   skipped); grok-1's (GQA group 6: Hq 48, Hkv 8) and deepseek-67b's
   (group 8: Hq 64, Hkv 8) (2, 2048) prefills and forwards over 2080
   tokens through "tc", and their decodes over 2080 slots;
   bfloat16 outputs within rtol 1.6e-2, atol 2e-3 (their rounding; inside
   TestFlashAttention's 5e-2);
9. the LM serving path: TinyLlama-1.1B at its configured widths
   (``configs/tinyllama_1_1b.py``: 22 layers, d_model 2048, 32/4 heads,
   d_ff 5632, vocab 32000), random bfloat16 weights from a seeded
   generator; a ``ServeEngine`` with 8 slots and max_len 1024 drains 16
   requests (prompts of 32-512 tokens, 64 new tokens each) with B3
   launched once per layer per decode step; then ``prefill`` at
   (4, 2048), and ``decode_step`` over 256 tokens against ``forward`` on
   the same tokens;
10. times with CUDA events: ms per decode step and tokens/s, prefill ms,
   B3 beside its bound, its plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick the
   port never calls); the device idle share and top kernels of profiled
   decode steps and prefills, with B3's share of each;
10b. the MoE and sliding-window LMs at their published widths, random
   bfloat16 weights (routers float32) from a seeded generator, the
   parameter count held to the config's plus the routers', each model
   freed before the next: mixtral-8x7b with its depth cut from 32 to 8
   layers (all 32 would not fit the card) drains phase 9's 16 requests
   over 8 slots (max_len 1024: the window does not bind) with B3 once per
   layer per step and finite logits; ``prefill`` at (1, 6144), past the
   4096 window, at the published capacity 1.25 (B3 once a layer, the
   cache a 4096-slot ring); 64 ``decode_step``s after a prefill against
   ``forward`` over the 6208 tokens at capacity E/k = 4, where the
   forward drops no route, as decode never does (phase 9's gate at the
   positions routed alike in every layer, at least 90% of them; router
   flips, a token sent to another set of experts, named with their
   margins, those that no flip at an earlier layer of the same position
   explains held to a near-tie);
   grok-1-314b (2 of 64 layers) and deepseek-67b (4 of 95): a (2, 2048)
   prefill and 32 decode steps against ``forward``. Times with CUDA
   events: mixtral's decode step beside its weight-bytes bound, its
   expert GEMMs at decode beside theirs, its prefill; the device idle
   share and top kernels of profiled decode steps with B3's share; B3 at
   mixtral's decode and windowed prefill and grok-1's decode beside their
   bounds, plain versions and ``scaled_dot_product_attention`` (an
   explicit window mask where the window binds);
11. kernel B2 (the embedding bag, ``repro_torch/csrc/embedding_bag.cu``)
   against its plain version on the card: the shapes of the JAX
   package's ``TestEmbeddingBag`` with weights (rtol 1e-4, atol 1e-5),
   in float32 and with a bfloat16 table, pad ids and a negative id (row
   0); lookups with the plain version's values and, where a row was
   read, its bits: contiguous tables and unaligned views, d 64, 512,
   6272, 13, 3 and 4, int32 and int64 ids, pads and a negative id, then
   mask weights and L 8 at exact sums; then MIND's lookups (one-id bags)
   on its 10M-row table at the shapes of phase 12, which must give the
   plain version's rows exactly;
12. the MIND serving path: ``configs/mind.py`` as it stands (vocab 10M,
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
13. LM training (``python -m repro_torch.launch.train``'s path): (a)
   kernel B3-bwd (``repro_torch/csrc/flash_attention_bwd.cu``, the
   backward of B3 behind ``kernels/flash_attention/ops.py``'s autograd
   function) against autograd through the plain version on the same
   inputs upcast to float32, at TestFlashAttention's shapes (float32
   through its "simt" path within 2e-3; bfloat16 through "tc" within its
   outputs' rounding, rtol 1.6e-2 and 1.6e-2 of the largest magnitude,
   and a second "tc" call bit-equal to the first), at tinyllama's
   training microbatch (4, 4096, 32/4 heads, causal) and mixtral's (1,
   4096, 32/8, dh 128, window 4096), B3's forward with its log-sum-exp
   bit-equal to B3's without; (b) tinyllama-1.1b at its configured
   widths through ``launch/train.py::build_step_and_state`` (random
   bfloat16 weights from seed 0), the train_4k sequence of 4096 with the
   global batch cut from 256 to 8 in 2 microbatches: 5 steps on one batch
   at a constant lr lower the loss, loss/nll/gnorm finite, B3-bwd once per
   layer and microbatch, every call through "tc" (B3 twice: the forward
   and the per-layer recompute); time per step, tokens/s, peak memory and
   a profile of one step with the device idle share and B3's and
   B3-bwd's shares; (c) the whole model's
   gradient on a (1, 2048) batch with B3-bwd and with the plain attention
   backward, every parameter within a relative L2 error of 2e-2, wq, wk
   and wv nonzero; (d) the restart drill at full width with the depth cut
   to 2 layers: 10 steps, checkpoints every 5, a failure at step 7,
   resumed from step 5, final parameters and moments bit-identical to the
   uninterrupted run; a save and a restore timed; (e) one step through
   the int8 error-feedback compressed path, and mixtral-8x7b at its
   widths with its depth cut to 2 of 32 layers, bfloat16 moments, (1,
   4096): 3 steps with finite loss and aux, B3-bwd once per layer through
   "tc"; (f) B3-bwd at tinyllama's and mixtral's training shapes beside
   its bound (10·D operations a visible pair at the bfloat16 rate), its
   plain version and the backward of ``scaled_dot_product_attention`` (a
   yardstick the port never calls).
14. MIND training at the reference's train_batch cell (B 65,536; the
   cell's ``AdamW(lr=1e-3)``) and ``configs/mind.py``'s widths (vocab 10M,
   d 64): kernel B2-bwd (``embedding_bag_bwd`` in
   ``repro_torch/csrc/embedding_bag.cu``, the table's gradient behind
   ``kernels/embedding_bag/ops.py``'s autograd function) against its
   plain backward on TestEmbeddingBag's shapes with weights (exact sums
   bit for bit, random float32 within rtol 1e-4, atol 1e-5), bfloat16,
   pads and a negative id, and one row read by 300,000 ids (exact sums
   bit for bit, random ones the CPU emulation's bits), every call twice
   with the same bits; MIND from ``init_mind`` (seed 0) on Zipf histories
   and targets: one step's table gradient through B2-bwd against the
   plain backward, 5 steps on one batch (loss finite and falling, B2 and
   B2-bwd once a step), a step repeated from the same state with the same
   bits; ms per step, users/s, peak memory, a profiled step with B2's and
   B2-bwd's shares, and B2-bwd beside its bound, its plain version and a
   zeroed tensor's ``index_add_`` (a yardstick the port never calls).
15. GNN training (``models/gnn.py``): kernels B2 and B2-bwd at the
   GNNs' message widths (graphcast d 512, nequip 288, mace 1152,
   equiformer-v2 6272, bfloat16; the edge softmax's (E, 8) float32) on
   each cell's real edge lists, as the models call them (B2 gathering
   rows and, weighted by the edge mask, a segment-sum's gradient; B2-bwd
   summing rows by destination, its walk split into column slabs):
   exact sums bit for bit, random values within each element's summation
   bound, second calls bit-identical;
   the four GNNs at their published widths and depths in bfloat16
   messages with float32 masters (the reference's production cells,
   ``launch/specs.py:210-216``: ``AdamW(lr=1e-3)``, n_out = n_vars or 16)
   for 5 steps on one ``data.batch_for_shape`` batch at full_graph_sm
   and molecule, and graphcast at ogb_products with nodes and edges cut
   by GNN_OGB_CUT: losses finite and falling, B2 and B2-bwd launched as
   ``gnn.kernel_calls`` counts from the model's structure, a repeated
   step bit-identical, the ogb step's peak under 70 GB; at depth 2, full
   width, float32 without TF32, the card's loss and every gradient leaf
   within 1e-4 of the CPU path's; ms a step, edges/s and peak memory of
   every cell, profiles of graphcast's ogb cell and equiformer-v2's
   full_graph_sm (idle share, top kernels, B2's and B2-bwd's shares),
   and B2 and B2-bwd at those two cells beside their bounds, their plain
   versions, ``index_select`` and a zeroed tensor's ``index_add_`` (the
   yardsticks, never called by the port), B2 at the destinations and, in
   a log line, at the sources (rows read out of order).
16. the PCPM-distributed GraphCast (``models/gnn_dist.py``) on phase 15's
   ogb_products cut in a one-rank NCCL group (one shard; every exchange
   a real NCCL all-to-all): ``build_sharded_png`` timed on the host; at
   depth 2, full width, float32 without TF32, the distributed forward
   within the reference test's rtol 2e-4 / atol 2e-5 of
   ``graphcast_forward`` on the same edges in the layout's order and
   each gradient leaf within 1e-4; graphcast at its published widths
   and depth in bfloat16 messages for 4 steps of ``AdamW(lr=1e-3)``:
   step 1's loss, gnorm and parameter updates within 1e-4 of the
   single-device step's on the same edges from the same parameters,
   losses finite and falling, B2 and B2-bwd launched and the mesh's
   collectives called as ``dist_kernel_calls`` and
   ``dist_collective_calls`` count them, a repeated step bit-identical,
   the peak under 70 GB; ms a step and edges/s beside phase 15's
   graphcast step, and the step's model-flops share of the bfloat16
   peak (the reference's 6·E·d²·L proxy, ``launch/specs.py``).

Each phase's wall seconds are logged as it ends, and all of them before
the kernels line. The line before the last is a JSON object describing
each kernel (B1, B3, B2, B3-bwd and B2-bwd, and B2's and B2-bwd's GNN
entries; B2-bwd's with the form of its walk that the timed calls
launched); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import importlib
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
# H100 SXM, NVIDIA data sheet: HBM3 bandwidth and bfloat16 dense
# tensor-core rate from the port (``repro_torch/launch/__init__.py``),
# float32 (non-tensor) rate
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.launch import HBM_BW, PEAK_FLOPS_BF16  # noqa: E402
PEAK_BYTES_PER_S, PEAK_BF16_PER_S = HBM_BW, PEAK_FLOPS_BF16
PEAK_F32_PER_S = 67e12
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
# characters of a kernel's name in a profile's top-kernel lines: enough to
# tell torch's elementwise kernels apart (copy, add, cast)
PROFILE_NAME_CHARS = 160
# phase 10b, the MoE and sliding-window LMs at their published widths with
# the depth cut to fit one 80 GB card in bfloat16: mixtral-8x7b 8 of 32
# layers (~2.90 GB a layer; all 32 would be ~93 GB), grok-1-314b 2 of 64
# (~9.8 GB a layer), deepseek-67b 4 of 95 (~1.4 GB a layer)
MOE_ARCH, MOE_LAYERS = "mixtral-8x7b", 8
MOE_PREFILL = (1, 6144)        # past the 4096 window, 6144 % 4096 != 0
MOE_DECODE_STEPS = 64
BIG_ARCHS = (("grok-1-314b", 2), ("deepseek-67b", 4))
BIG_PREFILL = (2, 2048)
BIG_DECODE_STEPS = 32
# decode_step vs forward in bfloat16 through the MoE layers, at positions
# routed alike in every layer: the max logit gaps measured on the H100 were
# 0.0625 (mixtral), 0.0313 (grok-1) and 0.0391 (deepseek) on logits up to
# 5.7; phase 9's tolerance is kept
MOE_DECODE_TOL = 0.2
# a router flip between decode and forward that no flip at an earlier
# layer of the same position explains must be a near-tie: the first ones
# measured on the H100 had margins of 0.0044 and 0.0067 (mixtral, 64
# positions); and at least 90% of the positions must route alike in every
# layer (measured 61 of 64 for mixtral, all for grok-1 and deepseek)
MOE_ROUTER_TIE = 0.05
MOE_ROUTED_ALIKE = 0.9
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
             exact=False, update_src=None, offsets=None) -> float:
    """Launch B1 once through the path ``b1_path`` names (failing if
    another ran), hold it against the plain version (bit for bit when
    ``exact``); max abs err. With ``update_src``, ``bins`` is x (n, d) and
    the call is the "warp" path's fused form (``pcpm_spmv_cuda``). With
    a ``schedule``, ``bins`` are a PNG's ragged (U,) updates with their
    ``offsets`` and the call is the "tile" path (``tile_gather_cuda``);
    ``eu`` and ``ed`` are then not read."""
    import torch
    from repro_torch.kernels.pcpm_spmv import (b1_path, kernel,
                                               pcpm_gather_cuda,
                                               pcpm_gather_ref,
                                               pcpm_spmv_cuda, pcpm_spmv_ref,
                                               tile_gather_cuda,
                                               tile_gather_ref)
    fused = update_src is not None
    tile = schedule is not None
    path = b1_path(1 if tile else bins.shape[-1], tile)
    before = dict(kernel.launch_counts)
    if fused:
        out = pcpm_spmv_cuda(bins, update_src, eu, ed, part_size=part_size)
    elif tile:
        out = tile_gather_cuda(bins, offsets, schedule)
    else:
        out = pcpm_gather_cuda(bins, eu, ed, part_size=part_size)
    torch.cuda.synchronize()
    ran = [p for p in kernel.PATHS if kernel.launch_counts[p] != before[p]]
    if ran != [path]:
        fail(f"B1 {label}: expected path {path!r}, launched {ran}")
    if fused:
        ref = pcpm_spmv_ref(bins, update_src, eu, ed, part_size=part_size)
    elif tile:
        ref = tile_gather_ref(bins, schedule, offsets)
    else:
        ref = pcpm_gather_ref(bins, eu, ed, part_size=part_size)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    what = (f"x {tuple(bins.shape)} through update_src "
            f"{tuple(update_src.shape)}" if fused else
            f"ragged bins {tuple(bins.shape)} of {schedule.num_partitions} "
            f"partitions" if tile else f"bins {tuple(bins.shape)}")
    streams = (f"{schedule.edge_upd.shape[0]} edges in the gather order"
               if tile else f"streams {tuple(eu.shape)}")
    log(f"B1 {label} via {path!r}{' (fused)' if fused else ''}: {what} "
        f"{str(bins.dtype)[6:]}, {streams}, P={part_size}: "
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
        png = build_png(g, Partitioning(g.num_nodes, part_size))
        packed = pack_blocked(block_png(png), g.num_nodes, edge_block=128,
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
        # "tile" at d = 1 over the PNG's ragged bins: one tile per
        # partition, and tiles of 16 nodes
        x16 = torch.from_numpy(rng.integers(0, 16, g.num_nodes).astype(
            np.float32) / 16).to(dev)
        bins = x16.index_select(0, torch.from_numpy(png.update_src).to(dev))
        offsets = torch.from_numpy(png.update_offsets.astype(np.int32)).to(
            dev)
        for tile_bytes in (None, 64):
            schedule = tile_schedule(png, device=dev, **(
                {} if tile_bytes is None else {"tile_bytes": tile_bytes}))
            for b in (bins, bins.bfloat16()):
                check_b1(b, None, None, part_size,
                         f"rmat({scale},{deg}) part {part_size} d=1 tile "
                         f"{schedule.tile}", schedule=schedule, exact=True,
                         offsets=offsets)
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
    from repro_torch.core.plan import blocked_of
    from repro_torch.kernels.pcpm_spmv import (kernel as b1, pack_blocked,
                                               pcpm_gather_cuda,
                                               pcpm_gather_ref,
                                               pcpm_spmv_cuda,
                                               pcpm_spmv_pallas,
                                               pcpm_spmv_ref,
                                               tile_gather_cuda,
                                               tile_gather_ref,
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
        f" k={plan.png.num_partitions}")
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

    # the second solve captures and replays the loop, the third replays
    solver = importlib.import_module("repro_torch.core.pagerank")
    graphs = solver.graph_captures, solver.graph_replays
    for method in METHODS:
        sess, eager = sessions[method], results[method].ranks.cpu().numpy()
        for label in ("capture", "replay"):
            before = dict(b1.launch_counts)
            res = sess.pagerank()
            torch.cuda.synchronize()
            launched = {p: b1.launch_counts[p] - before[p] for p in b1.PATHS}
            ranks = res.ranks.cpu().numpy()
            gap = float(np.abs(ranks - eager).max())
            log(f"{method} {label}: B1 launches {launched}, L-inf to the "
                f"first solve {gap!r} (<= 1e-6)")
            tiles = iterations if method == "pcpm_pallas" else 0
            if res.iterations != iterations or launched != {"warp": 0,
                                                            "tile": tiles}:
                fail(f"{method} {label}: {res.iterations} iterations, B1 "
                     f"launches {launched}")
            if not gap <= 1e-6:
                fail(f"{method} {label} differs from the first solve")
            ids10, _ = sess.top_ranked(10)
            check_against_oracle(f"{method} {label}", ranks, ids10, oracle)
    graphs = (solver.graph_captures - graphs[0],
              solver.graph_replays - graphs[1])
    log(f"CUDA graphs: {graphs[0]} captures, {graphs[1]} replays")
    if graphs != (len(METHODS), 2 * len(METHODS)):
        fail("expected one capture and two replays a session")

    before = b1.launch_count
    res = sessions["pcpm_pallas"].pagerank(tol=1e-7, check_every=5,
                                           num_iterations=200)
    log(f"pcpm_pallas tol=1e-7 check_every=5: {res.iterations} iterations, "
        f"last residual {res.residuals[-1]!r}, B1 launches "
        f"{b1.launch_count - before}")
    if b1.launch_count - before != res.iterations:
        fail("B1 launch count differs from the tol run's iterations")

    # the d = 1 solve's own layouts: the PNG's (U,) updates with their
    # offsets and the "tile" path's gather order, which the engine built
    # at its first solve; the gather order built again to time it
    upd, offsets = plan._device[("updates", str(dev))]
    schedule = plan._device[("tile_schedule", str(dev))]
    t0 = time.perf_counter()
    again = tile_schedule(plan.png, device=dev)
    torch.cuda.synchronize()
    t_sched = time.perf_counter() - t0
    if not all(torch.equal(getattr(again, f), getattr(schedule, f)) for f in (
            "edge_upd", "edge_dst", "chunks", "block_chunks", "hubs")):
        fail("the gather order built again differs from the engine's")
    upd_bytes = sum(t.numel() * t.element_size() for t in (upd, offsets))
    packed_kept = [key for key in plan._device if key[0] == "packed"]
    log(f"host preprocessing pcpm_pallas gather order (tile_schedule): "
        f"{t_sched:.1f} s; tile {schedule.tile} destinations, "
        f"{schedule.chunks.shape[0]} chunks over {schedule.blocks} blocks; "
        f"device bytes kept by the engine for d = 1: updates {upd_bytes} + "
        f"gather order {schedule.nbytes} = {upd_bytes + schedule.nbytes}; "
        f"packed blocked streams kept: {packed_kept}")
    if packed_kept:
        fail("the d = 1 solves packed the blocked streams")
    # the serving stepper's layout (d > 1, "warp"): the blocked streams,
    # every partition padded to the heaviest one
    t0 = time.perf_counter()
    blk = blocked_of(plan)
    packed = pack_blocked(blk, g.num_nodes, device=dev)
    torch.cuda.synchronize()
    packed_bytes = sum(t.numel() * t.element_size() for t in (
        packed.update_src, packed.update_valid, packed.edge_upd,
        packed.edge_dst))
    log(f"serving layout (blocked_of + pack_blocked): "
        f"{time.perf_counter() - t0:.1f} s, edge pad "
        f"{blk.edge_pad_frac:.4f} update pad {blk.update_pad_frac:.4f}, "
        f"{packed_bytes} device bytes")

    # B1 against its plain version at the main path's shape (d = 1, "tile"
    # over the engine's ragged bins) and at the serving stepper's (d = 16:
    # phase 5's 16 slots, "warp" over the padded bins)
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
        if d == 1:
            main_bins[d] = x[:, 0].index_select(0, upd)
            errs[d] = check_b1(main_bins[d], None, None, part_size,
                               "main path d=1", schedule=schedule,
                               exact=True, offsets=offsets)
        else:
            main_bins[d] = x[packed.update_src.view(-1)].view(k, u, d)
            errs[d] = check_b1(main_bins[d], packed.edge_upd,
                               packed.edge_dst, part_size,
                               "serving path d=16", exact=True)
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
    # input read once (d values per real update), the (k, P, d) float32
    # output; d adds per edge
    edges = plan.png.num_edges
    num_updates = plan.png.num_updates

    def bound(d, row_bytes):
        bytes_moved = 8 * edges + row_bytes + 4 * d * k * part_size
        bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
        ops_ms = d * edges / PEAK_F32_PER_S * 1e3
        return bytes_moved, max(bytes_ms, ops_ms), (
            "bytes" if bytes_ms >= ops_ms else "operations")

    # B1 from bins, the gather's own input: d float32 values per real
    # update; at d = 1 the main path's "tile" over the engine's ragged
    # bins (``tile_gather_cuda``, as the solve calls it), at d = 16 "warp"
    # over padded bins (the serving path does not call this form)
    timed = {}
    for d in (1, 16):
        if d == 1:
            args = (main_bins[1], offsets, schedule)
            ms = time_ms(lambda: tile_gather_cuda(*args), reps=50, warmup=5)
            plain_ms = time_ms(lambda: tile_gather_ref(
                main_bins[1], schedule, offsets), reps=10)
        else:
            args = (main_bins[d], packed.edge_upd, packed.edge_dst)
            ms = time_ms(lambda: pcpm_gather_cuda(*args, part_size=part_size),
                         reps=20, warmup=5)
            plain_ms = time_ms(lambda: pcpm_gather_ref(
                *args, part_size=part_size), reps=3)
        bytes_moved, bound_ms, bound_by = bound(d, 4 * d * num_updates)
        xv = torch.rand((g.num_nodes, d), generator=gen, device=dev)
        library_ms = time_ms(lambda: at_dev @ xv, reps=20 if d == 1 else 5)
        path = "tile" if d == 1 else "warp"
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
             "at_dev": at_dev, "plan": plan, "pcpm_sess": sessions["pcpm"],
             "ranks": {m: results[m].ranks.cpu().numpy()
                       for m in ("pcpm", "pcpm_pallas")}}
    return entry, timed[16], reuse


# ------------------------------------------------- shared by phases 5-7
def reset_b1_counts() -> None:
    """Kernel B1's launch counts, in all and by path, set to 0."""
    from repro_torch.kernels.pcpm_spmv import kernel as b1
    b1.launch_count = 0
    b1.launch_counts = dict.fromkeys(b1.PATHS, 0)


def seed_vector(n: int, ids) -> np.ndarray:
    """A teleport vector with weight 1 on each of ``ids``."""
    s = np.zeros(n, np.float32)
    s[ids] = 1.0
    return s


class ChunkCounter:
    """While installed, ``iterations`` gets each stepper chunk's
    iteration count (the largest ``took`` of its one read-back,
    ``serve/scheduler.py::_read_chunk``): B1 "warp" launches once per
    chunk iteration on a pcpm_pallas plan."""

    def __enter__(self):
        from repro_torch.serve import scheduler
        self.iterations, real = [], scheduler._read_chunk

        def counted(*args):
            out = real(*args)
            self.iterations.append(int(out[1].max()))
            return out

        self.real, scheduler._read_chunk = real, counted
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import scheduler
        scheduler._read_chunk = self.real


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
    from repro_torch.serve.topk import host_topk
    g, sess, oracle, at_dev = (reuse[k] for k in ("g", "sess", "oracle",
                                                  "at_dev"))
    n, damping = g.num_nodes, kron().damping
    t_phase = time.perf_counter()

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
    torch.cuda.synchronize()
    reset_b1_counts()
    t0 = time.perf_counter()
    with ChunkCounter() as chunks:
        uids = [sch.submit(None if ids is None else seed_vector(n, ids),
                           **kw) for _, ids, kw in work]
        submit_s = time.perf_counter() - t0    # the pushes run inline
        sch.run_until_drained()
        torch.cuda.synchronize()
    chunk_iters = chunks.iterations
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
        est = engine.query(seed_vector(n, ids), tol=PUSH_TOL).estimate
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
        reset_b1_counts()
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
    """A pcpm_pallas plan's uploads: the PNG's updates and the "tile"
    gather order of d = 1, and the packed streams once a d > 1 SpMV made
    them."""
    schedule = plan._device[("tile_schedule", str(dev))]
    out = list(plan._device[("updates", str(dev))])
    out += [schedule.edge_upd, schedule.edge_dst, schedule.chunks,
            schedule.block_chunks, schedule.hubs]
    packed = plan._device.get(("packed", str(dev)))
    if packed is not None:
        out += [packed.update_src, packed.update_valid, packed.edge_upd,
                packed.edge_dst]
    return out


def streaming_phase(dev, card, reuse, tile_entry, warp_entry) -> dict:
    """Phase 6: streaming edge deltas on phase 3's kron graph and
    pcpm_pallas session: two localized deltas patched into the plan, a
    warm update (B1 "tile" once per push sweep) against a float64 fixed
    point, the patched plan against a fresh build, a scheduler rebind
    under in-flight queries (B1 "warp" on the new plan), and the device
    memory across a stream of four more deltas. Adds the launch counts
    and times to B1's two entries of the kernels line. Returns what phase
    6b and 7 reuse: the first two deltas (D1, D2) and the graph of the
    rebind (g3); the version chain's plans stay in the plan cache until
    phase 7 ends."""
    import torch
    import repro_torch.kernels.pcpm_spmv as b1_pkg
    from repro_torch.core import Partitioning, build_png
    from repro_torch.core.pagerank import pagerank
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.plan import plan_cache_stats
    from repro_torch.kernels.pcpm_spmv import kernel as b1, tile_schedule
    from repro_torch.stream import delta as delta_mod
    from repro_torch.stream import incremental
    from repro_torch.stream import patch as patch_mod
    g0, sess = reuse["g"], reuse["sess"]
    n, damping, psz = g0.num_nodes, kron().damping, kron().part_size
    tol, budget = STREAM_TOL, STREAM_ITERATIONS
    t_phase = time.perf_counter()

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
              (plan_mod, "block_png"), (b1_pkg, "pack_blocked"),
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
        reset_b1_counts()
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
        f"(patch_png) {sec('patch_png')!r} s, block_png (only where "
        f"blocked_of is read, which no d = 1 solve does) "
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
    reset_b1_counts()
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
    t_fresh = time.perf_counter() - t0
    same = all(np.array_equal(getattr(patched.png, f), getattr(png, f))
               for f in ("update_src", "update_offsets", "edge_update_idx",
                         "edge_dst", "edge_offsets"))
    same &= patched.blocked is None
    sched = patched._device[("tile_schedule", str(dev))]
    fresh_sched = tile_schedule(png, device=dev)
    same_order = (sched.tile, sched.blocks) == (fresh_sched.tile,
                                                fresh_sched.blocks) and all(
        torch.equal(getattr(sched, f), getattr(fresh_sched, f))
        for f in ("edge_upd", "edge_dst", "chunks", "block_chunks", "hubs"))
    del fresh_sched, png
    log(f"patched plan vs a fresh build_png of g2 "
        f"({t_fresh!r} s on the host, the cost a patch replaces; {card}): "
        f"arrays equal {same}, 'tile' gather order equal {same_order}")
    if not (same and same_order):
        fail("the patched plan is not the fresh build")
    upd, offsets = patched._device[("updates", str(dev))]
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randint(0, 16, (n,), generator=gen, device=dev).float() / 16
    bins = x.index_select(0, upd)
    patched_err = check_b1(bins, None, None, psz, "patched plan d=1",
                           schedule=sched, exact=True, offsets=offsets)
    del bins, x, upd, offsets, sched

    # ------------------------------------------------- 5. serving, delta
    sch = sess.serve(slots=SERVE_SLOTS, chunk=SERVE_CHUNK)
    work = serving_mix(rng, n, SERVE_SLOTS)
    uids = [sch.submit(None if ids is None else seed_vector(n, ids), **kw)
            for _, ids, kw in work]
    sch.step()
    inflight, queued = sch.active_slots, sch.queued
    d3 = local_delta(rng, g2, [pa], DELTA_EDGES, psz)
    t0 = time.perf_counter()
    sch.apply_delta(d3)
    torch.cuda.synchronize()
    t_rebind = time.perf_counter() - t0
    g3 = sch.g
    reset_b1_counts()
    with ChunkCounter() as chunks:
        sch.run_until_drained()
        torch.cuda.synchronize()
    chunk_iters = chunks.iterations
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
    streamed = {"d1": d1, "d2": d2, "g3": g3}
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
    return streamed


# --------------------------------------------------------------- phase 6b
CHAOS_QUERIES, SNAPSHOT_CHUNKS = 32, 3


def serving_mix(rng, n, count):
    """Phase 5's query mix by ``i % 4`` (uniform; one seed, top 10; four
    seeds; uniform top 10), each query at a tolerance it reaches within
    its budget, as phase 6's serving mix: tol 1e-6 in at most 200
    iterations, the single-seed top 10 at tol 1e-3."""
    work = []
    for i in range(count):
        kind = i % 4
        if kind == 0:
            kw = dict(tol=STREAM_TOL)
        elif kind == 1:
            kw = dict(top_k=10, tol=PUSH_TOL)
        elif kind == 2:
            kw = dict(tol=STREAM_TOL)
        else:
            kw = dict(top_k=10, tol=STREAM_TOL)
        ids = ([int(rng.integers(0, n))] if kind == 1 else
               rng.integers(0, n, size=4).tolist() if kind == 2 else None)
        work.append((kind, ids, dict(kw, max_iters=STREAM_ITERATIONS)))
    return work


def result_gap(a, b) -> float:
    """Largest |difference| between two results of one query: their
    ranks, or their top-10 scores (infinite when the ids differ)."""
    if a.ranks is not None:
        return float(np.abs(a.ranks - b.ranks).max())
    if not np.array_equal(a.top_ids, b.top_ids):
        return float("inf")
    return float(np.abs(a.top_scores - b.top_scores).max())


def reliability_phase(dev, card, reuse, streamed, tile_entry,
                      warp_entry) -> None:
    """Phase 6b: the reliability layer at kron-21, on phase 3's graph and
    pcpm_pallas plan (phase 6 moved the session on; its rebinds released
    the plan's uploads, which are made again here). Schedulers of 16
    slots and chunks of 8, every query on the stepper (B1 "warp"), drain
    32 queries in phase 5's seeded mix: twice fault-free, then (a) under
    a fault plan (NaN at step 2, Inf at step 3, a stepper failure at
    step 5) with one stepper retry, (b) the same plan with none; (c) a
    failing and a corrupted ``apply_delta`` of phase 6's first delta;
    (d) a snapshot three chunks in, restored into a fresh scheduler; (e)
    rank checkpoints of a pcpm_pallas solve (B1 "tile"), restarted on the
    same graph and across the first delta. Adds the launch counts and
    times to B1's two entries of the kernels line."""
    import os
    import tempfile
    import torch
    from repro_torch import EngineConfig, open as open_session
    from repro_torch.core.plan import plan_cache_stats
    from repro_torch.core.spmv import SpMVEngine
    from repro_torch.kernels.pcpm_spmv import kernel as b1
    from repro_torch.reliability import (FaultInjector, FaultPlan, FaultSpec,
                                         InjectedFault, ResilienceConfig,
                                         restore_scheduler,
                                         snapshot_scheduler)
    from repro_torch.serve import SlotScheduler
    from repro_torch.stream import GraphDelta
    g, plan0 = reuse["g"], reuse["plan"]
    d1, g3 = streamed["d1"], streamed["g3"]
    n, damping, psz = g.num_nodes, kron().damping, kron().part_size
    tol, budget = STREAM_TOL, STREAM_ITERATIONS
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()

    engine = SpMVEngine(g, plan=plan0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine(torch.zeros((n, SERVE_SLOTS), device=dev))
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    log(f"reliability: phase 3's pcpm_pallas plan from the plan cache, its "
        f"uploads made again (packed streams; the 'tile' gather order built "
        f"anew) with one d={SERVE_SLOTS} SpMV in {t_upload!r} s ({card})")
    work = serving_mix(np.random.default_rng(3), n, CHAOS_QUERIES)

    def scheduler(**kw):
        return SlotScheduler(g, engine=engine, slots=SERVE_SLOTS,
                             chunk=SERVE_CHUNK, route="stepper", **kw)

    def submit_all(sch):
        return [sch.submit(None if ids is None else seed_vector(n, ids), **kw)
                for _, ids, kw in work]

    def drained(sch):
        uids = submit_all(sch)
        sch.run_until_drained()
        return uids

    def run(body):
        """``body()`` with B1's launches by path and the chunks'
        iterations counted from 0: (its value, launches, iterations)."""
        torch.cuda.synchronize()
        reset_b1_counts()
        with ChunkCounter() as chunks:
            out = body()
            torch.cuda.synchronize()
        return out, dict(b1.launch_counts), sum(chunks.iterations)

    def in_order(sch, uids):
        done = {r.uid: r for r in sch.completed}
        return [done[u] for u in uids]

    # ------------------------------------------------- fault-free, twice
    free = []
    for _ in range(2):
        sch = scheduler()
        uids, counts, iters = run(lambda: drained(sch))
        free.append(in_order(sch, uids))
        if counts != {"warp": iters, "tile": 0} or not iters or any(
                r.error or not r.converged for r in free[-1]):
            fail("reliability: a fault-free drain did not converge every "
                 "query through B1 'warp' once per chunk iteration")
    ff = free[0]
    apart = [(i, a.iterations, b.iterations, a.residual, b.residual)
             for i, (a, b) in enumerate(zip(*free))
             if a.iterations != b.iterations]
    twice_gap = max(result_gap(a, b) for a, b in zip(*free))
    log(f"reliability: two fault-free drains of {CHAOS_QUERIES} queries: "
        f"iterations {[r.iterations for r in ff]}, equal in both: "
        f"{not apart}; largest rank gap between them {twice_gap!r}; B1 "
        f"launches by path {counts} (chunk iterations {iters})")
    if apart:
        log(f"reliability: drains apart (index, iterations, iterations, "
            f"residual, residual): {apart}")
        fail("two fault-free drains on the card differ in an iteration "
             "count")

    # ------------------------------------------------- (a), (b) chaos
    specs = [FaultSpec("nan_slot", step=2), FaultSpec("inf_slot", step=3),
             FaultSpec("step_error", step=5)]

    def chaos(max_step_retries):
        inj = FaultInjector(FaultPlan.of(specs))
        sch = scheduler(fault_injector=inj, resilience=ResilienceConfig(
            max_step_retries=max_step_retries))
        hits, failed = [], []
        poisons, check_step = inj.poisons, inj.check_step

        def watched_poisons(step, live):
            # (uid, iterations it has burned once the poisoned chunk ran)
            out = poisons(step, live)
            hits.extend((sch._slot_query[slot].uid,
                         int(sch._iters[slot]) + 1, kind)
                        for slot, kind in out)
            return out

        def watched_check(step):
            flight = {q.uid for q in sch._slot_query if q is not None}
            try:
                check_step(step)
            except InjectedFault:
                failed.append(flight)
                raise

        inj.poisons, inj.check_step = watched_poisons, watched_check
        t0 = time.perf_counter()
        uids, counts, iters = run(lambda: drained(sch))
        return (inj, sch, in_order(sch, uids), uids, counts, iters, hits,
                failed, time.perf_counter() - t0)

    inj, sch, res, uids, counts, iters, hits, _, t_chaos = chaos(1)
    burned = {u: b for u, b, _ in hits}
    want = [f.iterations + burned.get(u, 0) for u, f in zip(uids, ff)]
    chaos_gap = max(result_gap(r, f) for r, f in zip(res, ff))
    c = sch.metrics.counters
    log(f"reliability (a) chaos drain, faults {[s.kind for s in specs]} at "
        f"steps {[s.step for s in specs]}, max_step_retries 1: "
        f"{t_chaos!r} s; poisoned (uid, iterations burned, kind) {hits}; "
        f"fault plan exhausted {inj.exhausted}; quarantined "
        f"{c['quarantined']}, requeued {c['requeued']}, stepper_failures "
        f"{c['stepper_failures']}; all converged without error "
        f"{all(r.converged and not r.error for r in res)}; iterations = the "
        f"fault-free drain's plus those burned: "
        f"{[r.iterations for r in res] == want}; largest rank gap to it "
        f"{chaos_gap!r} (<= 1e-6); trace_count {sch.trace_count}; B1 "
        f"launches by path {counts} (chunk iterations {iters})")
    if not (inj.exhausted and c["quarantined"] == 2
            and c["stepper_failures"] == 1 and len(hits) == 2
            and all(r.converged and not r.error for r in res)
            and [r.iterations for r in res] == want and chaos_gap <= 1e-6
            and sch.trace_count == 1
            and counts == {"warp": iters, "tile": 0} and iters):
        fail("reliability (a): the chaos drain is not the fault-free one")
    chaos_counts = counts

    inj, sch, res, uids, counts, iters, hits, failed, t_hard = chaos(0)
    errs = {u for u, r in zip(uids, res) if r.error}
    kept_gap = max(result_gap(r, f) for r, f in zip(res, ff) if not r.error)
    log(f"reliability (b) the same plan, max_step_retries 0: {t_hard!r} s; "
        f"{len(errs)} queries ended with an error, exactly those in flight "
        f"at the failure: {failed == [errs]}, all 'stepper failure': "
        f"{all('stepper failure' in r.error for r in res if r.error)}; the "
        f"other {len(res) - len(errs)} converged: "
        f"{all(r.converged for r in res if not r.error)}, largest rank gap "
        f"to the fault-free drain {kept_gap!r}; B1 launches by path "
        f"{counts} (chunk iterations {iters})")
    if not (len(errs) == SERVE_SLOTS and failed == [errs]
            and all("stepper failure" in r.error for r in res if r.error)
            and all(r.converged for r in res if not r.error)
            and kept_gap <= 1e-6 and counts == {"warp": iters, "tile": 0}):
        fail("reliability (b): a hard stepper failure did not fail exactly "
             "the in-flight queries")

    # ------------------------------------------------- (c) plan faults
    inj = FaultInjector(FaultPlan.of([FaultSpec("delta_error", step=1),
                                      FaultSpec("corrupt_plan", step=2)]))
    sch = scheduler(fault_injector=inj)
    stats = plan_cache_stats()
    builds0, patches0 = stats.plan_builds, stats.plan_patches
    tries = []
    for expected in (InjectedFault, ValueError):
        t0 = time.perf_counter()
        try:
            sch.apply_delta(d1)
        except expected as exc:
            tries.append((time.perf_counter() - t0, str(exc)))
        else:
            fail("reliability (c): apply_delta did not fail")
    hit = (stats.plan_builds, stats.plan_patches) == (builds0, patches0)
    small = work[:4]

    def old_plan_drain():
        for _, ids, kw in small:
            sch.submit(None if ids is None else seed_vector(n, ids), **kw)
        sch.run_until_drained()

    _, counts, iters = run(old_plan_drain)
    c = sch.metrics.counters
    log(f"reliability (c) plan faults on phase 6's D1: delta_error raised in "
        f"{tries[0][0]!r} s ({tries[0][1]!r}); corrupt_plan refused in "
        f"{tries[1][0]!r} s ({tries[1][1][:80]!r}), the patched plan from "
        f"the plan cache: {hit}; delta_failures {c['delta_failures']}, "
        f"rebind_count {sch.rebind_count}; the old plan drains "
        f"{len(sch.completed)} queries, converged "
        f"{all(r.converged for r in sch.completed)}; B1 launches by path "
        f"{counts} (chunk iterations {iters})")
    if not (c["delta_failures"] == 2 and sch.rebind_count == 0
            and "plan integrity" in tries[1][1] and inj.exhausted
            and sch.engine.plan is plan0 and len(sch.completed) == len(small)
            and all(r.converged for r in sch.completed)
            and counts == {"warp": iters, "tile": 0} and iters):
        fail("reliability (c): a failed delta did not leave the old plan "
             "serving")

    # ------------------------------------------------- (d) snapshot
    sch = scheduler()

    def partial():
        uids = submit_all(sch)
        for _ in range(SNAPSHOT_CHUNKS):
            sch.step()
        return uids

    uids, counts_pre, _ = run(partial)
    before = {r.uid for r in sch.completed}
    flight, queued = sch.active_slots, sch.queued
    path = os.path.join(tmp.name, "scheduler.npz")
    t0 = time.perf_counter()
    snapshot_scheduler(sch, path)
    t_snap = time.perf_counter() - t0
    snap_bytes = os.path.getsize(path)
    kw = dict(engine=engine, slots=SERVE_SLOTS, chunk=SERVE_CHUNK,
              route="stepper")
    t0 = time.perf_counter()
    restored = restore_scheduler(path, g, **kw)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    kept = [q.uid for q in restored._slot_query if q is not None] + [
        q.uid for q in restored._queue]
    _, counts, iters = run(restored.run_until_drained)
    res = [r for r in sch.completed if r.uid in before]
    done = {r.uid: r for r in res + restored.completed}
    res = [done[u] for u in uids]
    snap_gap = max(result_gap(r, f) for r, f in zip(res, ff))
    same_iters = [r.iterations for r in res] == [f.iterations for f in ff]
    later = restored.submit(None, tol=tol, max_iters=1)
    try:
        restore_scheduler(path, g3, **kw)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    log(f"reliability (d) snapshot {SNAPSHOT_CHUNKS} chunks in ({flight} in "
        f"flight, {queued} queued, {len(before)} done): {snap_bytes} B "
        f"written in {t_snap!r} s; restore_scheduler {t_restore!r} s "
        f"({card}); uids kept {sorted(kept) == sorted(set(uids) - before)}, "
        f"the next submit's uid {later} > {max(uids)}; iterations equal to "
        f"the uninterrupted drain's: {same_iters}, largest rank gap "
        f"{snap_gap!r} (<= 1e-6); trace_count "
        f"{restored.trace_count}; refused on phase 6's g3: "
        f"{'fingerprint' in refused}; B1 launches by path before the "
        f"snapshot {counts_pre}, after the restore {counts} (chunk "
        f"iterations {iters})")
    if not (same_iters and snap_gap <= 1e-6 and restored.trace_count == 1
            and sorted(kept) == sorted(set(uids) - before)
            and later > max(uids) and "fingerprint" in refused
            and counts == {"warp": iters, "tile": 0} and iters):
        fail("reliability (d): the restored drain is not the "
             "uninterrupted one")
    del restored, sch

    # ------------------------------------------------- (e) checkpoints
    cfg = EngineConfig(method="pcpm_pallas", part_size=psz)
    sess = open_session(g, cfg, device=dev)
    reset_b1_counts()
    cold = sess.pagerank(num_iterations=budget, tol=tol)
    torch.cuda.synchronize()
    cold_counts = dict(b1.launch_counts)
    ck = os.path.join(tmp.name, "ranks.npz")
    t0 = time.perf_counter()
    sess.save_checkpoint(ck)
    t_save = time.perf_counter() - t0
    fresh = open_session(g, cfg, device=dev)
    t0 = time.perf_counter()
    fresh.load_checkpoint(ck)
    t_load = time.perf_counter() - t0
    reset_b1_counts()
    warm = fresh.pagerank(warm=True, num_iterations=budget, tol=tol)
    torch.cuda.synchronize()
    warm_counts = dict(b1.launch_counts)
    warm_gap = float((warm.ranks - cold.ranks).abs().max())
    log(f"reliability (e) rank checkpoint of a cold pcpm_pallas solve "
        f"({cold.iterations} iterations, plan from the cache: "
        f"{sess.plan is plan0}; B1 launches by path {cold_counts}): "
        f"{os.path.getsize(ck)} B saved in {t_save!r} s, loaded into a "
        f"fresh session in {t_load!r} s ({card}); pagerank(warm=True) "
        f"{warm.iterations} iterations, {len(warm.residuals)} residuals "
        f"(cold {len(cold.residuals)}), L-inf to the cold ranks "
        f"{warm_gap!r} (<= 1e-6); B1 launches by path {warm_counts}")
    if not (cold_counts == {"tile": cold.iterations, "warp": 0}
            and warm.iterations < cold.iterations
            and len(warm.residuals) < len(cold.residuals)
            and warm_gap <= 1e-6):
        fail("reliability (e): the restarted session is not warm")
    restarted = open_session(g, cfg, device=dev)
    t0 = time.perf_counter()
    restarted.apply_delta(d1)
    t_delta = time.perf_counter() - t0
    restarted.load_checkpoint(ck, g_old=g, delta=d1)
    reset_b1_counts()
    t0 = time.perf_counter()
    chain = restarted.pagerank(warm=True, num_iterations=budget, tol=tol)
    torch.cuda.synchronize()
    t_chain = time.perf_counter() - t0
    chain_counts = dict(b1.launch_counts)
    at1, inv1 = card_transpose64(restarted.graph, dev)
    fixed1 = uniform_fixed_point(at1, inv1, damping)
    del at1, inv1
    chain_l1 = float(np.abs(chain.ranks.cpu().numpy().astype(np.float64)
                            - fixed1).sum())
    bound = warm_bound(tol, damping)
    refusals = []
    for kwargs, match in ((dict(), "different graph"),
                          (dict(g_old=g, delta=GraphDelta.insert(
                              np.array([[0, 1]], np.int32))), "delta chain")):
        try:
            restarted.load_checkpoint(ck, **kwargs)
            refusals.append(False)
        except ValueError as exc:
            refusals.append(match in str(exc))
    log(f"reliability (e) restart across D1: apply_delta {t_delta!r} s (the "
        f"patched plan from the plan cache), load_checkpoint(g_old, delta) "
        f"and pagerank(warm=True) {t_chain!r} s: {chain.iterations} sweeps "
        f"(cold {cold.iterations}), L1 vs the float64 fixed point of g + D1 "
        f"{chain_l1!r} (<= {bound!r}); B1 launches by path {chain_counts}; "
        f"wrong lineage refused (no delta, a delta off the chain): "
        f"{refusals} ({card})")
    if not (chain_counts == {"tile": chain.iterations, "warp": 0}
            and 0 < chain.iterations < cold.iterations
            and chain_l1 <= bound and all(refusals)):
        fail("reliability (e): the restart across the delta chain is not a "
             "warm update within its bound")
    tmp.cleanup()
    torch.cuda.synchronize()
    log(f"phase 6b (reliability): {time.perf_counter() - t_phase:.1f} s")
    warp_entry["reliability"] = {
        "chaos_launches": chaos_counts, "snapshot_bytes": snap_bytes,
        "snapshot_s": t_snap, "restore_s": t_restore,
        "reupload_s": t_upload, "plan_fault_s": [t for t, _ in tries]}
    tile_entry["reliability"] = {
        "checkpoint_s": t_save, "load_checkpoint_s": t_load,
        "cold_iterations": cold.iterations,
        "warm_iterations": warm.iterations, "chain_sweeps": chain.iterations,
        "chain_launches": chain_counts, "chain_s": t_chain,
        "chain_l1": chain_l1}


# --------------------------------------------------------------- phase 6c
INGEST_SCALE = 18
# external ids: internal id i -> i * EXT_MULT mod 2**61, sparse 64-bit
# labels (an odd multiplier is a bijection modulo a power of two)
EXT_MULT, EXT_BITS = ID_HASH, 61
OFFSITE_ONE_IN = 20                   # the filter drops dst % 20 == 0


def external_ids(n: int) -> np.ndarray:
    ids = np.arange(n, dtype=np.uint64) * np.uint64(EXT_MULT)
    return (ids & np.uint64((1 << EXT_BITS) - 1)).astype(np.int64)


def write_edge_list(path, g, ext, header, block=1 << 20) -> None:
    """``g``'s edges in external ids, one tab-separated line each."""
    with open(path, "w") as f:
        f.write(header)
        for a in range(0, g.num_edges, block):
            f.write("".join(map("{}\t{}\n".format,
                                ext[g.src[a:a + block]].tolist(),
                                ext[g.dst[a:a + block]].tolist())))


class IngestTimer:
    """Seconds spent parsing (inside ``iter_edge_chunks``), mapping ids
    (``NodeIdMapping.map_chunk``) and deduplicating (``dedup_edges``)
    during one ``ingest_edge_list`` call, by wrapping the three while
    installed."""

    def __init__(self):
        self.seconds = dict.fromkeys(("parse", "id mapping", "dedup"), 0.0)

    def __enter__(self):
        from repro_torch.ingest import NodeIdMapping
        from repro_torch.ingest import pipeline
        sec = self.seconds
        chunks, map_chunk = pipeline.iter_edge_chunks, NodeIdMapping.map_chunk
        dedup = pipeline.dedup_edges

        def timed_chunks(*a, **kw):
            it = chunks(*a, **kw)
            while True:
                t0 = time.perf_counter()
                chunk = next(it, None)
                sec["parse"] += time.perf_counter() - t0
                if chunk is None:
                    return
                yield chunk

        def timed_map(m, ext):
            t0 = time.perf_counter()
            out = map_chunk(m, ext)
            sec["id mapping"] += time.perf_counter() - t0
            return out

        def timed_dedup(s, d):
            t0 = time.perf_counter()
            out = dedup(s, d)
            sec["dedup"] += time.perf_counter() - t0
            return out

        self.saved = [(pipeline, "iter_edge_chunks", chunks),
                      (NodeIdMapping, "map_chunk", map_chunk),
                      (pipeline, "dedup_edges", dedup)]
        pipeline.iter_edge_chunks = timed_chunks
        NodeIdMapping.map_chunk = timed_map
        pipeline.dedup_edges = timed_dedup
        return self

    def __exit__(self, *exc):
        for owner, name, real in self.saved:
            setattr(owner, name, real)


def ingest_phase(dev, card, tile_entry, warp_entry) -> None:
    """Phase 6c: ingest of an edge list with external ids. A kron graph
    (phase 3's generator, a/b/c and seed) at scale 18 — cut from the
    config's 25, past phase 3's 21, because the parser is a per-line
    Python loop — is written as a tab-separated file of ~8.1M lines in
    sparse 64-bit ids under a comment header, then ``ingest_edge_list``
    with an offsite filter (~5% of the edges), self-loops dropped and
    duplicates removed. Its ``IngestStats`` balance, its ``NodeIdMapping``
    survives a save/load, and ``res.open(method="pcpm_pallas")`` solves
    it (B1 "tile" once an iteration) to phase 3's gate against a float64
    scipy oracle of the ingested graph, with top-10 and serving results
    in the file's own ids. Adds the counts and times to B1's entries."""
    import os
    import tempfile
    import torch
    from repro_torch.graphs import generators
    from repro_torch.ingest import LinkFilter, NodeIdMapping, ingest_edge_list
    from repro_torch.kernels.pcpm_spmv import kernel as b1
    cfg = kron()
    damping = cfg.damping
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()

    g = generators.rmat(INGEST_SCALE, cfg.edge_factor, seed=0)
    ext = external_ids(g.num_nodes)
    path = os.path.join(tmp.name, f"kron{INGEST_SCALE}.tsv")
    header = (f"# kron graph, R-MAT a/b/c 0.57/0.19/0.19, seed 0, scale "
              f"{INGEST_SCALE}, edge factor {cfg.edge_factor}\n"
              f"# node ids: dense id * {EXT_MULT:#x} mod 2**{EXT_BITS}\n"
              "# src\tdst\n")
    t0 = time.perf_counter()
    write_edge_list(path, g, ext, header)
    t_write = time.perf_counter() - t0
    file_bytes = os.path.getsize(path)
    offsite = LinkFilter("offsite", lambda s, d: d % OFFSITE_ONE_IN != 0)
    with IngestTimer() as timer:
        t0 = time.perf_counter()
        res = ingest_edge_list(path, filters=[offsite], self_loops="drop",
                               dedup=True)
        t_ingest = time.perf_counter() - t0
    st, sec = res.stats, timer.seconds
    balance = st.edges_read == (st.edges_kept + sum(st.filtered.values())
                                + st.self_loops_removed
                                + st.duplicates_removed)
    log(f"ingest: {g.num_edges} edges of rmat({INGEST_SCALE}, "
        f"{cfg.edge_factor}) written as {file_bytes} B of text (numpy "
        f"{np.__version__}) in "
        f"{t_write!r} s; ingest_edge_list {t_ingest!r} s "
        f"({st.edges_read / t_ingest:.0f} edges/s): parse {sec['parse']!r} "
        f"s, id mapping {sec['id mapping']!r} s, dedup {sec['dedup']!r} s, "
        f"the rest (filter, self-loops, joins) "
        f"{t_ingest - sum(sec.values())!r} s ({card}); {st.summary()}; "
        f"offsite share {st.filtered['offsite'] / st.edges_read:.4f}; "
        f"read = kept + filtered + self-loops + duplicates: {balance}")
    if not (balance and st.edges_read == g.num_edges
            and st.num_nodes == res.graph.num_nodes == res.idmap.num_nodes):
        fail("ingest: the IngestStats do not balance")
    idpath = os.path.join(tmp.name, "idmap.npz")
    t0 = time.perf_counter()
    res.idmap.save(idpath)
    loaded = NodeIdMapping.load(idpath)
    t_idmap = time.perf_counter() - t0
    same_map = np.array_equal(loaded.external_ids, res.idmap.external_ids)
    log(f"ingest: NodeIdMapping of {res.idmap.num_nodes} ids saved "
        f"({os.path.getsize(idpath)} B) and loaded in {t_idmap!r} s: equal "
        f"{same_map}")
    if not same_map:
        fail("ingest: the NodeIdMapping did not survive save/load")
    del g, ext, loaded

    gi = res.graph
    t0 = time.perf_counter()
    sess = res.open(method="pcpm_pallas", part_size=cfg.part_size,
                    device=dev)
    t_plan = time.perf_counter() - t0
    reset_b1_counts()
    t0 = time.perf_counter()
    out = sess.pagerank()
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    solve_counts = dict(b1.launch_counts)
    at = transpose_adjacency(gi)
    oracle = oracle_pagerank(at, gi.out_degree)
    ranks = out.ranks.cpu().numpy()
    ext10, _ = sess.top_ranked(10)
    top = np.lexsort((np.arange(gi.num_nodes), -oracle))[:10]
    want10 = res.idmap.to_external(top)
    log(f"ingest: graph n={gi.num_nodes} m={gi.num_edges}; pcpm_pallas plan "
        f"{t_plan!r} s, solve {out.iterations} iterations {t_solve!r} s "
        f"({card}); B1 launches by path {solve_counts}; top_ranked(10) in "
        f"external ids {ext10.tolist()}, the oracle's: "
        f"{np.array_equal(ext10, want10)}")
    if solve_counts != {"tile": out.iterations, "warp": 0} or \
            out.iterations != cfg.num_iterations:
        fail("ingest: B1 'tile' not launched once per iteration")
    check_against_oracle("ingested pcpm_pallas", ranks,
                         res.idmap.to_internal(ext10), oracle)
    if not np.array_equal(ext10, want10):
        fail("ingest: top_ranked is not the oracle's top 10 in external ids")

    # serving in external ids: a stepper top-k, a push seeded at one id
    sch = sess.serve(slots=SERVE_SLOTS, chunk=SERVE_CHUNK)
    seed_ext = int(res.idmap.external_ids[0])
    seed_int = int(res.idmap.to_internal(np.int64(seed_ext)))
    torch.cuda.synchronize()
    reset_b1_counts()
    with ChunkCounter() as chunks:
        u_step = sch.submit(top_k=10, tol=0.0, max_iters=cfg.num_iterations,
                            route="stepper")
        u_push = sch.submit(seed_vector(gi.num_nodes, [seed_int]), top_k=10,
                            tol=PUSH_TOL, route="push")
        sch.run_until_drained()
        torch.cuda.synchronize()
    chunk_iters = chunks.iterations
    serve_counts = dict(b1.launch_counts)
    done = {r.uid: r for r in sch.completed}
    rs, rp = done[u_step], done[u_push]
    at64 = torch.sparse_csr_tensor(
        torch.from_numpy(at.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(at.indices.astype(np.int64)).to(dev),
        torch.from_numpy(at.data).to(dev), size=at.shape)
    deg = np.asarray(gi.out_degree)
    inv64 = torch.from_numpy(np.where(deg == 0, 0.0, 1.0 / np.maximum(
        deg, 1))).to(dev)
    fixed = personalized_oracle(at64, inv64, [[seed_int]],
                                [FIXED_POINT_ITERATIONS],
                                damping)[:, 0].cpu().numpy()
    del at64, inv64
    push_l1 = float(np.abs(rp.top_scores - fixed[rp.top_ids]).sum())
    push_bound = PUSH_TOL * damping / (1.0 - damping)
    want_tile = rp.iterations + 1
    log(f"ingest serving: stepper top 10 in external ids "
        f"{rs.top_external.tolist()}, the same set as top_ranked: "
        f"{set(rs.top_external.tolist()) == set(want10.tolist())}; push "
        f"seeded at external id {seed_ext}: {rp.iterations} sweeps, top 10 "
        f"{rp.top_external.tolist()}, scores L1 vs the float64 fixed point "
        f"{push_l1!r} (<= {push_bound!r}); B1 launches by path "
        f"{serve_counts} ('warp' = chunk iterations {sum(chunk_iters)}, "
        f"'tile' = push sweeps + seeding {want_tile})")
    ok = (rs.error is None and rp.error is None
          and rs.top_external is not None and rp.top_external is not None
          and set(rs.top_external.tolist()) == set(want10.tolist())
          and np.array_equal(rs.top_external,
                             res.idmap.to_external(rs.top_ids))
          and np.array_equal(rp.top_external,
                             res.idmap.to_external(rp.top_ids))
          and sch.metrics.traces[u_push].route == "push"
          and push_l1 <= push_bound
          and serve_counts == {"warp": sum(chunk_iters), "tile": want_tile})
    if not ok:
        fail("ingest: serving results are not the oracle's in external ids")
    mass = res.virtual_mass(ranks, damping=damping)
    log(f"ingest: virtual mass per category (rank that would leave through "
        f"the filtered links) {mass}")
    if not all(np.isfinite(v) and v > 0 for v in mass.values()):
        fail("ingest: the virtual mass is not finite and positive")
    del sess, sch
    tmp.cleanup()
    torch.cuda.synchronize()
    log(f"phase 6c (ingest): {time.perf_counter() - t_phase:.1f} s")
    tile_entry["ingest"] = {
        "solve_launches": solve_counts, "serve_launches": serve_counts,
        "write_s": t_write, "ingest_s": t_ingest, "stages_s": sec,
        "edges_per_s": st.edges_read / t_ingest, "plan_s": t_plan}
    warp_entry["ingest"] = {"serve_launches": serve_counts}


# --------------------------------------------------------------- phase 7
GATEWAY_SUBMITTERS, GATEWAY_PER_THREAD = 4, 32
GATEWAY_REPEATS, DELTA_STORM, LATENCY_PUSHES = 32, 32, 8
GATEWAY_CANDIDATES = (2, 4, 8, 16, 32, 64)
GATEWAY_TARGET_S, GATEWAY_PUSH_WORKERS, GATEWAY_CACHE = 0.025, 2, 1024
QPS_ROUNDS = 16                       # (off, on) pairs, order alternating


def prometheus_families(text: str) -> dict:
    """Parse Prometheus text exposition: {family: type}, failing on a line
    that is neither a ``# HELP``/``# TYPE`` comment nor a sample
    ``name{label="value",...} number`` of a family with a ``# TYPE``."""
    types = {}
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
                        r'(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*",?)*\})?'
                        r' (\S+)$')
    for line in text.splitlines():
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            if kind not in ("counter", "gauge", "histogram"):
                fail(f"metrics endpoint: unknown type in {line!r}")
            types[name] = kind
            continue
        found = sample.match(line)
        if not found:
            fail(f"metrics endpoint: not Prometheus text: {line!r}")
        float(found.group(5))
        name = found.group(1)
        family = next((f for f in (name, name.rsplit("_", 1)[0])
                       if f in types), None)
        if family is None:
            fail(f"metrics endpoint: sample {name!r} without a # TYPE")
    return types


def span_trees(obs, uids) -> int:
    """Check one complete, well-nested span tree per uid in the flight
    recorder: one ``query`` root, exactly one ``terminal`` and one
    ``resolve`` event, every other record a child inside the root's
    interval. Returns the records checked."""
    by = {}
    for r in obs.recorder.snapshot():
        by.setdefault(r.trace, []).append(r)
    checked = 0
    for uid in uids:
        recs = by.get(uid, [])
        names = [r.name for r in recs]
        if not (names.count("query") == names.count("terminal")
                == names.count("resolve") == 1):
            fail(f"span tree of uid {uid}: {names}")
        root = next(r for r in recs if r.name == "query")
        for r in recs:
            if r is not root and not (
                    r.parent_id is not None
                    and root.t_start <= r.t_start <= r.t_end <= root.t_end):
                fail(f"span tree of uid {uid}: {r!r} not inside {root!r}")
        checked += len(recs)
    return checked


def gateway_storm(gw, work, n, *, threads=GATEWAY_SUBMITTERS, **kw):
    """``work`` (phase 5's mix, ``serving_mix``) submitted to ``gw`` from
    ``threads`` threads, thread t taking every ``threads``-th request;
    waits for every future. Returns (results in work order, seconds)."""
    import threading
    results = [None] * len(work)
    errors = []

    def submitter(t):
        try:
            futs = [(i, gw.submit(None if work[i][1] is None
                                  else seed_vector(n, work[i][1]),
                                  **work[i][2], **kw))
                    for i in range(t, len(work), threads)]
            for i, f in futs:
                results[i] = f.result(timeout=600)
        except Exception as exc:      # noqa: BLE001 — reported below
            errors.append(exc)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=submitter, args=(t,))
          for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    seconds = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in ts):
        fail(f"gateway storm: a submitter failed or hung: {errors}")
    return results, seconds


def audit(sch, results) -> None:
    """Every future resolved exactly once to a distinct uid whose trace
    is terminal and agrees with the result, error-free."""
    uids = [r.uid for r in results]
    if len(set(uids)) != len(uids):
        fail("gateway: a uid was delivered twice")
    for r in results:
        tr = sch.metrics.traces[r.uid]
        if (tr.t_done is None or tr.converged != r.converged
                or tr.error != r.error or r.error is not None
                or not r.converged):
            fail(f"gateway: uid {r.uid} ended as {r.error!r}, converged "
                 f"{r.converged}, trace {tr}")


def mix_gaps(work, results, at64, inv64, damping) -> dict:
    """Phase 5's gates for converged results of ``serving_mix``: stepper
    answers against a float64 power iteration from the same seed at their
    own iteration counts (ranks L1; uniform top 10: the same ids and
    scores L1), push answers' top-10 scores against the float64 fixed
    point. Returns the largest gap per kind."""
    n = at64.shape[0]
    gaps = dict.fromkeys(range(4), 0.0)
    # one oracle column per distinct (seed, iterations): the uniform
    # requests repeat; batches of 32 (n, 32) float64 columns sorted by
    # their iteration counts
    columns = {}
    for i, ((kind, ids, _), r) in enumerate(zip(work, results)):
        count = FIXED_POINT_ITERATIONS if kind == 1 else r.iterations
        key = (None if ids is None else tuple(ids), count)
        columns.setdefault(key, []).append(i)
    keys = sorted(columns, key=lambda c: c[1])
    for lo in range(0, len(keys), 32):
        batch = keys[lo:lo + 32]
        want = personalized_oracle(
            at64, inv64, [np.arange(n) if ids is None else list(ids)
                          for ids, _ in batch],
            [count for _, count in batch], damping).cpu().numpy()
        for j, key in enumerate(batch):
            for i in columns[key]:
                (kind, _, _), r = work[i], results[i]
                col = want[:, j]
                if r.ranks is not None:
                    gap = float(np.abs(r.ranks.astype(np.float64)
                                       - col).sum())
                else:
                    top = np.lexsort((np.arange(n), -col))[:10]
                    if kind == 3 and not np.array_equal(r.top_ids, top):
                        fail(f"gateway uid {r.uid}: top-10 ids differ from "
                             "the float64 oracle's")
                    gap = float(np.abs(r.top_scores
                                       - col[r.top_ids]).sum())
                gaps[kind] = max(gaps[kind], gap)
        del want
    return gaps


def check_mix_gaps(label, work, gaps, damping) -> None:
    bound = PUSH_TOL * damping / (1.0 - damping)
    kinds = {kind for kind, _, _ in work}
    said = [f"{what} {gaps[kind]!r}" for kind, what in (
        (0, "uniform L1"), (3, "uniform top-10 scores L1"),
        (2, "seeded L1")) if kind in kinds]
    log(f"{label} vs float64: {', '.join(said)} (each at its own "
        f"iterations, <= 1e-5); push top-10 scores L1 {gaps[1]!r} vs the "
        f"fixed point (<= tol*d/(1-d) = {bound!r})")
    if max(gaps[0], gaps[2], gaps[3]) > 1e-5 or gaps[1] > bound:
        fail(f"{label} disagrees with the float64 oracle")


def route_latencies(obs, sch, results) -> dict:
    """Client-side latency (the gateway-owned root span: intake to the
    future's resolution) in ms, p50 and p99 by route."""
    roots = {r.trace: r.duration_s for r in obs.recorder.snapshot()
             if r.name == "query"}
    out = {}
    for route in ("stepper", "push"):
        ms = [roots[r.uid] * 1e3 for r in results
              if (sch.metrics.traces[r.uid].route or "stepper") == route]
        out[route] = (float(np.percentile(ms, 50)),
                      float(np.percentile(ms, 99)), len(ms))
    return out


class GcPauses:
    """While installed, the garbage collector's passes (``gc.callbacks``):
    ``seconds`` paused in all, and ``full`` passes of the oldest
    generation."""

    def __enter__(self):
        import gc
        self.seconds, self.full, self._t0 = 0.0, 0, None
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.full += info["generation"] == 2
            self._t0 = None

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._callback)


def observability_cost(sess, width, work, n, *, collect=True,
                       idle_wait_s=None, instances=1):
    """Queries/s of ``work`` (phase 5's mix) through a cache-less gateway
    over ``sess``'s plan at ``width`` slots with ``sess``'s observability
    switched off and on between storms (the gateway's and its
    scheduler's ``obs``, which every hook reads as it runs): a warm-up
    storm each way (the push workers' engines, the pool's pages), then
    ``QPS_ROUNDS`` pairs in the order off on on off .... A side's
    queries/s is its queries over the seconds of all its storms. One
    gateway serves both sides because two gateways built alike can
    differ by up to ≈ 20% in every storm for as long as they live; with
    ``instances=2`` each side has one of its own, as the JAX package's
    ``test_observed_storm_qps_within_5pct`` compares two schedulers.
    Single storms spread by ≈ 7% on the host, so the 5% bound needs many
    storms a side, and a best-of-few reads the spread's tails. Unless
    ``collect`` is False each storm starts after a full ``gc.collect()``,
    as that test does: garbage left by earlier work is not this storm's
    overhead. ``idle_wait_s`` replaces the gateways' idle poll
    (``GatewayConfig.idle_wait_s``). Returns the queries/s a side; the
    best single storm a side; every run as (side, queries/s, ms of GC
    pauses within it, full GC passes within it, s from its start to the
    last push answered, to the last stepper answer); and the objects the
    collector tracks after the last storm."""
    import gc
    from repro_torch.gateway import Gateway, GatewayConfig
    nocache = GatewayConfig(push_workers=GATEWAY_PUSH_WORKERS,
                            cache_entries=0)
    if idle_wait_s is not None:
        nocache = dataclasses.replace(nocache, idle_wait_s=idle_wait_s)
    on = Gateway(sess.serve(slots=width), config=nocache)
    obs = on.obs
    gws = {"on": on, "off": on if instances == 1 else Gateway(
        sess.serve(slots=width, obs=None), config=nocache)}

    def switch(key):
        gw = gws[key]
        gw.obs = gw._schedulers["default"].obs = \
            obs if key == "on" else None

    for key in gws:
        switch(key)
        gateway_storm(gws[key], work, n)
    seconds = {"off": 0.0, "on": 0.0}
    best = {"off": 0.0, "on": 0.0}
    runs = []
    for i in range(QPS_ROUNDS):
        for key in (("off", "on") if i % 2 == 0 else ("on", "off")):
            switch(key)
            if collect:
                gc.collect()
            sch = gws[key]._schedulers["default"]
            t0 = sch.clock()
            with GcPauses() as pauses:
                results, sec = gateway_storm(gws[key], work, n)
            ends = {"push": 0.0, "stepper": 0.0}
            for r in results:
                tr = sch.metrics.traces[r.uid]
                route = "push" if tr.route == "push" else "stepper"
                ends[route] = max(ends[route], tr.t_done - t0)
            runs.append((key, len(work) / sec, pauses.seconds * 1e3,
                         pauses.full, ends["push"], ends["stepper"]))
            seconds[key] += sec
            best[key] = max(best[key], len(work) / sec)
    for gw in {id(g): g for g in gws.values()}.values():
        gw.close()
    rate = {key: QPS_ROUNDS * len(work) / sec for key, sec in seconds.items()}
    return rate, best, runs, len(gc.get_objects())


def gateway_phase(dev, card, reuse, streamed, tile_entry,
                  warp_entry) -> None:
    """Phase 7: the async front door and observability at kron-21, on
    phase 3's graph and pcpm_pallas plan. An observed session's
    ``gateway()`` (autotune to a 25 ms chunk over B in 2-64, chunks of 8,
    2 push workers, 1,024 cached results); B1 "warp" at the chosen width
    against its plain version on the plan's tensors; a storm of 4
    submitter threads x 32 queries in phase 5's mix, then 32 repeats
    (every future once, phase 5's accuracy gates, bit-identical hits, B1
    "warp" once per chunk iteration and "tile" once per push sweep and
    seeding); a NaN injected through phase 6b's fault plan (a crash dump);
    queries/s with observability off and on; inline push latency with
    the stepper idle and loaded; phase 6's D2 applied through the gateway
    under a second storm (the cache invalidated at the commit); span
    trees, the metrics endpoint and measured comm. Adds a ``gateway``
    dict to B1's two entries of the kernels line."""
    import tempfile
    import threading
    import torch
    from repro_torch import EngineConfig, open as open_session
    from repro_torch.core.plan import PlanConfig, build_plan
    from repro_torch.gateway import Gateway, GatewayConfig
    from repro_torch.kernels.pcpm_spmv import (kernel as b1, pcpm_spmv_cuda,
                                               pcpm_spmv_ref)
    from repro_torch.obs import vs_model
    from repro_torch.reliability import (FaultInjector, FaultPlan, FaultSpec,
                                         ResilienceConfig)
    g, plan0, at_dev = reuse["g"], reuse["plan"], reuse["at_dev"]
    d2 = streamed["d2"]
    n, damping, psz = g.num_nodes, kron().damping, kron().part_size
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()

    # ------------------------------------------------- 1. the front door
    sess = open_session(g, EngineConfig(method="pcpm_pallas", part_size=psz,
                                        chunk=SERVE_CHUNK), device=dev)
    if sess.plan is not plan0:
        fail("gateway: phase 3's pcpm_pallas plan is not in the plan cache")
    obs = sess.observe(capacity=1 << 17, dump_dir=tmp.name)
    cfg = GatewayConfig(push_workers=GATEWAY_PUSH_WORKERS,
                        cache_entries=GATEWAY_CACHE,
                        target_chunk_s=GATEWAY_TARGET_S,
                        autotune_candidates=GATEWAY_CANDIDATES)
    t0 = time.perf_counter()
    gw = sess.gateway(config=cfg)
    t_tune = time.perf_counter() - t0
    rep = gw.autotune_report
    sch = gw._schedulers["default"]
    width = rep.chosen
    log(f"gateway autotune (target {GATEWAY_TARGET_S * 1e3:g} ms a chunk of "
        f"{SERVE_CHUNK}, B in {GATEWAY_CANDIDATES}): chunk ms by B "
        f"{ {b: t * 1e3 for b, t in rep.probes.items()} }; chosen B "
        f"{width}; {t_tune:.2f} s with the scheduler's build ({card})")
    if width not in GATEWAY_CANDIDATES or sch.slots != width or \
            sch.trace_count != 1:
        fail("gateway: the autotuned width is not the scheduler's")

    # B1 "warp" at the chosen width, fused, on the plan's own tensors
    packed = plan0._device[("packed", str(dev))]
    k, u = packed.update_src.shape
    gen = torch.Generator(device=dev).manual_seed(7)
    xb = torch.randint(0, 16, (n, width), generator=gen,
                       device=dev).float() / 16
    err = check_b1(xb, packed.edge_upd, packed.edge_dst, psz,
                   f"gateway width d={width}", exact=True,
                   update_src=packed.update_src)
    args = (xb, packed.update_src, packed.edge_upd, packed.edge_dst)
    ms = time_ms(lambda: pcpm_spmv_cuda(*args, part_size=psz), reps=10,
                 warmup=2)
    plain_ms = time_ms(lambda: pcpm_spmv_ref(*args, part_size=psz), reps=2,
                       warmup=1)
    library_ms = time_ms(lambda: at_dev @ xb, reps=3, warmup=1)
    edges = int(((packed.edge_upd < u) & (packed.edge_dst < psz)).sum())
    bytes_moved = (8 * edges + 4 * plan0.png.num_updates + 4 * width * n
                   + 4 * width * k * psz)
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = width * edges / PEAK_F32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"B1 'warp' fused at the gateway's width (d={width}): {ms!r} ms; "
        f"bound {bound_ms!r} ms ({bytes_moved} B: x and update_src read "
        f"once); plain version {plain_ms!r} ms; torch.sparse CSR product "
        f"with A^T (n, {width}) {library_ms!r} ms ({card})")
    del xb, args

    # ------------------------------------------------- 2. the storm
    work = serving_mix(np.random.default_rng(3), n,
                       GATEWAY_SUBMITTERS * GATEWAY_PER_THREAD)
    torch.cuda.synchronize()
    reset_b1_counts()
    with ChunkCounter() as chunks:
        results, storm_s = gateway_storm(gw, work, n)
        # 32 exact repeats of requests answered once in the storm (the
        # seeded ones: a uniform request repeats within the mix itself)
        again = [i for i, (kind, _, _) in enumerate(work)
                 if kind in (1, 2)][:GATEWAY_REPEATS]
        rep_results, rep_s = gateway_storm(gw, [work[i] for i in again], n)
        torch.cuda.synchronize()
    storm_counts = dict(b1.launch_counts)
    audit(sch, results + rep_results)
    sch.metrics.reconcile()
    routes = [sch.metrics.traces[r.uid].route for r in results]
    pushed = [r for r, route in zip(results, routes) if route == "push"]
    fallbacks = sch.metrics.counters["push_fallbacks"]
    want_tile = (sum(r.iterations + 1 for r in pushed)
                 + fallbacks * (sch.push_max_sweeps + 1))
    hits = [r for r in results if r.cached]
    identical = all(
        r.cached and (r.ranks is results[i].ranks if r.ranks is not None
                      else r.top_scores is results[i].top_scores
                      and r.top_ids is results[i].top_ids)
        for r, i in zip(rep_results, again))
    lat = route_latencies(obs, sch, results)
    log(f"gateway storm: {len(work)} queries from {GATEWAY_SUBMITTERS} "
        f"threads in {storm_s:.3f} s, {len(work) / storm_s!r} queries/s; "
        f"client latency p50/p99 ms: stepper {lat['stepper'][0]!r}/"
        f"{lat['stepper'][1]!r} ({lat['stepper'][2]} queries), push "
        f"{lat['push'][0]!r}/{lat['push'][1]!r} ({lat['push'][2]}); "
        f"{len(hits)} served from the cache within the storm ({card})")
    log(f"gateway repeats: {len(rep_results)} in {rep_s * 1e3:.2f} ms, all "
        f"cache hits bit-identical to their first answers: {identical}; "
        f"trace_count {sch.trace_count}; every future once with a distinct "
        f"uid: True; B1 launches by path {storm_counts} ('warp' = chunk "
        f"iterations {sum(chunks.iterations)}: "
        f"{storm_counts['warp'] == sum(chunks.iterations)}; 'tile' = push "
        f"sweeps + seedings {want_tile}: {storm_counts['tile'] == want_tile})")
    if not identical or sch.trace_count != 1:
        fail("gateway: a repeat was not a bit-identical cache hit, or the "
             "stepper was built again")
    if storm_counts != {"warp": sum(chunks.iterations), "tile": want_tile} \
            or not chunks.iterations:
        fail("gateway: B1 launches differ from the chunks' iterations and "
             "the push sweeps")
    if [route == "push" for route in routes] != [k == 1 for k, _, _
                                                  in work]:
        fail("gateway: the single-seed top-k queries were not all pushed")
    at64, inv64 = card_transpose64(g, dev)
    check_mix_gaps("gateway storm", work, mix_gaps(work, results, at64,
                                                   inv64, damping), damping)
    del at64, inv64

    # ------------------------------------------------- 3. a crash dump
    inj = FaultInjector(FaultPlan.of([FaultSpec("nan_slot", step=2)]))
    faulty = sess.serve(slots=2, route="stepper", fault_injector=inj,
                        resilience=ResilienceConfig(max_retries=0))
    with Gateway(faulty, config=GatewayConfig(cache_entries=0)) as fgw:
        # a fixed budget: the query is still in its slot at step 2
        lost = fgw.submit(None, tol=0.0,
                          max_iters=STREAM_ITERATIONS).result(timeout=600)
    dumps = sorted(Path(tmp.name).glob("flight-*.jsonl"))
    rows = [json.loads(ln) for ln in dumps[0].read_text().splitlines()] \
        if dumps else [{}]
    log(f"gateway crash dump: a NaN at step 2 through phase 6b's fault plan "
        f"(max_retries 0): the future resolved with {lost.error!r}; "
        f"{[p.name for p in dumps]} holding {len(rows) - 1} records (schema "
        f"{rows[0].get('schema')}, crash_dump event "
        f"{any(r.get('name') == 'crash_dump' for r in rows[1:])}); "
        f"crash_dumps_total "
        f"{obs.registry.counter_value('crash_dumps_total')}")
    if not (inj.exhausted and lost.error and "quarantined" in lost.error
            and len(dumps) == 1 and rows[0].get("schema") == 1
            and any(r.get("name") == "crash_dump" for r in rows[1:])):
        fail("gateway: the injected NaN did not leave a flight-recorder dump")
    del faulty

    # ------------------------------------------------- 4. observability cost
    qps, best, runs, live = observability_cost(sess, width, work, n)
    log(f"gateway observability cost: queries/s of the storm through one "
        f"gateway without the cache, its observability switched off and on "
        f"between storms, over {QPS_ROUNDS} storms a side after a warm-up "
        f"storm each, in the order off on on off ..., each after a full "
        f"gc.collect() ({live} objects tracked): off {qps['off']!r}, on "
        f"{qps['on']!r} (ratio {qps['on'] / qps['off']!r}, >= 0.95); "
        f"best single storm off {best['off']!r}, on {best['on']!r}; runs "
        f"in order (side, queries/s, ms of GC pauses in the storm, full "
        f"passes in it, s to its last push answer, to its last stepper "
        f"answer) {runs} ({card})")
    if qps["on"] < 0.95 * qps["off"]:
        fail("gateway: observability costs more than 5% of queries/s")

    # ------------------------------------------------- 5. push latency
    pushes = [seed_vector(n, [int(i)]) for i in
              np.random.default_rng(11).integers(0, n, LATENCY_PUSHES)]

    def push_ms():
        out = []
        for s in pushes:
            t0 = time.perf_counter()
            r = gw.submit(s, top_k=10, tol=PUSH_TOL,
                          use_cache=False).result(timeout=600)
            out.append((time.perf_counter() - t0) * 1e3)
            if r.error or not r.converged:
                fail(f"gateway push latency: {r.error!r}")
        return out

    idle = push_ms()
    load = [gw.submit(None, tol=0.0, max_iters=STREAM_ITERATIONS,
                      use_cache=False) for _ in range(2 * width)]
    time.sleep(0.5)                           # the stepper is under way
    busy = sch.active_slots
    loaded = push_ms()
    for f in load:
        if f.result(timeout=600).error:
            fail("gateway push latency: the stepper load failed")
    log(f"gateway inline push latency ({LATENCY_PUSHES} pushes one at a "
        f"time, top 10 at tol {PUSH_TOL}): stepper idle p50 "
        f"{float(np.median(idle))!r} ms, max {max(idle)!r} ms; stepper "
        f"loaded ({busy} of {width} slots busy, {2 * width} fixed-budget "
        f"queries) p50 {float(np.median(loaded))!r} ms, max "
        f"{max(loaded)!r} ms ({card})")

    # ------------------------------------------------- 6. a delta, live
    old_fp = sch.engine.plan.graph_fp
    storm2 = serving_mix(np.random.default_rng(4), n, DELTA_STORM)
    out2 = {}
    t0 = time.perf_counter()
    storm_thread = threading.Thread(target=lambda: out2.update(zip(
        ("results", "s"), gateway_storm(gw, storm2, n, threads=2))))
    storm_thread.start()
    time.sleep(0.05)                          # the storm is in flight
    dropped = gw.apply_delta(d2).result(timeout=900)
    t_delta = time.perf_counter() - t0
    storm_thread.join(timeout=900)
    if storm_thread.is_alive() or "results" not in out2:
        fail("gateway: the storm across the delta did not finish")
    after = [gw.submit(None if work[i][1] is None
                       else seed_vector(n, work[i][1]),
                       **work[i][2]).result(timeout=600) for i in again]
    audit(sch, out2["results"] + after)
    new_fp = sch.engine.plan.graph_fp
    log(f"gateway apply_delta(D2: {d2.num_added} + {d2.num_removed} edges) "
        f"under a storm of {DELTA_STORM}: committed after {t_delta:.2f} s; "
        f"rebind_count {sch.rebind_count}, trace_count {sch.trace_count}; "
        f"the cache dropped {dropped} entries at the commit; "
        f"the {len(after)} repeats after it: cache hits "
        f"{sum(r.cached for r in after)} (0: solved on the new "
        f"fingerprint ...{new_fp[-12:]}, not served from "
        f"...{old_fp[-12:]}) ({card})")
    if not (sch.rebind_count == 1 and sch.trace_count == 2
            and dropped >= len(again) and new_fp != old_fp
            and not any(r.cached for r in after)):
        fail("gateway: the delta's commit did not invalidate the cache")
    g2 = sch.g
    at2, inv2 = card_transpose64(g2, dev)
    repeated = [work[i] for i in again]
    check_mix_gaps("gateway repeats after D2 (g + D2)", repeated,
                   mix_gaps(repeated, after, at2, inv2, damping), damping)
    del at2, inv2

    # ------------------------------------------------- 7. observability
    every = results + rep_results + out2["results"] + after
    records = span_trees(obs, [r.uid for r in every])
    text = gw.metrics_endpoint()
    families = prometheus_families(text)
    gw.close()
    pcpm_plan = build_plan(g, PlanConfig(method="pcpm", part_size=psz))
    cmp_ = vs_model(pcpm_plan)
    log(f"gateway span trees: {len(every)} queries, {records} records, one "
        f"root, terminal and resolve each, well nested: True; flight "
        f"recorder held {len(obs.recorder)} of {obs.recorder.recorded} "
        f"(dropped {obs.recorder.dropped}); metrics endpoint "
        f"{len(text)} B, {len(families)} families, Prometheus text: True; "
        f"comm of the gateway's pcpm_pallas plan: "
        f"{obs.comm.summary() or 'not accounted (as in the JAX package)'}")
    log(f"measure_plan of the kron-{SCALE} pcpm plan: "
        f"{cmp_['measured_bytes_per_iter']} B/iteration against eq. 5's "
        f"{cmp_['model_bytes_per_iter']!r} B: ratio {cmp_['ratio']!r} "
        f"(within 2x: {0.5 <= cmp_['ratio'] <= 2.0})")
    if obs.recorder.dropped or not 0.5 <= cmp_["ratio"] <= 2.0:
        fail("gateway: the flight recorder dropped records, or measure_plan "
             "is not within 2x of eq. 5")
    phase_counts = dict(b1.launch_counts)
    obs.close()
    tmp.cleanup()
    torch.cuda.synchronize()
    log(f"gateway B1 launches by path in the phase after the storm's "
        f"counters were reset: {phase_counts}; phase 7 (gateway): "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")
    shared = {"width": width, "probes_ms": rep.summary()["probes_ms"],
              "storm_launches": storm_counts,
              "queries_per_s": len(work) / storm_s,
              "latency_ms": lat, "qps_off_on": qps,
              "push_latency_ms": {"idle": idle, "loaded": loaded},
              "delta_s": t_delta}
    tile_entry["gateway"] = shared
    warp_entry["gateway"] = {**shared, "ms_at_width": ms,
                             "plain_ms_at_width": plain_ms,
                             "bound_ms_at_width": bound_ms,
                             "library_ms_at_width": library_ms,
                             "max_abs_err_at_width": err}


# -------------------------------------------------------------- phase 7b
WIRE_SHARDS = 8                       # the JAX package's dist_wire layout
# a stop one iteration apart between two engines is a rounding stop when
# the earlier one's last L1 residual lies this close under tol: the L1
# sum of rank differences near convergence cancels, and two summation
# orders read it a few parts in a thousand apart
ROUNDING_BAND = 0.02


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def same_stop(it_a, res_a, it_b, res_b, tol) -> bool:
    """Equal iteration counts, or one apart where the earlier stop's
    residual is a rounding stop (within ``ROUNDING_BAND`` under tol)."""
    if it_a == it_b:
        return True
    early = res_a if it_a < it_b else res_b
    return (abs(it_a - it_b) == 1 and early is not None
            and (1 - ROUNDING_BAND) * tol <= early < tol)


class OneRankGroup:
    """A one-rank NCCL process group on ``dev`` (``tcp://127.0.0.1`` on a
    free port, rank 0, world 1), torn down on exit."""

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        import datetime
        import torch
        import torch.distributed as dist
        torch.cuda.set_device(self.dev.index or 0)
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300))
        return dist

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()


def sharded_phase(dev, card, reuse) -> None:
    """Phase 7b: the sharded path at world size 1 on phase 3's graph,
    through a one-rank NCCL group: ``open(g, EngineConfig(method=
    "pcpm_sharded", num_shards=1))`` against phase 3's oracle gate and
    its pcpm and pcpm_pallas ranks, one ``all_to_all_single`` per
    iteration by the mesh's counter, the tol run's iterations against
    pcpm's; ms per iteration beside pcpm's, the host seconds of
    ``build_sharded_png`` and the bytes it uploads; a sharded
    ``SlotScheduler`` draining 16 queries of phase 5's mix against an
    unsharded pcpm one; a sharded ``PageRankServer`` query; the wire
    accounting of the JAX package's 8-shard layout of the same graph."""
    import torch
    from repro_torch import EngineConfig, open as open_session
    from repro_torch.core import distributed as shd
    from repro_torch.core.plan import PlanConfig, build_plan, release_device
    from repro_torch.serve import PageRankServer, SlotScheduler
    t_phase = time.perf_counter()
    cfg = kron()
    g, oracle, ranks = reuse["g"], reuse["oracle"], reuse["ranks"]
    pcpm_sess = reuse["pcpm_sess"]
    psz, iterations = cfg.part_size, cfg.num_iterations
    with OneRankGroup(dev) as dist:
        backend = dist.get_backend()
        log(f"sharded: process group {backend!r}, world size "
            f"{dist.get_world_size()}, rank {dist.get_rank()}, {dev}")
        if backend != "nccl":
            fail(f"sharded: the group's backend is {backend!r}, not nccl")
        t0 = time.perf_counter()
        plan = build_plan(g, PlanConfig(method="pcpm_sharded",
                                        part_size=psz, num_shards=1))
        t_build = time.perf_counter() - t0
        lay = plan.sharded
        sess = open_session(g, EngineConfig(
            method="pcpm_sharded", part_size=psz, num_shards=1,
            num_iterations=iterations), device=dev)
        mesh = sess.engine.mesh
        if sess.plan is not plan or mesh.group is None:
            fail("sharded: the session has another plan, or no group")
        before = dict(mesh.counts)
        res = sess.pagerank()
        torch.cuda.synchronize()
        calls = {k: v - before.get(k, 0) for k, v in mesh.counts.items()}
        log(f"sharded layout: num_shards 1, shard_size {lay.shard_size}, U "
            f"{lay.send_ids.shape[2]}, E {lay.edge_upd.shape[1]}, gather "
            f"pieces {lay.piece_start.shape[1]}; host build_sharded_png "
            f"(through build_plan) {t_build:.1f} s; device bytes of its "
            f"uploads {shd._shard_streams(lay, mesh).nbytes} (send ids, "
            f"the blocked schedule and the row mask)")
        log(f"sharded main path: {res.iterations} iterations, collectives "
            f"{calls}")
        if not calls.get("all_to_all_single") == res.iterations \
                == iterations:
            fail("sharded: not one NCCL all_to_all_single per iteration")
        got = res.ranks.cpu().numpy()
        check_against_oracle("pcpm_sharded", got,
                             sess.top_ranked(10)[0], oracle)
        gaps = {m: float(np.abs(got - r).max()) for m, r in ranks.items()}
        log(f"sharded vs phase 3: L-inf {gaps} (<= 1e-6)")
        if max(gaps.values()) > 1e-6:
            fail("sharded ranks differ from pcpm / pcpm_pallas")
        tol_kw = dict(tol=1e-6, check_every=1, num_iterations=200)
        res_t = sess.pagerank(**tol_kw)
        ref_t = pcpm_sess.pagerank(**tol_kw)
        ok = same_stop(res_t.iterations, res_t.residuals[-1],
                       ref_t.iterations, ref_t.residuals[-1], 1e-6)
        log(f"sharded tol=1e-6 check_every=1: {res_t.iterations} "
            f"iterations (last residual {res_t.residuals[-1]!r}), pcpm "
            f"{ref_t.iterations} ({ref_t.residuals[-1]!r}): same stop {ok}")
        if not ok:
            fail("sharded: the tol run stopped apart from pcpm")
        # ms per iteration by CUDA events, beside pcpm's (as the JAX
        # package's benchmarks/sharded_loop.py compares them)
        ms = time_ms(sess.pagerank, reps=3, warmup=1) / iterations
        pcpm_ms = time_ms(pcpm_sess.pagerank, reps=3, warmup=1) / iterations
        log(f"time pcpm_sharded (1 shard, NCCL): {ms!r} ms/iteration; "
            f"pcpm {pcpm_ms!r} ms/iteration; ratio {ms / pcpm_ms!r} "
            f"({card})")
        sharded_serving(dev, g, oracle, ranks, psz, iterations,
                        PageRankServer, SlotScheduler)
        # the plan's uploads and its mesh go with the group
        release_device(plan)
    t0 = time.perf_counter()
    lay8 = shd.build_sharded_png(g, WIRE_SHARDS)
    t_wire = time.perf_counter() - t0
    u8 = lay8.send_ids.shape[2]
    log(f"sharded wire ({WIRE_SHARDS}-shard layout of the kron-{SCALE} "
        f"graph, host only, as benchmarks/dist_wire.py): build "
        f"{t_wire:.1f} s; wire_updates {lay8.wire_updates}, wire_edges "
        f"{lay8.wire_edges}, r_wire {lay8.wire_compression!r}; PCPM wire "
        f"bytes {4 * lay8.wire_updates} (4 B an update) against edge-cut "
        f"{8 * lay8.wire_edges} (a value and a destination id an edge); "
        f"padded all-to-all {4 * WIRE_SHARDS ** 2 * u8} B (4 x S^2 x U, "
        f"U = {u8})")
    if not lay8.wire_updates <= lay8.wire_edges:
        fail("sharded wire: more updates than cross-shard edges")
    log(f"phase 7b (sharded): {time.perf_counter() - t_phase:.1f} s "
        f"({card})")


def sharded_serving(dev, g, oracle, ranks, psz, iterations,
                    PageRankServer, SlotScheduler) -> None:
    """Phase 7b's serving: a sharded ``SlotScheduler(slots=16, chunk=8)``
    drains 16 queries of phase 5's mix (none pushed: a sharded pool has
    no push route) against an unsharded pcpm scheduler on the stepper
    route — ranks within 1e-6, the same stops; then one sharded
    ``PageRankServer`` query."""
    import torch
    work = serving_mix(np.random.default_rng(3), g.num_nodes, 16)
    out = {}
    for name, kw in (("sharded", dict(sharded=True)),
                     ("pcpm", dict(method="pcpm", route="stepper"))):
        sch = SlotScheduler(g, slots=16, chunk=8, part_size=psz, device=dev,
                            **kw)
        uids = [sch.submit(None if ids is None
                           else seed_vector(g.num_nodes, ids), **q)
                for _, ids, q in work]
        t0 = time.perf_counter()
        by = {r.uid: r for r in sch.run_until_drained()}
        torch.cuda.synchronize()
        out[name] = ([by[u] for u in uids], time.perf_counter() - t0,
                     dict(sch.metrics.counters))
    (mine, t_s, c_s), (theirs, t_p, _) = out["sharded"], out["pcpm"]
    pushed = c_s.get("push_served", 0) + c_s.get("push_fallbacks", 0)
    gaps = [result_gap(a, b) for a, b in zip(mine, theirs)]
    stops = [same_stop(a.iterations, a.residual, b.iterations, b.residual,
                       q["tol"]) for a, b, (_, _, q) in
             zip(mine, theirs, work)]
    apart = [i for i, (a, b) in enumerate(zip(mine, theirs))
             if a.iterations != b.iterations]
    log(f"sharded serving drain: 16 queries in {t_s:.2f} s (pcpm "
        f"{t_p:.2f} s); pushed {pushed} (every query on the stepper: "
        f"{pushed == 0}); max gap {max(gaps)!r} (<= 1e-6); iterations "
        f"apart in queries {apart} (each a rounding stop: {all(stops)})")
    for i in apart:
        a, b = mine[i], theirs[i]
        log(f"  query {i}: sharded {a.iterations} ({a.residual!r}), pcpm "
            f"{b.iterations} ({b.residual!r})")
    if pushed or max(gaps) > 1e-6 or not all(stops) or not all(
            r.converged for r in mine):
        fail("sharded serving differs from the pcpm scheduler")
    srv = PageRankServer(g, sharded=True, num_iterations=iterations,
                         part_size=psz, device=dev)
    pr, it, _ = srv.query()
    pr = pr.cpu().numpy()
    gap = float(np.abs(pr - ranks["pcpm"]).max())
    l1 = float(np.abs(pr.astype(np.float64) - oracle).sum())
    log(f"sharded PageRankServer: {it} iterations, L-inf vs pcpm {gap!r}, "
        f"L1 vs float64 oracle {l1!r}")
    if it != iterations or gap > 1e-6 or l1 > 1e-5:
        fail("sharded PageRankServer disagrees")


# --------------------------------------------------------------- phase 8
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
    """B3 against its plain version at TestFlashAttention's shapes, at
    the LM slice's decode and prefill shapes and at every shape phase 10b
    launches it at; returns the five cases the kernels line times (the
    LM slice's two, mixtral's decode and windowed prefill, grok-1's
    decode) as {name: (args, kwargs, max abs err)}."""
    import torch
    from repro_torch.configs import get as get_config
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
    # phase 10b's shapes: mixtral's decode (GQA group 4, dh 128) and its
    # prefill past the 4096 window, which skips whole key tiles; grok-1's
    # decode after its (2, 2048) prefill (GQA group 6)
    mix = get_config(MOE_ARCH)
    heads = (mix.n_heads, mix.n_kv_heads)
    decode = (b3_inputs(dev, gen, SLOTS, *heads, 1, MAX_LEN, mix.dh, bf16),
              dict(causal=False, kv_len=torch.tensor(
                  lens, dtype=torch.int32, device=dev)))
    cases["mixtral_decode"] = decode + (check_b3(
        decode[0], "mixtral decode shape", **decode[1]),)
    b, s = MOE_PREFILL
    prefill = (b3_inputs(dev, gen, b, *heads, s, s, mix.dh, bf16),
               dict(causal=True, window=mix.window))
    cases["mixtral_prefill"] = prefill + (check_b3(
        prefill[0], "mixtral windowed prefill shape", **prefill[1]),)
    grok = get_config(BIG_ARCHS[0][0])
    b, s = BIG_PREFILL
    slots = s + BIG_DECODE_STEPS
    decode = (b3_inputs(dev, gen, b, grok.n_heads, grok.n_kv_heads, 1, slots,
                        grok.dh, bf16),
              dict(causal=False, kv_len=torch.tensor(
                  [s + 1, slots], dtype=torch.int32, device=dev)))
    cases["grok_decode"] = decode + (check_b3(
        decode[0], "grok-1 decode shape", **decode[1]),)
    # the rest of phase 10b's launches: mixtral's windowed forward over
    # 6144 + 64 tokens; grok-1's and deepseek's (2, 2048) prefills and
    # forwards over 2048 + 32 tokens, whose "tc" row packing divides by
    # their GQA groups of 6 and 8; deepseek's "split" decode
    mb, ms = MOE_PREFILL
    sq = ms + MOE_DECODE_STEPS
    check_b3(b3_inputs(dev, gen, mb, *heads, sq, sq, mix.dh, bf16),
             "mixtral windowed forward shape", causal=True,
             window=mix.window)
    for arch, _ in BIG_ARCHS:
        big = get_config(arch)
        heads = (big.n_heads, big.n_kv_heads)
        for label, sq in (("prefill", s), ("forward", slots)):
            check_b3(b3_inputs(dev, gen, b, *heads, sq, sq, big.dh, bf16),
                     f"{arch} {label} shape", causal=True)
    deepseek = get_config(BIG_ARCHS[1][0])
    decode = b3_inputs(dev, gen, b, deepseek.n_heads, deepseek.n_kv_heads,
                       1, slots, deepseek.dh, bf16)
    check_b3(decode, "deepseek-67b decode shape", causal=False,
             kv_len=torch.tensor([s + 1, slots], dtype=torch.int32,
                                 device=dev))
    return cases


# --------------------------------------------------------------- phase 9
def sdpa_call(q, k, v, *, causal, kv_len=None, window=None):
    """``scaled_dot_product_attention`` on the same inputs, the
    yardstick: heads-major views of the (B, S, H, D) tensors, GQA by
    ``enable_gqa``, per-row lengths as a boolean mask; under a window,
    an explicit causal window mask (Sq = Skv)."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if kv_len is not None:
        mask = (torch.arange(k.shape[1], device=q.device)[None, :]
                < kv_len[:, None])[:, None, None, :]
    if window is not None:
        pos = torch.arange(k.shape[1], device=q.device)
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))
        causal = False
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal, enable_gqa=True)


def b3_entry(case, name, launches, card) -> dict:
    """Time B3, its plain version and SDPA at one shape; its bound from
    this case's inputs: the bytes of q, o and the live K/V rows, and the
    4·D operations of every visible (query, key) pair (under a window,
    min(i + 1, window) keys for query i)."""
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
        w = kw.get("window") or sq
        seen = sum(min(i + 1, w) for i in range(sq))
        pairs = b * hq * seen
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


def profile_steps(step, label, card, names=(),
                  steps: int = PROFILE_STEPS) -> None:
    """Device busy share and top kernels of ``steps`` calls of
    ``step()``; with ``names``, also the device time of the kernels whose
    name holds one of them (one kernel's, e.g. B3's), or, with a dict of
    such tuples, of each group."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if not busy_us:
        log(f"profile {label}: no device time in the trace (not measured)")
        return
    log(f"profile {label} ({steps} steps): device busy "
        f"{busy_us:.0f} us of {wall_us:.0f} us wall "
        f"({100 * busy_us / wall_us:.1f}%), idle "
        f"{100 * (1 - busy_us / wall_us):.1f}% ({card})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / steps:9.1f} us/step "
            f"x{e.count / steps:<5.1f} {e.key[:PROFILE_NAME_CHARS]}")
    groups = names if isinstance(names, dict) else (
        {"/".join(names): names} if names else {})
    for group, keys in groups.items():
        mine = [e for e in events if any(n in e.key for n in keys)]
        us = sum(e.self_device_time_total for e in mine) / steps
        log(f"profile {label}: kernels {group} {us:.1f} us/step "
            f"of device time ({100 * us * steps / busy_us:.1f}% of "
            f"the busy time) in "
            f"{sum(e.count for e in mine) / steps:.1f} launches per "
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


# -------------------------------------------------------------- phase 10b
def cut_config(arch: str, n_layers: int):
    """``arch`` at its published widths with only its depth cut."""
    import dataclasses
    from repro_torch.configs import get
    return dataclasses.replace(get(arch), n_layers=n_layers)


def init_model(cfg, dev, card):
    """Random bfloat16 weights (the router float32) from a seeded
    generator; the parameter count checked against the config's, which
    leaves the router (n_layers x d_model x n_experts) out."""
    import torch
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    model = tf.init_lm(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    want = cfg.param_count() + cfg.n_layers * cfg.d_model * cfg.n_experts
    log(f"model: {cfg.name} at its published widths (d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}, dh {cfg.dh}, d_ff {cfg.d_ff}, "
        f"experts {cfg.n_experts} top-{cfg.top_k}, window {cfg.window}, vocab "
        f"{cfg.vocab}), depth cut to {cfg.n_layers} layers: {n} parameters "
        f"({nbytes} B; = param_count {cfg.param_count()} + router "
        f"{want - cfg.param_count()}: {n == want}) from torch.Generator seed "
        f"0, {time.perf_counter() - t0:.1f} s ({card})")
    if n != want:
        fail(f"{cfg.name}: {n} parameters, the config counts {want}")
    return model


def with_capacity(model, capacity_factor: float):
    """The same parameter tensors under another MoE capacity factor."""
    import dataclasses
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(model.cfg, capacity_factor=capacity_factor)
    return tf.LM(cfg, model.embed, model.unembed, model.final_norm,
                 [{name: getattr(block, name)
                   for name in tf.layer_weights(cfg)}
                  for block in model.layers])


class RouteLog:
    """The router logits, the set of top-k experts (ascending) and the
    top-k margin (k-th minus (k+1)-th router logit) of every MoE router
    call (``transformer.route``) while open, in call order; the
    decode-vs-forward check reads them. The set, not the order: with the
    gates following their experts, two routes that swap places give the
    same output."""

    def __init__(self):
        from repro_torch.models import transformer as tf
        self.tf, self.route, self.calls = tf, tf.route, []

    def __enter__(self):
        def route(h, router, k):
            logits, top, experts = self.route(h, router, k)
            following = logits.topk(k + 1, dim=-1).values[..., k]
            self.calls.append((logits, experts.sort(-1).values,
                               top[..., k - 1] - following))
            return logits, top, experts
        self.tf.route = route
        return self

    def __exit__(self, *exc):
        self.tf.route = self.route


def decode_vs_forward(model, card, tokens, steps: int, label: str) -> int:
    """``prefill`` of ``tokens`` (B, S), then ``steps`` lockstep
    ``decode_step``s (positions S .. S+steps-1, through the prefill's
    cache: its ring under a window, else copied into a cache of S+steps
    slots) against ``forward`` over the S+steps tokens. Gate as phase 9:
    the max logit gap and the greedy tokens where the top-2 margin
    exceeds MOE_DECODE_TOL. A position where decode and forward send a
    token to another set of experts in some layer is named with its
    margins and not held to the gap; such a flip must be
    a near-tie (MOE_ROUTER_TIE) unless a flip at an earlier layer of the
    same position explains it, and at least MOE_ROUTED_ALIKE of the
    positions must route alike in every layer. Returns the B3 launches of
    the decode steps."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.models import transformer as tf
    cfg = model.cfg
    b, s = tokens.shape[0], tokens.shape[1] - steps
    n_moe = cfg.n_layers if cfg.moe else 0
    with RouteLog() as fwd_log:
        full = tf.forward(model, tokens)[0][:, s:].float()
    _, cache = tf.prefill(model, tokens[:, :s])
    wide = tf.init_cache(cfg, b, s + steps, device=tokens.device)
    if wide["k"].shape[2] != cache["k"].shape[2]:     # no window: copy in
        for name in ("k", "v"):
            wide[name][:, :, :s] = cache[name]
        cache = wide
    del wide
    b3.launch_count = 0
    out = []
    with RouteLog() as dec_log:
        for t in range(s, s + steps):
            logits, cache = tf.decode_step(model, cache,
                                           tokens[:, t:t + 1], t)
            out.append(logits[:, 0].float())
    dec = torch.stack(out, 1)
    torch.cuda.synchronize()
    launches = b3.launch_count
    del cache
    # positions whose experts differ from the forward's in some layer
    flipped = torch.zeros((b, steps), dtype=torch.bool, device=dec.device)
    flips = []                           # in position order, then layer
    for i in range(steps):
        for layer in range(n_moe):
            d_logits, d_exp, d_margin = dec_log.calls[i * n_moe + layer]
            f_logits, f_exp, f_margin = fwd_log.calls[layer]
            differ = (d_exp[:, 0] != f_exp[:, s + i]).any(-1)
            drift = (d_logits[:, 0] - f_logits[:, s + i]).abs().amax(-1)
            for row in differ.nonzero().flatten().tolist():
                primary = not bool(flipped[row, i])
                flips.append((row, s + i, layer, float(f_margin[row, s + i]),
                              float(d_margin[row, 0]), float(drift[row]),
                              primary))
            flipped[:, i] |= differ
    gaps = (dec - full).abs().amax(-1)
    top2 = full.topk(2, -1).values
    decided = (top2[..., 0] - top2[..., 1]) > MOE_DECODE_TOL
    wrong = (dec.argmax(-1) != full.argmax(-1)) & decided
    agree = ~flipped
    gap = float(gaps.max())
    gap_agree = float(gaps[agree].max()) if bool(agree.any()) else 0.0
    log(f"{label} decode vs forward over positions {s}-{s + steps - 1} "
        f"(batch {b}): max abs logit gap {gap!r} (tol {MOE_DECODE_TOL}; "
        f"logits up to {float(full.abs().max()):.3f}), {gap_agree!r} where "
        f"decode and forward route alike in every layer "
        f"({int(agree.sum())} of {b * steps} positions); greedy tokens "
        f"differ at {int(wrong.sum())} of {int(decided.sum())} positions "
        f"whose top-2 margin exceeds the tol, {int((wrong & agree).sum())} "
        f"of them routed alike; B3 launches {launches} "
        f"(= {cfg.n_layers} x {steps}) ({card})")
    for row, pos, layer, f_margin, d_margin, drift, primary in flips:
        log(f"  router flip: row {row}, position {pos}, layer {layer}: "
            f"forward margin {f_margin!r}, decode margin {d_margin!r}, "
            f"router logits apart by up to {drift!r}"
            f"{'' if primary else ' (after a flip at an earlier layer)'}")
    if gap_agree > MOE_DECODE_TOL or bool((wrong & agree).any()):
        fail(f"{label}: decode_step disagrees with forward where both "
             "route alike")
    ties = [f for f in flips if f[6] and max(f[3], f[4]) > MOE_ROUTER_TIE]
    if ties or int(agree.sum()) < MOE_ROUTED_ALIKE * b * steps:
        fail(f"{label}: decode and forward route apart beyond near-ties "
             f"(tie {MOE_ROUTER_TIE}) or at more than "
             f"{1 - MOE_ROUTED_ALIKE:.0%} of the positions: "
             f"{ties or flips}")
    if launches != cfg.n_layers * steps:
        fail(f"{label}: B3 launches differ from layers x decode steps")
    return launches


def moe_prefill(model, tokens, label: str, card):
    """``prefill`` once with B3's launches counted: it must launch once a
    layer and give finite logits and a cache of the window's (or S)
    slots; returns the B3 launches."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.models import transformer as tf
    cfg = model.cfg
    b, s = tokens.shape
    slots = min(s, cfg.window) if cfg.window else s
    b3.launch_count = 0
    logits, cache = tf.prefill(model, tokens)
    torch.cuda.synchronize()
    launches = b3.launch_count
    finite = bool(torch.isfinite(logits).all())
    shape = (cfg.n_layers, b, slots, cfg.n_kv_heads, cfg.dh)
    log(f"{label} prefill {(b, s)} at capacity_factor {cfg.capacity_factor}: "
        f"B3 launches {launches} (= {cfg.n_layers}), logits "
        f"{tuple(logits.shape)} finite {finite}, cache "
        f"{tuple(cache['k'].shape)} (= {shape}) ({card})")
    if (launches != cfg.n_layers or not finite
            or tuple(cache["k"].shape) != shape
            or logits.shape != (b, 1, cfg.vocab)):
        fail(f"{label} prefill")
    return launches


def moe_phases(dev, card, b3_cases) -> list[dict]:
    """Phase 10b: mixtral-8x7b (8 of 32 layers) serving a drain, a
    windowed prefill and decode against forward, with times; grok-1-314b
    (2 of 64) and deepseek-67b (4 of 95): a prefill and decode against
    forward. Returns B3's entries of the kernels line at mixtral's
    decode, its windowed prefill and grok-1's decode."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import swiglu
    from repro_torch.serve import Request, ServeEngine
    t_phase = time.perf_counter()
    cfg = cut_config(MOE_ARCH, MOE_LAYERS)
    model = init_model(cfg, dev, card)
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
    log(f"main path (MoE serving, {cfg.name}): {N_REQUESTS} requests "
        f"(prompts {min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens) over {SLOTS} slots, "
        f"max_len {MAX_LEN} (cache slots {eng.cache['k'].shape[2]}: the "
        f"{cfg.window} window does not bind): {eng.steps} decode steps, "
        f"{generated} generated tokens, B3 launches {decode_launches} "
        f"(= {cfg.n_layers} x {eng.steps}: "
        f"{decode_launches == cfg.n_layers * eng.steps}), logits finite "
        f"{bool(finite)}; {drain_ms / eng.steps!r} ms per decode step over "
        f"the drain ({card})")
    if not all(r.done and r.error is None
               and len(r.generated) == NEW_TOKENS for r in reqs):
        fail("MoE drain: a request did not finish with its 64 tokens")
    if decode_launches != cfg.n_layers * eng.steps:
        fail("MoE drain: B3 launches differ from layers x decode steps")
    if not bool(finite):
        fail("MoE drain: non-finite logits")

    b, s = MOE_PREFILL
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    prefill_launches = moe_prefill(model, tokens, cfg.name, card)
    # decode never drops a route (one token a sequence); the forward does
    # at the published 1.25, so this check runs at E / k = 4, where it
    # cannot drop either
    seq = torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, s + MOE_DECODE_STEPS))).to(dev)
    decode_vs_forward(with_capacity(model, cfg.n_experts / cfg.top_k), card,
                      seq, MOE_DECODE_STEPS,
                      f"{cfg.name} (capacity_factor {cfg.n_experts}/"
                      f"{cfg.top_k} = {cfg.n_experts / cfg.top_k}, this "
                      f"check only)")
    del seq

    # ---------------------------------------------------- times
    steady = engine()
    for i in range(SLOTS):
        steady.add_request(Request(uid=i, prompt=[1 + i] * PROMPT_LENS[1],
                                   max_new_tokens=NEW_TOKENS))
    step_ms = time_ms(steady.step, reps=32, warmup=2)
    weight_bytes = sum(p.numel() * p.element_size()
                       for name, p in model.named_parameters()
                       if name != "embed")
    bound_ms = weight_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"time {cfg.name} decode step, {SLOTS} active slots: {step_ms!r} ms, "
        f"{SLOTS / step_ms * 1e3!r} tokens/s; weight-bytes bound "
        f"{bound_ms!r} ms ({weight_bytes} B of weights but the embedding, "
        f"every expert read once a step, at {PEAK_BYTES_PER_S / 1e12} TB/s) "
        f"({card})")
    block = model.layers[0]
    buf = torch.randn((cfg.n_experts, SLOTS, cfg.d_model), device=dev,
                      dtype=block.w_gate.dtype)
    expert_ms = time_ms(lambda: swiglu(buf, block.w_gate, block.w_up,
                                       block.w_down), reps=32)
    expert_bytes = 3 * block.w_gate.numel() * block.w_gate.element_size()
    log(f"time {cfg.name} expert GEMMs of one layer at decode ((E, B·cap, d) "
        f"= {tuple(buf.shape)}): {expert_ms!r} ms, bound {expert_bytes / PEAK_BYTES_PER_S * 1e3!r} "
        f"ms ({expert_bytes} B); x {cfg.n_layers} layers = "
        f"{100 * expert_ms * cfg.n_layers / step_ms:.1f}% of the step "
        f"({card})")
    del buf
    prefill_ms = time_ms(lambda: tf.prefill(model, tokens), reps=3,
                         warmup=1)
    log(f"time {cfg.name} prefill {MOE_PREFILL} (capacity_factor "
        f"{cfg.capacity_factor}): {prefill_ms!r} ms, "
        f"{b * s / prefill_ms * 1e3!r} tokens/s ({card})")
    profile_steps(steady.step, f"{cfg.name} decode, {steady.active} active "
                  f"slots", card, names=B3_KERNELS)
    entries = [b3_entry(b3_cases["mixtral_decode"], "mixtral_decode",
                        decode_launches, card),
               b3_entry(b3_cases["mixtral_prefill"],
                        "mixtral_prefill_window", prefill_launches, card)]
    del steady, eng, model, tokens
    torch.cuda.empty_cache()

    # ---------------------------------------------------- grok, deepseek
    for arch, n_layers in BIG_ARCHS:
        cfg = cut_config(arch, n_layers)
        model = init_model(cfg, dev, card)
        b, s = BIG_PREFILL
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (b, s + BIG_DECODE_STEPS))).to(dev)
        moe_prefill(model, tokens[:, :s], cfg.name, card)
        check = model
        label = cfg.name
        if cfg.moe:
            check = with_capacity(model, cfg.n_experts / cfg.top_k)
            label += (f" (capacity_factor {cfg.n_experts / cfg.top_k}, this "
                      f"check only)")
        launches = decode_vs_forward(check, card, tokens, BIG_DECODE_STEPS,
                                     label)
        if arch == "grok-1-314b":
            entries.append(b3_entry(b3_cases["grok_decode"], "grok_decode",
                                    launches, card))
        del model, check, tokens
        torch.cuda.empty_cache()
    log(f"phase 10b (MoE and SWA LMs): {time.perf_counter() - t_phase:.1f} s "
        f"({card})")
    return entries


# --------------------------------------------------------------- phase 11
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


def check_b2_views(dev) -> None:
    """B2 held to the plain version: equal values everywhere, the same
    bits wherever a row was read, a pad's row zeros and an id < 0 row 0;
    contiguous tables and unaligned views, odd widths, equiformer-v2's d
    6272 bfloat16, int32 and int64 ids; then weights and L > 1 at exact
    sums. Each call launches the kernel once."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag_cuda,
                                                   embedding_bag_ref,
                                                   embedding_lookup_cuda)
    from repro_torch.kernels.embedding_bag import kernel as b2
    gen = torch.Generator(device=dev).manual_seed(11)
    v, n = 300, 4000
    ids = torch.randint(-2, v + 3, (n,), generator=gen, device=dev)
    ids[0], ids[1] = v, -1                    # a pad, a negative id
    read = ids < v
    calls = 0

    def one(label, table, idx, w=None):
        nonlocal calls
        before = b2.launch_count
        out = (embedding_lookup_cuda(table, idx) if idx.dim() == 1
               else embedding_bag_cuda(table, idx, w))
        torch.cuda.synchronize()
        bags = idx.reshape(-1, 1) if idx.dim() == 1 else idx
        want = embedding_bag_ref(table, bags, w)
        ok = b2.launch_count == before + 1 and torch.equal(out, want)
        if idx.dim() == 1:
            bits = torch.int16 if table.dtype == torch.bfloat16 else (
                torch.int32)
            ok = ok and torch.equal(out[read].view(bits),
                                    want[read].view(bits))
            ok = ok and not out[0].any() and torch.equal(out[1], table[0])
        if not ok:
            fail(f"B2 at {label}: not one launch, or not the plain "
                 "version's values and bits")
        calls += 1

    for d, dtype in ((64, torch.float32), (512, torch.bfloat16),
                     (6272, torch.bfloat16), (13, torch.float32),
                     (3, torch.float32), (4, torch.bfloat16)):
        base = torch.randn((v, d + 8), generator=gen, device=dev).to(dtype)
        for view, table in (("contiguous", base[:, :d].contiguous()),
                            ("a view 1 column in", base[:, 1:1 + d])):
            for id_dtype in (torch.int32, torch.int64):
                one(f"d {d} {str(dtype)[6:]}, {view}, ids "
                    f"{str(id_dtype)[6:]}", table, ids.to(id_dtype))
    # weights (a segment-sum's gradient with the edge mask) and L > 1:
    # multiples of 1/4 by weights in {0, 1/2, 1}, exact in any order
    table = (torch.randint(-4, 5, (v, 512), generator=gen, device=dev)
             / 4.0).bfloat16()
    mask = torch.randint(0, 3, (n, 1), generator=gen, device=dev) / 2.0
    one("d 512 bfloat16, mask weights", table, ids[:, None], mask)
    one("d 512 bfloat16, L 8", table, ids.view(-1, 8))
    one("d 512 bfloat16, L 8, weights", table, ids.view(-1, 8).int(),
        mask.view(-1, 8))
    log(f"B2 views: {calls} calls (contiguous tables and unaligned views, "
        f"d 64, 512, 6272, 13, 3, 4, int32 and int64 ids, pads, a negative "
        f"id; weights and L 8): the plain version's values and, where a "
        f"row was read, its bits")


# --------------------------------------------------------------- phase 12
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


# --------------------------------------------------------------- phase 13
# LM training: tinyllama-1.1b at its published widths, the train_4k
# shape's sequence of 4096 with the global batch cut from 256 to 8 (two
# microbatches of 4) to fit the run's time; 5 steps on one batch at a
# constant learning rate
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 4096, 2, 5
TRAIN_LR = 3e-4                # the reference launcher's default
GRAD_SHAPE = (1, 2048)
# the whole model's gradient with B3-bwd against the plain attention
# backward, bfloat16 weights through 22 layers: relative L2 error of every
# parameter's gradient (the attention gradients' bfloat16 rounding,
# 2**-8, carried back through the layers)
GRAD_REL_L2 = 2e-2
# the restart drill: tinyllama at its widths, depth cut to 2 layers so
# that a checkpoint stays ~2.6 GB; batches of (4, 1024) in 2 microbatches
DRILL_LAYERS, DRILL_BATCH, DRILL_SEQ = 2, 4, 1024
DRILL_STEPS, DRILL_EVERY, DRILL_FAIL = 10, 5, 7
# mixtral-8x7b at its widths, depth cut to 2 of 32 layers, bfloat16
# moments (the reference's knob for large models), (1, 4096)
MOE_TRAIN_LAYERS, MOE_TRAIN_SHAPE, MOE_TRAIN_STEPS = 2, (1, 4096), 3
# B3-bwd against its plain version: float32 within 2e-3 (sums in another
# order); bfloat16 within the outputs' rounding, 1.6e-2 relative and
# 1.6e-2 of the tensor's largest magnitude near 0 (inside
# TestFlashAttention's 5e-2)
B3_BWD_F32_TOL = 2e-3
B3_BWD_BF16_TOL = 1.6e-2
B3_BWD_KERNELS = ("delta_kernel", "dkv_kernel", "dq_kernel")
B3_FWD_KERNELS = ("tc_fwd_kernel", "flash_fwd_kernel")


def check_b3_bwd(args, label, **kw) -> float:
    """B3 with its log-sum-exp (bit-equal to B3 without it) and B3-bwd on
    random output gradients, against autograd through the plain version
    on the same inputs upcast to float32, batch row by batch row (rows
    are independent; a whole (4, 4096) plain backward would hold ~40 GB);
    max abs err over dq, dk and dv."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, flash_attention_bwd_cuda, flash_attention_cuda)
    q, k, v, do = args
    plain_out = flash_attention_cuda(q, k, v, **kw)
    out, lse, o32 = flash_attention_cuda(q, k, v, for_backward=True, **kw)
    path = b3.b3_bwd_path(q.dtype)
    before, counts = b3.bwd_launch_count, dict(b3.bwd_launch_counts)
    grads = flash_attention_bwd_cuda(q, k, v, o32, lse, do, **kw)
    torch.cuda.synchronize()
    if b3.bwd_launch_count != before + 1 or \
            b3.bwd_launch_counts != {**counts, path: counts[path] + 1}:
        fail(f"B3-bwd {label}: not launched once through {path!r}")
    if path == "tc":     # no atomics: a second call gives the same bits
        again = flash_attention_bwd_cuda(q, k, v, o32, lse, do, **kw)
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            fail(f"B3-bwd {label}: two \"tc\" calls differ")
        del again
    if not torch.equal(out, plain_out) or \
            not torch.equal(o32.to(out.dtype), out):
        fail(f"B3 {label}: the output with the log-sum-exp and the float32 "
             "output differs from the output without them")
    f32 = q.dtype == torch.float32
    err, ratio = 0.0, 0.0
    for i in range(q.shape[0]):
        want = attention_bwd_ref(*(x[i:i + 1].float() for x in (q, k, v, do)),
                                 **kw)
        for name, g, w in zip("qkv", grads, want):
            g = g[i:i + 1].float()
            tol = B3_BWD_F32_TOL if f32 else B3_BWD_BF16_TOL
            atol = tol if f32 else tol * float(w.abs().max())
            gap = (g - w).abs()
            err = max(err, float(gap.max()))
            ratio = max(ratio, float((gap / (atol + tol * w.abs())).max()))
            if not bool(torch.isfinite(g).all()):
                fail(f"B3-bwd {label}: non-finite d{name}")
        del want
    shapes = " ".join(str(tuple(a.shape)) for a in args[:3])
    log(f"B3-bwd {label}: q k v {shapes} {str(q.dtype)[6:]} via {path!r}"
        f"{' (second call bit-equal: True)' if path == 'tc' else ''}, {kw}: "
        f"max_abs_err={err!r} (err/allowed {ratio:.3f}; "
        f"{'rtol=atol 2e-3' if f32 else 'rtol 1.6e-2, atol 1.6e-2 x max|ref|'}"
        f"); forward with its log-sum-exp and float32 output bit-equal: "
        f"True")
    if ratio > 1.0:
        fail(f"B3-bwd {label}: beyond its tolerance")
    return err


def b3_bwd_inputs(dev, gen, b, hq, hkv, s, d, dtype):
    """q, k, v and an output gradient, standard normal."""
    import torch

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    return (normal(b, s, hq, d), normal(b, s, hkv, d), normal(b, s, hkv, d),
            normal(b, s, hq, d))


def check_b3_bwd_shapes(dev) -> dict:
    """Phase 13 (a): B3-bwd against its plain version at the shapes of the
    JAX package's TestFlashAttention (float32 and bfloat16, windows 64,
    128 and 200, the unpadded S = 200), at tinyllama's training
    microbatch (4, 4096, 32/4 heads, dh 64, causal) and at mixtral's
    (1, 4096, 32/8, dh 128, window 4096); returns the two training
    shapes' cases for the times, by kernels-line name, as (args, kwargs,
    max abs err)."""
    import torch
    from repro_torch.configs import get as get_config
    gen = torch.Generator(device=dev).manual_seed(13)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        for b, hq, hkv, s, d in ((1, 4, 4, 256, 64), (2, 8, 2, 128, 64),
                                 (1, 4, 1, 384, 128)):
            check_b3_bwd(b3_bwd_inputs(dev, gen, b, hq, hkv, s, d, dt),
                         f"{name} causal", causal=True)
        for window in (64, 128, 200):
            check_b3_bwd(b3_bwd_inputs(dev, gen, 1, 2, 2, 384, 64, dt),
                         f"{name} window {window}", causal=True,
                         window=window)
        check_b3_bwd(b3_bwd_inputs(dev, gen, 1, 2, 2, 200, 64, dt),
                     f"{name} unpadded", causal=True)
    cfg = get_config(ARCH)
    b, s = TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ
    args = b3_bwd_inputs(dev, gen, b, cfg.n_heads, cfg.n_kv_heads, s, cfg.dh,
                         torch.bfloat16)
    err = check_b3_bwd(args, "tinyllama training shape", causal=True)
    mix = get_config(MOE_ARCH)
    mix_args = b3_bwd_inputs(dev, gen, 1, mix.n_heads, mix.n_kv_heads,
                             MOE_TRAIN_SHAPE[1], mix.dh, torch.bfloat16)
    mix_kw = dict(causal=True, window=mix.window)
    mix_err = check_b3_bwd(mix_args, "mixtral training shape", **mix_kw)
    torch.cuda.empty_cache()
    return {"train": (args, dict(causal=True), err),
            "train_mixtral": (mix_args, mix_kw, mix_err)}


def sdpa_bwd_call(q, k, v, do):
    """The backward of ``scaled_dot_product_attention`` (causal, GQA by
    ``enable_gqa``) on the same inputs, the yardstick: one forward with
    its graph kept, then ``autograd.grad`` per call."""
    import torch
    import torch.nn.functional as F
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=True)
    dout = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def b3_bwd_entry(case, name, label, launches, card) -> dict:
    """Phase 13 (f): B3-bwd, its plain version (batch row by batch row)
    and SDPA's causal backward at a training shape (a window must not
    bind there: SDPA gets no mask); the bound: 10·D operations a visible
    (query, q head, key) triple at the bfloat16 tensor-core rate, against
    the bytes of q, k, v, o, dO, the log-sum-exp read and dq, dk, dv
    written."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, flash_attention_bwd_cuda, flash_attention_cuda)
    (q, k, v, do), kw, err = case
    if kw.get("window") is not None and kw["window"] < k.shape[1]:
        fail(f"B3-bwd {label}: the window binds; SDPA's causal backward is "
             "no yardstick there")
    _, lse, o32 = flash_attention_cuda(q, k, v, for_backward=True, **kw)
    ms = time_ms(lambda: flash_attention_bwd_cuda(q, k, v, o32, lse, do,
                                                  **kw), reps=5, warmup=1)

    def plain():
        for i in range(q.shape[0]):
            attention_bwd_ref(*(x[i:i + 1] for x in (q, k, v, do)), **kw)
    plain_ms = time_ms(plain, reps=1, warmup=1)
    torch.cuda.empty_cache()
    library_ms = time_ms(sdpa_bwd_call(q, k, v, do), reps=5, warmup=1)
    torch.cuda.empty_cache()
    pairs, ops = b3.bwd_bound(q, k, **{"window": None, **kw})
    # q, k, v and dO read, dq, dk and dv written, the float32 o and the
    # lse read
    nbytes = (q.element_size() * (3 * q.numel() + 2 * k.numel()
                                  + 2 * v.numel())
              + 4 * (o32.numel() + lse.numel()))
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_BF16_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"B3-bwd at {label} {tuple(q.shape)} via "
        f"{b3.b3_bwd_path(q.dtype)!r}: "
        f"{ms!r} ms ({ops / ms / 1e9:.2f} TFLOP/s counted at 10·D); bound "
        f"{bound_ms!r} ms ({pairs} visible pairs, {ops} operations at "
        f"{PEAK_BF16_PER_S / 1e12:.0f} TFLOP/s bf16; {nbytes} B at "
        f"{PEAK_BYTES_PER_S / 1e12} TB/s); plain version (batch rows in "
        f"turn) {plain_ms!r} ms; scaled_dot_product_attention backward "
        f"{library_ms!r} ms ({card})")
    return {
        "name": f"flash_attention_bwd/{name}",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "XLA autodiff of src/repro/models/layers.py:47 "
                    "chunked_attention (no Pallas site)",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def reset_b3_counts() -> None:
    from repro_torch.kernels.flash_attention import kernel as b3
    b3.launch_count = 0
    b3.launch_counts = dict.fromkeys(b3.PATHS, 0)
    b3.bwd_launch_count = 0
    b3.bwd_launch_counts = dict.fromkeys(b3.BWD_PATHS, 0)


def train_steps(step, state, batch, n, label):
    """``n`` steps on ``batch``; (state, host metrics per step, ms per
    step by CUDA events)."""
    import torch
    from repro_torch.train.trainer import _host_metrics
    history, times = [], []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        model, opt_state, metrics = step(state[0], state[1], batch)
        end.record()
        state = (model, opt_state)
        history.append(_host_metrics(metrics))     # one host read a step
        times.append(start.elapsed_time(end))
    log(f"{label}: " + "; ".join(
        f"step {i + 1} " + ", ".join(f"{k} {v!r}" for k, v in m.items())
        + f", {t:.1f} ms" for i, (m, t) in enumerate(zip(history, times))))
    return state, history, times


def param_grads(model, tokens, labels):
    """Every parameter's gradient of ``lm_loss`` (per-layer remat)."""
    import torch
    from repro_torch.models import transformer as tf
    names, params = zip(*model.named_parameters())
    with model.trainable():
        loss, _ = tf.lm_loss(model, tokens, labels, remat=True)
        grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), dict(zip(names, grads))


def train_phase(dev, card, bwd_cases) -> list[dict]:
    """Phase 13 (b)-(f): tinyllama-1.1b trained at its widths through
    ``launch/train.py::build_step_and_state``; the whole model's gradient
    with B3-bwd against the plain attention backward; the restart drill;
    a compressed step and mixtral-8x7b's steps; B3-bwd's times at the
    training shapes of ``bwd_cases`` (``check_b3_bwd_shapes``). Returns
    B3-bwd's entries of the kernels line."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.kernels.flash_attention import ops as b3_ops
    from repro_torch.kernels.flash_attention import attention_bwd_ref
    from repro_torch.launch.train import build_step_and_state
    from repro_torch.train import Trainer, TrainerConfig, checkpoint
    t_phase = time.perf_counter()

    # ---------------------------------------- (b) tinyllama at its widths
    cfg = get(ARCH)
    torch.cuda.reset_peak_memory_stats()
    step, state = build_step_and_state(
        cfg, lr=TRAIN_LR, warmup=0, total=10_000,
        num_microbatches=TRAIN_MICRO, device=dev, seed=0)
    n_params = sum(p.numel() for p in state[0].parameters())
    if n_params != cfg.param_count():
        fail(f"{n_params} parameters, the config counts {cfg.param_count()}")
    batch = next(synthetic_lm_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=0, device=dev))
    reset_b3_counts()
    state, history, times = train_steps(
        step, state, batch, TRAIN_STEPS,
        f"main path (LM training, {cfg.name} at its widths: {n_params} "
        f"bfloat16 parameters, batch {TRAIN_BATCH} x {TRAIN_SEQ} in "
        f"{TRAIN_MICRO} microbatches, lr {TRAIN_LR})")
    torch.cuda.synchronize()
    bwd_launches, fwd_launches = b3.bwd_launch_count, b3.launch_count
    bwd_by_path = dict(b3.bwd_launch_counts)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in history]
    per_step = cfg.n_layers * TRAIN_MICRO
    step_ms = sum(times[1:]) / len(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"main path (LM training): losses {losses} (falling: "
        f"{losses[-1] < losses[0]}); B3-bwd launches {bwd_launches} (= "
        f"{cfg.n_layers} layers x {TRAIN_MICRO} microbatches x {TRAIN_STEPS} "
        f"steps: {bwd_launches == per_step * TRAIN_STEPS}) by path "
        f"{bwd_by_path} (all \"tc\": {bwd_by_path['tc'] == bwd_launches});"
        f" B3 launches "
        f"{fwd_launches} by path {b3.launch_counts} (forward and per-layer "
        f"recompute: {fwd_launches == 2 * per_step * TRAIN_STEPS})")
    log(f"time LM training step ({cfg.name}, {TRAIN_BATCH} x {TRAIN_SEQ}): "
        f"{step_ms!r} ms (mean of steps 2-{TRAIN_STEPS}; step 1 "
        f"{times[0]!r} ms), {tokens / step_ms * 1e3!r} tokens/s; peak device "
        f"memory {peak} B ({card})")
    if not all(np.isfinite([m[k] for m in history for k in
                            ("loss", "nll", "gnorm")])):
        fail("non-finite loss, nll or gnorm")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    if bwd_launches != per_step * TRAIN_STEPS or \
            bwd_by_path["tc"] != bwd_launches or \
            fwd_launches != 2 * per_step * TRAIN_STEPS or \
            b3.launch_counts["tc"] != fwd_launches:
        fail("B3 / B3-bwd launches differ from layers x microbatches x steps")
    profile_steps(lambda: step(state[0], state[1], batch),
                  f"LM training step ({cfg.name})", card, steps=1,
                  names={"B3 forward": B3_FWD_KERNELS,
                         "B3-bwd": B3_BWD_KERNELS})

    # ------------------------- (c) the whole model's gradient, two ways
    model = state[0]
    del state, step, batch
    torch.cuda.empty_cache()
    b, s = GRAD_SHAPE
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (b, s + 1))).to(dev)
    before = b3.bwd_launch_count
    loss_k, g_kernel = param_grads(model, toks[:, :-1], toks[:, 1:])
    launched = b3.bwd_launch_count - before
    real = b3_ops.flash_attention_bwd_cuda

    def plain_bwd(q, k, v, o, lse, do, **kw):
        return attention_bwd_ref(q, k, v, do, **kw)
    b3_ops.flash_attention_bwd_cuda = plain_bwd
    try:
        loss_p, g_plain = param_grads(model, toks[:, :-1], toks[:, 1:])
    finally:
        b3_ops.flash_attention_bwd_cuda = real
    worst, worst_name, zero = 0.0, "", []
    for name, g in g_kernel.items():
        w = g_plain[name].float()
        rel = float((g.float() - w).norm() / w.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
        if name.rsplit(".", 1)[-1] in ("wq", "wk", "wv") and \
                float(g.float().norm()) == 0.0:
            zero.append(name)
    log(f"whole-model gradient, {cfg.name} {GRAD_SHAPE}, B3-bwd against the "
        f"plain attention backward: loss {loss_k!r} / {loss_p!r}; B3-bwd "
        f"launches {launched} (= {cfg.n_layers}); worst relative L2 error "
        f"{worst!r} ({worst_name}; gate {GRAD_REL_L2}); wq, wk, wv zero in "
        f"{len(zero)} of {3 * cfg.n_layers} layers' weights")
    if launched != cfg.n_layers or worst > GRAD_REL_L2 or zero:
        fail("the whole model's gradient with B3-bwd disagrees with the plain "
             "attention backward, or attention weights get no gradient")
    del model, g_kernel, g_plain
    torch.cuda.empty_cache()

    # --------------------------------------------- (d) the restart drill
    drill_cfg = cut_config(ARCH, DRILL_LAYERS)
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-train-"))
    try:
        def trainer(path, fail_at=None, start=0):
            step, state = build_step_and_state(
                drill_cfg, lr=TRAIN_LR, warmup=2, total=DRILL_STEPS,
                num_microbatches=TRAIN_MICRO, device=dev, seed=1)

            def hook(i):
                if i == fail_at:
                    raise RuntimeError(f"injected failure at step {i}")
            return Trainer(
                TrainerConfig(total_steps=DRILL_STEPS,
                              checkpoint_every=DRILL_EVERY,
                              ckpt_dir=str(path), keep_checkpoints=2,
                              log_every=10 ** 9),
                step, state,
                synthetic_lm_batches(drill_cfg.vocab, DRILL_BATCH, DRILL_SEQ,
                                     seed=3, start_step=start, device=dev),
                failure_hook=hook if fail_at is not None else None,
                log_fn=log)
        t0 = time.perf_counter()
        run_a = trainer(root / "a")
        run_a.run()
        try:
            trainer(root / "b", fail_at=DRILL_FAIL).run()
            fail("the injected failure did not raise")
        except RuntimeError as exc:
            log(f"restart drill: run stopped: {exc}")
        run_c = trainer(root / "b", start=DRILL_EVERY)
        resumed = run_c.try_resume()
        run_c.run()
        same = all(torch.equal(x, y) for (_, x), (_, y) in zip(
            run_a.state[0].named_parameters(),
            run_c.state[0].named_parameters()))
        same_opt = all(torch.equal(run_a.state[1].mu[n], run_c.state[1].mu[n])
                       and torch.equal(run_a.state[1].nu[n],
                                       run_c.state[1].nu[n])
                       for n in run_a.state[1].mu)
        drill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        checkpoint.save(str(root / "t"), 1, run_a.state)
        save_s = time.perf_counter() - t0
        nbytes = (root / "t" / "step-00000001.npz").stat().st_size
        t0 = time.perf_counter()
        restored, _ = checkpoint.restore(str(root / "t"), run_a.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        exact = all(torch.equal(x, y) for (_, x), (_, y) in zip(
            restored[0].named_parameters(), run_a.state[0].named_parameters()))
        log(f"restart drill ({drill_cfg.name} at its widths, depth cut to "
            f"{DRILL_LAYERS}; {DRILL_STEPS} steps of ({DRILL_BATCH}, "
            f"{DRILL_SEQ}), checkpoints every {DRILL_EVERY}, failure at step "
            f"{DRILL_FAIL}): resumed from step {run_c.step - len(run_c.metrics_history)} "
            f"({resumed}); final parameters bit-identical to the "
            f"uninterrupted run: {same}, moments: {same_opt}; losses "
            f"{[m['loss'] for m in run_a.metrics_history]}; {drill_s:.1f} s")
        log(f"time checkpoint: save {save_s:.2f} s, restore {restore_s:.2f} s "
            f"({nbytes} B, restore exact: {exact}) ({card})")
        if not (resumed and same and same_opt and exact):
            fail("the restart drill is not bit-identical")
        del run_a, run_c, restored
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # --------------------- (e) a compressed step; mixtral at its widths
    step, state = build_step_and_state(drill_cfg, compress_grads=True,
                                       device=dev, seed=2)
    batch = next(synthetic_lm_batches(drill_cfg.vocab, DRILL_BATCH,
                                      DRILL_SEQ, seed=4, device=dev))
    state, history, _ = train_steps(step, state, batch, 1,
                                    f"compressed step ({drill_cfg.name}, "
                                    f"{DRILL_LAYERS} layers, int8 error "
                                    "feedback)")
    ef = state[1][1]
    if not np.isfinite(history[0]["loss"]) or not all(
            bool(torch.isfinite(e).all()) for e in ef.values()):
        fail("the compressed step")
    del step, state, batch, ef
    torch.cuda.empty_cache()
    moe_cfg = cut_config(MOE_ARCH, MOE_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    step, state = build_step_and_state(moe_cfg, lr=1e-4, warmup=0,
                                       device=dev, state_dtype="bfloat16")
    b, s = MOE_TRAIN_SHAPE
    batch = next(synthetic_lm_batches(moe_cfg.vocab, b, s, seed=5,
                                      device=dev))
    reset_b3_counts()
    state, history, times = train_steps(
        step, state, batch, MOE_TRAIN_STEPS,
        f"{moe_cfg.name} training (depth cut to {MOE_TRAIN_LAYERS} of 32, "
        f"{MOE_TRAIN_SHAPE}, bfloat16 moments)")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    want_bwd = MOE_TRAIN_LAYERS * MOE_TRAIN_STEPS
    moe_bwd_launches = b3.bwd_launch_counts["tc"]
    log(f"{moe_cfg.name} training: B3-bwd launches {b3.bwd_launch_count} "
        f"(= {want_bwd}) by path {b3.bwd_launch_counts}, B3 "
        f"{b3.launch_count} (forward and recompute = "
        f"{2 * want_bwd}); a step {sum(times[1:]) / len(times[1:])!r} ms; "
        f"peak device memory {peak} B ({card})")
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["aux"])
               and m["aux"] > 0 for m in history) or \
            b3.bwd_launch_count != want_bwd or \
            moe_bwd_launches != want_bwd or \
            b3.launch_count != 2 * want_bwd:
        fail(f"{moe_cfg.name} training")
    del step, state, batch
    torch.cuda.empty_cache()

    # ---------------------------------------------------- (f) B3-bwd times
    entries = [
        b3_bwd_entry(bwd_cases["train"], "train",
                     "tinyllama's training microbatch", bwd_launches, card),
        b3_bwd_entry(bwd_cases["train_mixtral"], "train_mixtral",
                     "mixtral's training shape", moe_bwd_launches, card)]
    log(f"phase 13 (LM training): {time.perf_counter() - t_phase:.1f} s")
    return entries


# --------------------------------------------------------------- phase 14
# MIND training at the reference's train_batch cell (launch/specs.py:
# global_batch 65,536, AdamW(lr=1e-3)) and configs/mind.py's widths; 5
# steps on one batch, as the reference's smoke test trains
MIND_TRAIN_STEPS = 5
MIND_TRAIN_LR = 1e-3
B2_BWD_KERNELS = ("bwd_chunk_kernel", "bwd_combine_kernel",
                  "bwd_zero_kernel")
HOT_RUN = 300_000              # the hottest row's ids at train_batch


def summation_bound(values, idx, w, num_rows):
    """Each element's bound on |B2-bwd - its plain version| for the sums
    of w · values into the rows ``idx`` reads (an id < 0 reads row 0, as
    B2-bwd's): 2 (n - 1) u sum |terms| for two float32 orders of a row's
    n terms, plus two roundings to bfloat16 (2**-7 of the sum) when
    ``values`` are bfloat16 (the output's dtype)."""
    import torch
    from repro_torch.kernels.embedding_bag import embedding_bag_bwd_ref
    absum = embedding_bag_bwd_ref(values.float().abs(), idx,
                                  None if w is None else w.abs(), num_rows)
    flat = idx.reshape(-1).long()
    counts = torch.bincount(flat[flat < num_rows].clamp_min(0),
                            minlength=num_rows)
    scale = 2 * (counts - 1).clamp_min(0) * 2.0 ** -24
    if values.dtype == torch.bfloat16:
        scale = scale + 2.0 ** -7
    return absum.mul_(scale[:, None].float())


def check_b2_bwd(dout, idx, w, v, label, tol, *, exact=False) -> float:
    """Launch B2-bwd once (twice: the second call must give the same
    bits), hold it against the plain backward; max abs err."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag_bwd_cuda,
                                                   embedding_bag_bwd_ref)
    grad = embedding_bag_bwd_cuda(dout, idx, w, v)
    again = embedding_bag_bwd_cuda(dout, idx, w, v)
    torch.cuda.synchronize()
    ref = embedding_bag_bwd_ref(dout, idx, w, v)
    torch.cuda.synchronize()
    err = float((grad.float() - ref.float()).abs().max())
    same = torch.equal(grad, again)
    equal = torch.equal(grad, ref)
    log(f"B2-bwd {label}: dout {tuple(dout.shape)} {str(dout.dtype)[6:]}, "
        f"ids {tuple(idx.shape)} into V={v}, weights {w is not None}: "
        f"max_abs_err={err!r} (rtol {tol['rtol']}, atol {tol['atol']}"
        f"{'; bit-equal required' if exact else ''}): bit-equal {equal}; "
        f"two calls bit-identical {same}")
    if not same:
        fail(f"B2-bwd {label}: two calls gave different bits")
    if exact and not equal:
        fail(f"B2-bwd {label}: not the plain backward's bits on exact sums")
    torch.testing.assert_close(grad.float(), ref.float(), **tol,
                               msg=lambda m: f"B2-bwd {label}: {m}")
    return err


def check_b2_bwd_shapes(dev) -> None:
    """B2-bwd against its plain backward: TestEmbeddingBag's shapes with
    weights on exact sums (multiples of 1/16 times multiples of 1/4: bit
    for bit) and on random float32 (within B2_TOL), pads and a negative
    id, a bfloat16 gradient, and one row read by HOT_RUN ids (exact sums
    bit for bit, random ones the CPU emulation's bits)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(14)
    for v, d, b, l in B2_TEST_SHAPES:
        idx = torch.randint(-2, v + 3, (b, l), generator=gen, device=dev)
        dout = torch.randint(-16, 17, (b, d), generator=gen,
                             device=dev).float() / 16
        w = torch.randint(0, 5, (b, l), generator=gen, device=dev).float() / 4
        check_b2_bwd(dout, idx, w, v, f"TestEmbeddingBag V={v} d={d} B={b} "
                     f"L={l}, exact sums", B2_TOL, exact=True)
        noisy = torch.randn((b, d), generator=gen, device=dev)
        check_b2_bwd(noisy, idx.int(), torch.rand((b, l), generator=gen,
                                                  device=dev),
                     v, f"TestEmbeddingBag V={v} d={d} B={b} L={l}, random",
                     B2_TOL)
        check_b2_bwd(noisy.bfloat16(), idx, None, v, "bfloat16 gradient",
                     B2_BF16_TOL)
    v = 512
    pads = torch.tensor([[0, 1, v, v], [2, v, v, v], [-1, 3, v, v + 88]],
                        device=dev)
    dout = torch.randn((3, 128), generator=gen, device=dev)
    check_b2_bwd(dout, pads, None, v, "pad ids and a negative id", B2_TOL)
    from repro_torch.kernels.embedding_bag import embedding_bag_bwd_cuda
    from repro_torch.kernels.embedding_bag import kernel as b2_kernel
    grad = embedding_bag_bwd_cuda(dout, pads, None, v)
    if not (torch.allclose(grad[0], dout[0] + dout[2], rtol=1e-6)
            and torch.equal(grad[2], dout[1])
            and not grad[torch.arange(4, v, device=dev)].any()):
        fail("B2-bwd pads: not the reference's gradient (row 0 from the "
             "negative id, nothing from the pads)")
    # one row read by HOT_RUN ids (1,172 chunks): on exact sums (|sum| <
    # 2**20 in steps of 1/16) bit for bit; on random values, whose float32
    # sums of 300k terms differ by ~1e-2 between orders, the CPU
    # emulation's bits
    from repro_torch.kernels.embedding_bag import embedding_bag_bwd_emulate
    ids = torch.randint(0, 10 ** 6, (HOT_RUN + HOT_RUN // 2, 1),
                        generator=gen, device=dev)
    ids[:HOT_RUN] = 123_457
    ids = ids[torch.randperm(ids.shape[0], generator=gen, device=dev)]
    t0 = time.perf_counter()
    dout = torch.randint(-16, 17, (ids.shape[0], 64), generator=gen,
                         device=dev).float() / 16
    label = f"one row read by {HOT_RUN} ids beside {HOT_RUN // 2} random ones"
    check_b2_bwd(dout, ids, None, 10 ** 6, f"{label}, exact sums", B2_TOL,
                 exact=True)
    dout = torch.randn((ids.shape[0], 64), generator=gen, device=dev)
    grad = embedding_bag_bwd_cuda(dout, ids, None, 10 ** 6)
    again = embedding_bag_bwd_cuda(dout, ids, None, 10 ** 6)
    emulated = embedding_bag_bwd_emulate(dout.cpu(), ids.cpu(), None, 10 ** 6,
                                         b2_kernel.BWD_CHUNK)
    same = torch.equal(grad, again)
    bits = torch.equal(grad.cpu(), emulated)
    log(f"B2-bwd {label}, random: two calls bit-identical {same}; the CPU "
        f"emulation's bits {bits}; {time.perf_counter() - t0:.2f} s for the "
        "hot-run checks")
    if not (same and bits):
        fail("B2-bwd hot run: calls differ, or not the emulation's bits")


def timed_walk_form(b2, timing, aligned):
    """``timing()`` (a timed series of B2-bwd calls) with the per-form
    launch counts reset before it, and the form of the walk those calls
    launched, read from the counts after it: fails unless every call took
    one form and it is the one ``bwd_form`` names for dout's alignment.
    Returns (``timing()``'s result, the form)."""
    b2.bwd_launch_counts = dict.fromkeys(b2.BWD_FORMS, 0)
    result = timing()
    ran = [f for f, c in b2.bwd_launch_counts.items() if c]
    if ran != [b2.bwd_form(aligned)]:
        fail(f"B2-bwd's timed calls launched the walk's forms "
             f"{b2.bwd_launch_counts}; expected only "
             f"{b2.bwd_form(aligned)!r}")
    return result, ran[0]


def b2_bwd_entry(dout, idx, num_rows, launches, err, card) -> dict:
    """Time B2-bwd as the train step calls it (``embedding_bag_bwd_cuda``
    on the step's dout and one-id bags), its plain version and a zeroed
    (V, d) tensor with ``index_add_`` of the valid rows (a yardstick the
    port never calls); its bound from this run's ids: each valid entry's
    dout row and each id read once, the (V, d) gradient written once."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag_bwd_cuda,
                                                   embedding_bag_bwd_ref,
                                                   sorted_keys)
    n, d = idx.numel(), dout.shape[1]
    flat = idx.reshape(-1)
    valid = flat < num_rows
    rows = dout[valid]                  # one-id bags: entry i is bag i
    keys = flat[valid].long().clamp_min(0)

    def library_call():
        return torch.zeros((num_rows, d), dtype=dout.dtype,
                           device=dout.device).index_add_(0, keys, rows)
    from repro_torch.kernels.embedding_bag import kernel as b2
    ms, form = timed_walk_form(
        b2, lambda: time_ms(
            lambda: embedding_bag_bwd_cuda(dout, idx, None, num_rows),
            reps=5),
        dout.data_ptr() % 16 == 0 and d * dout.element_size() % 16 == 0)
    sort_ms = time_ms(lambda: sorted_keys(idx, num_rows), reps=5)
    plain_ms = time_ms(lambda: embedding_bag_bwd_ref(dout, idx, None,
                                                     num_rows), reps=2)
    library_ms = time_ms(library_call, reps=5)
    lib_gap = float((library_call() - embedding_bag_bwd_cuda(
        dout, idx, None, num_rows)).abs().max())
    n_valid = int(valid.sum())
    distinct = int(torch.unique(keys).numel())
    nbytes = (n_valid * d * dout.element_size() + n * idx.element_size()
              + num_rows * d * dout.element_size())
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_valid * d / PEAK_F32_PER_S * 1e3     # one add an entry, column
    bound_ms = max(bytes_ms, ops_ms)
    log(f"B2-bwd at train_batch: {ms!r} ms (of which the stable sort of "
        f"the keys {sort_ms!r} ms); bound {bound_ms!r} ms ({nbytes} B for "
        f"{n} ids, {n_valid} valid, {distinct} distinct rows, the "
        f"({num_rows}, {d}) gradient, at {PEAK_BYTES_PER_S / 1e12} TB/s); "
        f"plain version {plain_ms!r} ms; zeros + index_add_ {library_ms!r} "
        f"ms (max gap to B2-bwd {lib_gap!r}) ({card})")
    return {
        "name": "embedding_bag_bwd/train_batch",
        "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "none: the reference's XLA autodiff of "
                    "src/repro/models/recsys.py:45 lookup",
        "path": form,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "sort_ms": sort_ms,
    }


def repeated_step(step, model, state, batch):
    """``step`` run twice from the same parameters and AdamW moments (the
    first run's result undone in place before the second): (model, state,
    the two runs' metrics, whether both left bit-identical parameters)."""
    import torch
    saved = ([p.detach().clone() for p in model.parameters()],
             {k: t.clone() for k, t in state.mu.items()},
             {k: t.clone() for k, t in state.nu.items()}, state.step.clone())
    model, state, m1 = step(model, state, batch)
    first = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():
        for p, s in zip(model.parameters(), saved[0]):
            p.copy_(s)
    for k in state.mu:
        state.mu[k].copy_(saved[1][k])
        state.nu[k].copy_(saved[2][k])
    state = type(state)(saved[3], state.mu, state.nu)
    model, state, m2 = step(model, state, batch)
    torch.cuda.synchronize()
    same = all(torch.equal(a, p) for a, p in zip(first, model.parameters()))
    return model, state, m1, m2, same


def mind_train_phase(dev, card) -> list[dict]:
    """Phase 14: MIND training at train_batch and full width. B2-bwd's
    checks; MIND from ``init_mind`` (seed 0) at vocab 10M, Zipf histories
    and targets at B 65,536, the reference cell's ``AdamW(lr=1e-3)``: one
    step's table gradient through B2-bwd against its CPU emulation bit
    for bit and the plain backward within each element's summation bound,
    its nonzero rows the rows the ids read; 5
    steps on one batch (loss finite and falling, B2 and B2-bwd once a
    step); a step repeated from the same state bit for bit; times, peak
    memory, a profiled step. Returns B2-bwd's entry of the kernels line."""
    import torch
    from repro_torch.configs import RECSYS_SHAPES, get
    from repro_torch.kernels.embedding_bag import (embedding_bag_bwd_emulate,
                                                   embedding_bag_bwd_ref)
    from repro_torch.kernels.embedding_bag import kernel as b2
    from repro_torch.kernels.embedding_bag import ops as b2_ops
    from repro_torch.models import recsys
    from repro_torch.optim import AdamW
    from repro_torch.train.trainer import _host_metrics
    t_phase = time.perf_counter()
    check_b2_bwd_shapes(dev)
    cfg = get(MIND_ARCH)
    b = {s.name: s for s in RECSYS_SHAPES}["train_batch"].global_batch
    model = recsys.init_mind(cfg, generator=torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    hist = histories(rng, b, cfg)
    target = zipf_ids(rng, (b,), cfg.vocab)
    ids = np.concatenate([hist.reshape(-1), target])
    kept = ids[ids < cfg.vocab]
    _, counts = np.unique(kept, return_counts=True)
    log(f"mind-train: {cfg.name} at vocab {cfg.vocab}, d {cfg.embed_dim}, "
        f"K {cfg.n_interests}, {cfg.capsule_iters} routing iterations, "
        f"hist_len {cfg.hist_len}; train_batch B {b}: {ids.size} lookups, "
        f"{kept.size} valid, {counts.size} distinct rows, the hottest read "
        f"{counts.max()} times, {int((counts >= 1000).sum())} rows >= 1000 "
        f"times")
    batch = {"hist": torch.from_numpy(hist).to(dev),
             "target": torch.from_numpy(target).to(dev)}
    opt = AdamW(lr=MIND_TRAIN_LR)
    state = opt.init(model)
    step = recsys.make_train_step(cfg, opt)

    # ---------------- the table's gradient: B2-bwd against the plain one
    recorded = {}
    real_bwd = b2_ops.embedding_bag_bwd_cuda

    def recording(dout, idx, w, v):
        recorded.update(dout=dout, idx=idx, v=v)
        return real_bwd(dout, idx, w, v)
    b2_ops.embedding_bag_bwd_cuda = recording
    try:
        with model.trainable():
            loss = recsys.mind_loss(model, cfg, batch)
            g_table, = torch.autograd.grad(loss, model.table)
    finally:
        b2_ops.embedding_bag_bwd_cuda = real_bwd
    dout, idx = recorded["dout"], recorded["idx"]
    # dout's entries are ~|user| / B (a mean over B users), most of them
    # far below B2_TOL's atol, so the gradient is held to the kernel's own
    # bits (its CPU emulation), to the plain backward within each
    # element's float32 summation bound (2 (n - 1) u sum |terms| for two
    # orders of a row's n terms, exact for a row of one), and its nonzero
    # rows to the distinct rows the step's ids read
    t0 = time.perf_counter()
    emulated = embedding_bag_bwd_emulate(dout.cpu(), idx.cpu(), None,
                                         cfg.vocab, b2.BWD_CHUNK)
    bits = torch.equal(g_table.cpu(), emulated)
    del emulated
    emulate_s = time.perf_counter() - t0
    want = embedding_bag_bwd_ref(dout, idx, None, cfg.vocab)
    bound = summation_bound(dout, idx, None, cfg.vocab)
    flat = idx.reshape(-1).long()
    rows_read = flat[flat < cfg.vocab].clamp_min(0)
    gap = (g_table - want).abs()
    grad_err = float(gap.max())
    over = int((gap > bound).sum())
    distinct = int(torch.unique(rows_read).numel())
    nonzero = int((g_table.abs().sum(1) > 0).sum())
    torch.cuda.synchronize()
    log(f"mind-train table gradient (one step, loss "
        f"{float(loss.detach())!r}): B2-bwd against its CPU emulation "
        f"bit-equal {bits} ({emulate_s:.2f} s); against the plain backward "
        f"(index_add_ on the card) max_abs_err={grad_err!r}, elements past "
        f"their summation bound {over} (largest bound "
        f"{float(bound.max())!r}); max |grad| {float(want.abs().max())!r}; "
        f"rows with a nonzero gradient {nonzero}, distinct rows read "
        f"{distinct}")
    if not bits:
        fail("MIND table gradient: not the bits of B2-bwd's CPU emulation")
    if over:
        fail(f"MIND table gradient: {over} elements differ from the plain "
             "backward by more than their float32 summation bound")
    if nonzero != distinct:
        fail(f"MIND table gradient: {nonzero} nonzero rows, but the step's "
             f"ids read {distinct} distinct rows")
    del bound, gap, rows_read, flat
    del want, g_table, loss

    # ---------------- the main path: 5 steps on one batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b2.launch_count = b2.bwd_launch_count = 0
    history, times = [], []
    for _ in range(MIND_TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        model, state, metrics = step(model, state, batch)
        end.record()
        history.append(_host_metrics(metrics))     # one host read a step
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    launches = (b2.launch_count, b2.bwd_launch_count)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in history]
    ms = float(np.mean(times[1:]))
    log(f"main path (MIND training): {MIND_TRAIN_STEPS} steps at B {b}: "
        + "; ".join(f"step {i + 1} loss {m['loss']!r}, gnorm "
                    f"{m['gnorm']!r}, {t:.2f} ms"
                    for i, (m, t) in enumerate(zip(history, times)))
        + f"; B2 launches {launches[0]}, B2-bwd {launches[1]} (expected "
        f"{MIND_TRAIN_STEPS} each)")
    if launches != (MIND_TRAIN_STEPS, MIND_TRAIN_STEPS):
        fail("MIND training: B2 or B2-bwd not launched once a step")
    if not all(np.isfinite(v) for m in history for v in m.values()):
        fail("MIND training: a loss or gnorm is not finite")
    if not losses[-1] < losses[0]:
        fail("MIND training: the loss did not fall over 5 steps")
    log(f"time MIND training step (B {b}, CUDA events, steps 2-"
        f"{MIND_TRAIN_STEPS}): {ms!r} ms, {b / ms * 1e3!r} users/s; peak "
        f"device memory {peak} B ({card})")

    # ---------------- a step repeated from the same state, bit for bit
    model, state, m1, m2, same = repeated_step(step, model, state, batch)
    log(f"mind-train repeated step: parameters bit-identical {same}; loss "
        f"{float(m1['loss'])!r} vs {float(m2['loss'])!r}")
    if not same or not torch.equal(m1["loss"], m2["loss"]):
        fail("MIND training: a step repeated from the same state gave "
             "other bits")

    # ---------------- a profiled step, then B2-bwd alone
    profile_steps(lambda: step(model, state, batch), "MIND training step",
                  card, names={"B2": ("embedding_bag_kernel",),
                               "B2-bwd": B2_BWD_KERNELS}, steps=2)
    torch.cuda.empty_cache()
    entry = b2_bwd_entry(dout, idx, cfg.vocab, launches[1], grad_err, card)
    entry["train_step_ms"] = ms
    log(f"phase 14 (MIND training): {time.perf_counter() - t_phase:.1f} s "
        f"({card})")
    return [entry]


# --------------------------------------------------------------- phase 15
# GNN training: configs/graphcast.py, nequip.py, mace.py and
# equiformer_v2.py at their published widths and depths, as the
# reference's production cells train them (launch/specs.py:210-216):
# bfloat16 messages with float32 masters, AdamW(lr=1e-3), n_out = n_vars
# or 16; 5 steps on one data.batch_for_shape batch of each cell
GNN_ARCHS = ("graphcast", "nequip", "mace", "equiformer-v2")
GNN_SHAPE_NAMES = ("full_graph_sm", "molecule")
GNN_TRAIN_STEPS = 5
GNN_TRAIN_LR = 1e-3
# graphcast at ogb_products with its nodes and edges divided by the same
# power of two, the largest fraction whose step peaks at or under
# GNN_PEAK_LIMIT bytes (PERF.md §4)
GNN_OGB_CUT = 32
GNN_PEAK_LIMIT = 70e9
# the card against the port's CPU path on the same parameters: depth cut
# to 2, float32 without TF32, full_graph_sm; each gradient leaf within a
# relative L2 error of 1e-4 of the larger of its norm and 1e-6 of the
# whole gradient's; the leaves whose gradient is zero in exact arithmetic
# (``gnn.ZERO_GRADIENT_LEAVES``) are rounding noise on both sides (on an
# H100, mace's ``b3.1`` read 3.2e-4 apart on that measure), so they are
# held to norms below 1e-8 of the whole gradient's instead
GNN_GATE_LAYERS = 2
GNN_GATE_REL_L2 = 1e-4
GNN_GATE_FLOOR = 1e-6
GNN_ZERO_GRAD_NORM = 1e-8
B2_KERNELS = ("embedding_bag_kernel",)


def gnn_shapes():
    """{name: ShapeSpec} of phase 15's cells: GNN_SHAPE_NAMES and
    ogb_products cut by GNN_OGB_CUT."""
    from repro_torch.configs import GNN_SHAPES
    shapes = {s.name: s for s in GNN_SHAPES}
    ogb = shapes["ogb_products"]
    cut = dataclasses.replace(
        ogb, name=f"ogb_products/{GNN_OGB_CUT}",
        n_nodes=ogb.n_nodes // GNN_OGB_CUT,
        n_edges=ogb.n_edges // GNN_OGB_CUT)
    return {**{n: shapes[n] for n in GNN_SHAPE_NAMES}, cut.name: cut}


def message_width(cfg) -> int:
    """The width of a GNN's node gathers and aggregates: d_hidden
    (graphcast) or d_hidden · sum over l of (2l+1) (the equivariant
    models' concatenated irreps; mace gathers d_hidden and aggregates
    this)."""
    if cfg.flavor == "mpnn":
        return cfg.d_hidden
    return cfg.d_hidden * (cfg.l_max + 1) ** 2


def check_gnn_kernels(dev, label, ids, n, d, dtype, *, weighted) -> float:
    """B2 and B2-bwd at one GNN shape, as the GNN calls them: B2 gathers
    rows ``ids`` of an (n, d) table (one-id bags, and, for a segment-sum's
    gradient, weighted by an edge mask); B2-bwd sums (E, d) rows into the
    n rows ``ids`` names (weighted by the mask). Exact sums (multiples of
    1/4 times weights in {0, 1/2, 1}) must give the plain version's bits,
    random values stay within each element's summation bound, and a
    second call gives the same bits. Returns B2-bwd's largest error on
    random values."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag_bwd_cuda,
                                                   embedding_bag_bwd_ref,
                                                   embedding_bag_cuda,
                                                   embedding_bag_ref,
                                                   embedding_lookup_cuda)
    gen = torch.Generator(device=dev).manual_seed(15)
    e = ids.numel()
    bags = ids[:, None]
    w = ((torch.randint(0, 3, (e, 1), generator=gen, device=dev) / 2.0)
         if weighted else None)
    table = (torch.randint(-4, 5, (n, d), generator=gen, device=dev)
             / 4.0).to(dtype)
    values = (torch.randint(-4, 5, (e, d), generator=gen, device=dev)
              / 4.0).to(dtype)
    rows = embedding_lookup_cuda(table, ids)
    gathered = torch.equal(rows, embedding_bag_ref(table, bags))
    weighted_rows = embedding_bag_cuda(table, bags, w)
    weighted_ok = torch.equal(weighted_rows, embedding_bag_ref(table, bags,
                                                               w))
    sums = embedding_bag_bwd_cuda(values, bags, w, n)
    exact = torch.equal(sums, embedding_bag_bwd_ref(values, bags, w, n))
    again = torch.equal(sums, embedding_bag_bwd_cuda(values, bags, w, n))
    del rows, weighted_rows, sums, table
    noisy = torch.randn((e, d), generator=gen, device=dev).to(dtype)
    got = embedding_bag_bwd_cuda(noisy, bags, w, n)
    want = embedding_bag_bwd_ref(noisy, bags, w, n)
    gap = (got.float() - want.float()).abs()
    bound = summation_bound(noisy, bags, w, n)
    over = int((gap > bound).sum())
    err = float(gap.max())
    same = torch.equal(got, embedding_bag_bwd_cuda(noisy, bags, w, n))
    torch.cuda.synchronize()
    log(f"B2/B2-bwd at {label}: ids ({e},) into ({n}, {d}) "
        f"{str(dtype)[6:]}, mask weights {weighted}: B2 gather bit-equal "
        f"{gathered}, B2 weighted (a segment-sum's gradient) bit-equal "
        f"{weighted_ok}; B2-bwd on exact sums bit-equal {exact}, random "
        f"max_abs_err={err!r}, elements past their summation bound {over} "
        f"(largest bound {float(bound.max())!r}); two calls bit-identical "
        f"{again and same}")
    if not (gathered and weighted_ok and exact):
        fail(f"B2/B2-bwd at {label}: not the plain version's bits on exact "
             "inputs")
    if over:
        fail(f"B2-bwd at {label}: {over} elements past their summation "
             "bound")
    if not (again and same):
        fail(f"B2-bwd at {label}: two calls gave different bits")
    return err


def gnn_kernel_entries(dev, label, ids, src_ids, n, d, dtype, launches,
                       err, card) -> list[dict]:
    """Time B2 (the gather of the destinations ``ids``) and B2-bwd (the
    segment-sum by destination with the mask's weights) at one GNN shape,
    as the GNN calls them, beside their plain versions, ``index_select``
    and a zeroed tensor's ``index_add_`` (the yardsticks, which the port
    never calls); bounds from this run's ids. B2 at the sources
    ``src_ids`` (rows read out of order) is timed and logged beside it.
    Returns the two entries of the kernels line."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag_bwd_cuda,
                                                   embedding_bag_bwd_ref,
                                                   embedding_bag_ref,
                                                   embedding_lookup_cuda)
    from repro_torch.kernels.embedding_bag import kernel as b2
    gen = torch.Generator(device=dev).manual_seed(16)
    e = ids.numel()
    bags = ids[:, None]
    mask = torch.ones((e, 1), dtype=torch.float32, device=dev)
    table = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    values = torch.randn((e, d), generator=gen, device=dev).to(dtype)
    long_ids = ids.long()
    es = table.element_size()
    distinct = int(torch.unique(ids).numel())
    reps = 20 if e * d < 10 ** 8 else 5
    fwd_ms = time_ms(lambda: embedding_lookup_cuda(table, ids), reps=reps)
    fwd_plain = time_ms(lambda: embedding_bag_ref(table, bags), reps=3)
    fwd_lib = time_ms(lambda: table.index_select(0, long_ids), reps=reps)
    fwd_bytes = e * ids.element_size() + distinct * d * es + e * d * es
    fwd_bound = fwd_bytes / PEAK_BYTES_PER_S * 1e3
    src_long = src_ids.long()
    src_ms = time_ms(lambda: embedding_lookup_cuda(table, src_ids),
                     reps=reps)
    src_lib = time_ms(lambda: table.index_select(0, src_long), reps=reps)
    src_distinct = int(torch.unique(src_ids).numel())
    src_bytes = (e * src_ids.element_size() + src_distinct * d * es
                 + e * d * es)
    src_bound = src_bytes / PEAK_BYTES_PER_S * 1e3
    src_same = torch.equal(embedding_lookup_cuda(table, src_ids),
                           table.index_select(0, src_long))
    bwd_ms, form = timed_walk_form(
        b2, lambda: time_ms(
            lambda: embedding_bag_bwd_cuda(values, bags, mask, n), reps=reps),
        values.data_ptr() % 16 == 0 and d * es % 16 == 0)
    bwd_plain = time_ms(
        lambda: embedding_bag_bwd_ref(values, bags, mask, n), reps=3)
    bwd_lib = time_ms(lambda: torch.zeros((n, d), dtype=dtype, device=dev)
                      .index_add_(0, long_ids, values), reps=reps)
    bwd_bytes = e * d * es + e * (ids.element_size() + 4) + n * d * es
    bwd_bytes_ms = bwd_bytes / PEAK_BYTES_PER_S * 1e3
    bwd_ops_ms = e * d / PEAK_F32_PER_S * 1e3
    bwd_bound = max(bwd_bytes_ms, bwd_ops_ms)
    log(f"B2 gather at {label} (ids ({e},) of ({n}, {d}) {str(dtype)[6:]}, "
        f"{distinct} distinct): {fwd_ms!r} ms; bound {fwd_bound!r} ms "
        f"({fwd_bytes} B at {PEAK_BYTES_PER_S / 1e12} TB/s); plain version "
        f"{fwd_plain!r} ms; index_select {fwd_lib!r} ms ({card})")
    log(f"B2 source gather at {label} (edge_src, rows read out of order, "
        f"{src_distinct} distinct): {src_ms!r} ms; bound {src_bound!r} "
        f"ms; index_select {src_lib!r} ms; its rows bit-equal {src_same} "
        f"({card})")
    if not src_same:
        fail(f"B2 at {label}'s sources: not index_select's rows")
    log(f"B2-bwd segment-sum at {label} ((E, d) = ({e}, {d}) into {n} "
        f"rows, mask weights, walk {form!r}): {bwd_ms!r} ms; bound "
        f"{bwd_bound!r} ms ({bwd_bytes} B); plain version {bwd_plain!r} ms; zeros + "
        f"index_add_ {bwd_lib!r} ms ({card})")
    common = {"route": "cuda",
              "source": "src/repro_torch/csrc/embedding_bag.cu"}
    return [
        {"name": f"embedding_bag/gnn_{label}", **common,
         "replaces": "src/repro/kernels/embedding_bag/kernel.py:49",
         "launches": launches[0], "max_abs_err": 0.0, "ms": fwd_ms,
         "plain_ms": fwd_plain, "bound_ms": fwd_bound,
         "bound_by": "bytes", "library_ms": fwd_lib},
        {"name": f"embedding_bag_bwd/gnn_{label}", **common,
         "replaces": "none: the reference's jax.ops.segment_sum in "
                     "src/repro/models/gnn.py:85 aggregate",
         "path": form, "launches": launches[1], "max_abs_err": err,
         "ms": bwd_ms,
         "plain_ms": bwd_plain, "bound_ms": bwd_bound,
         "bound_by": ("bytes" if bwd_bytes_ms >= bwd_ops_ms
                      else "operations"),
         "library_ms": bwd_lib},
    ]


def gnn_train_cell(dev, card, arch, shape, batch, *, profile=0) -> dict:
    """One phase-15 cell: ``arch`` at its published widths and depth in
    bfloat16 messages (float32 masters) from ``init_gnn`` (seed 0),
    GNN_TRAIN_STEPS steps of AdamW(lr=1e-3) on ``batch``. Gates: losses
    finite and falling, B2 and B2-bwd launched as ``gnn.kernel_calls``
    counts a step, a step repeated from the same state with the same
    bits, and (ogb) the peak under GNN_PEAK_LIMIT; ``profile`` steps
    profiled after. Returns the cell's numbers."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.embedding_bag import kernel as b2
    from repro_torch.models import gnn
    from repro_torch.optim import AdamW
    from repro_torch.train.trainer import _host_metrics
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get(arch), act_dtype="bfloat16")
    n_out = cfg.n_vars or 16
    e = batch.edge_src.shape[0]
    model = gnn.init_gnn(
        cfg, shape.d_feat, n_out, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(lr=GNN_TRAIN_LR)
    state = opt.init(model)
    step = gnn.make_gnn_train_step(cfg, opt, n_out=n_out)
    label = f"{arch} at {shape.name}"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b2.launch_count = b2.bwd_launch_count = 0
    history, times = [], []
    for _ in range(GNN_TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        model, state, metrics = step(model, state, batch)
        end.record()
        history.append(_host_metrics(metrics))     # one host read a step
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    launches = (b2.launch_count, b2.bwd_launch_count)
    peak = torch.cuda.max_memory_allocated()
    per_step = gnn.kernel_calls(cfg, e)
    want = (GNN_TRAIN_STEPS * per_step["B2"],
            GNN_TRAIN_STEPS * per_step["B2-bwd"])
    losses = [m["loss"] for m in history]
    ms = float(np.mean(times[1:]))
    log(f"gnn-train {label}: N {batch.num_nodes}, E {e}, d_feat "
        f"{shape.d_feat}, {cfg.n_layers} layers, d_hidden {cfg.d_hidden}, "
        f"n_out {n_out}, {n_params} parameters; "
        + "; ".join(f"step {i + 1} loss {m['loss']!r}, gnorm "
                    f"{m['gnorm']!r}, {t:.2f} ms"
                    for i, (m, t) in enumerate(zip(history, times)))
        + f"; B2 launches {launches[0]}, B2-bwd {launches[1]} (from the "
        f"structure {want[0]} and {want[1]}: {per_step} a step)")
    log(f"time gnn-train {label} (CUDA events, steps 2-{GNN_TRAIN_STEPS}): "
        f"{ms!r} ms a step, {e / ms * 1e3!r} edges/s; peak device memory "
        f"{peak} B ({card})")
    if launches != want:
        fail(f"GNN training {label}: B2/B2-bwd launches {launches}, the "
             f"structure gives {want}")
    if not all(np.isfinite(v) for m in history for v in m.values()):
        fail(f"GNN training {label}: a loss or gnorm is not finite")
    if not losses[-1] < losses[0]:
        fail(f"GNN training {label}: the loss did not fall over "
             f"{GNN_TRAIN_STEPS} steps")
    if shape.name.startswith("ogb") and peak > GNN_PEAK_LIMIT:
        fail(f"GNN training {label}: peak {peak} B above {GNN_PEAK_LIMIT}")

    # a step repeated from the same state, bit for bit
    model, state, m1, m2, same = repeated_step(step, model, state, batch)
    same = same and torch.equal(m1["loss"], m2["loss"])
    log(f"gnn-train {label} repeated step: parameters and loss "
        f"bit-identical {same} (loss {float(m1['loss'])!r})")
    if not same:
        fail(f"GNN training {label}: a step repeated from the same state "
             "gave other bits")
    if profile:
        profile_steps(lambda: step(model, state, batch),
                      f"gnn-train {label}", card,
                      names={"B2": B2_KERNELS, "B2-bwd": B2_BWD_KERNELS},
                      steps=profile)
    log(f"gnn-train {label}: {time.perf_counter() - t0:.1f} s")
    return {"ms": ms, "edges_per_s": e / ms * 1e3, "peak": peak,
            "launches": launches, "losses": losses}


def gnn_cpu_gate(dev) -> None:
    """Each GNN at its published widths with its depth cut to
    GNN_GATE_LAYERS, float32 (TF32 off), at full_graph_sm: the card's
    loss and every gradient leaf against the port's CPU path (the plain
    versions of B2 and B2-bwd) on the same parameters."""
    import copy
    import torch
    from repro_torch import data
    from repro_torch.configs import get
    from repro_torch.models import gnn
    shape = gnn_shapes()["full_graph_sm"]
    g_cpu = data.batch_for_shape(shape, seed=1, device="cpu")
    g_dev = g_cpu.to(dev)
    for arch in GNN_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get(arch), n_layers=GNN_GATE_LAYERS)
        n_out = cfg.n_vars or 16
        cpu = gnn.init_gnn(cfg, shape.d_feat, n_out, device="cpu",
                           generator=torch.Generator().manual_seed(1))
        card = copy.deepcopy(cpu).to(dev)
        results = []
        for model, g in ((card, g_dev), (cpu, g_cpu)):
            names, tensors = zip(*model.named_parameters())
            with model.trainable():
                loss = gnn.gnn_loss(model, cfg, g, n_out=n_out)
                grads = torch.autograd.grad(
                    loss, tensors, allow_unused=True, materialize_grads=True)
            results.append((float(loss.detach()), {n: x.detach().cpu()
                                          for n, x in zip(names, grads)}))
        (loss_d, grads_d), (loss_c, grads_c) = results
        total = float(torch.sqrt(sum(x.double().square().sum()
                                     for x in grads_c.values())))
        worst, worst_name, noise = 0.0, "", {}
        zero = gnn.ZERO_GRADIENT_LEAVES.get(arch, ())
        for name, x in grads_c.items():
            if zero and name.endswith(zero):
                noise[name] = (float(grads_d[name].norm()) / total,
                               float(x.norm()) / total)
                continue
            gap = float((grads_d[name] - x).norm()) / max(
                float(x.norm()), GNN_GATE_FLOOR * total)
            if gap > worst:
                worst, worst_name = gap, name
        loss_gap = abs(loss_d - loss_c) / abs(loss_c)
        log(f"gnn {arch} card vs CPU (depth {GNN_GATE_LAYERS}, full width, "
            f"float32, full_graph_sm): loss {loss_d!r} vs {loss_c!r} (gap "
            f"{loss_gap!r}); largest gradient gap {worst!r} ({worst_name}) "
            f"of {len(grads_c)} leaves; zero-gradient leaves' norms over "
            f"the whole gradient's (card, CPU) {noise}; "
            f"{time.perf_counter() - t0:.1f} s")
        if loss_gap > GNN_GATE_REL_L2 or worst > GNN_GATE_REL_L2:
            fail(f"GNN {arch}: the card's loss or gradients are more than "
                 f"{GNN_GATE_REL_L2} from the CPU path's")
        if any(max(v) > GNN_ZERO_GRAD_NORM for v in noise.values()):
            fail(f"GNN {arch}: a gradient that is zero in exact arithmetic "
                 f"is above {GNN_ZERO_GRAD_NORM} of the whole")
        del card, cpu, results, grads_d, grads_c
        torch.cuda.empty_cache()


def gnn_train_phase(dev, card) -> tuple[list[dict], float]:
    """Phase 15: B2 and B2-bwd at the GNNs' shapes against their plain
    versions; the four GNNs trained at full width and depth at
    full_graph_sm and molecule, graphcast at the ogb_products cut; the
    card against the CPU at depth 2; times. Returns the kernels line's
    GNN entries (B2 and B2-bwd at graphcast's ogb cut and at
    equiformer-v2's full_graph_sm) and graphcast's ms a step at the ogb
    cut."""
    import torch
    from repro_torch import data
    from repro_torch.configs import get
    t_phase = time.perf_counter()
    shapes = gnn_shapes()
    ogb = f"ogb_products/{GNN_OGB_CUT}"
    batches = {name: data.batch_for_shape(s, seed=0, device=dev)
               for name, s in shapes.items()}
    # the kernels at the widths each model gathers and aggregates
    checks = [("graphcast", name) for name in (*GNN_SHAPE_NAMES, ogb)]
    checks += [(arch, name) for arch in GNN_ARCHS[1:]
               for name in GNN_SHAPE_NAMES]
    errs = {}
    for arch, name in checks:
        g = batches[name]
        d = message_width(get(arch))
        errs[arch, name] = check_gnn_kernels(
            dev, f"{arch} {name} (d {d})", g.edge_dst, g.num_nodes, d,
            torch.bfloat16, weighted=True)
    g = batches["full_graph_sm"]
    nh = get("equiformer-v2").n_heads
    check_gnn_kernels(dev, f"the edge softmax, full_graph_sm (d {nh})",
                      g.edge_dst, g.num_nodes, nh, torch.float32,
                      weighted=False)
    log(f"phase 15 kernel checks: {time.perf_counter() - t_phase:.1f} s")

    cells = {}
    for arch in GNN_ARCHS:
        for name in GNN_SHAPE_NAMES:
            cells[arch, name] = gnn_train_cell(
                dev, card, arch, shapes[name], batches[name],
                # one step: its tens of thousands of launches a step make
                # the profiler's post-processing take about a minute for
                # two
                profile=int((arch, name) == ("equiformer-v2",
                                             "full_graph_sm")))
            torch.cuda.empty_cache()
    cells["graphcast", ogb] = gnn_train_cell(dev, card, "graphcast",
                                             shapes[ogb], batches[ogb],
                                             profile=2)
    torch.cuda.empty_cache()
    log("gnn-train summary (ms a step, edges/s, peak B): " + "; ".join(
        f"{a} {n}: {c['ms']:.2f}, {c['edges_per_s']:.4g}, {c['peak']}"
        for (a, n), c in cells.items()))
    gnn_cpu_gate(dev)

    entries = []
    for arch, name in (("graphcast", ogb), ("equiformer-v2",
                                            "full_graph_sm")):
        g = batches[name]
        entries += gnn_kernel_entries(
            dev, f"{arch}_{name.split('/')[0]}", g.edge_dst, g.edge_src,
            g.num_nodes, message_width(get(arch)), torch.bfloat16,
            cells[arch, name]["launches"], errs[arch, name], card)
    del batches
    log(f"phase 15 (GNN training): {time.perf_counter() - t_phase:.1f} s "
        f"({card})")
    return entries, cells["graphcast", ogb]["ms"]


# --------------------------------------------------------------- phase 16
# the PCPM-distributed GraphCast (models/gnn_dist.py) on phase 15's ogb
# cut graph, in a one-rank NCCL group (S = 1: every exchange a real NCCL
# all-to-all): (a) depth GNN_GATE_LAYERS, float32 without TF32, against
# graphcast_forward on the same edges in the layout's order, the forward
# within the reference test's tolerance and each gradient leaf within
# GNN_GATE_REL_L2; (b) graphcast at its published widths and depth in
# bfloat16 messages (float32 masters), DIST_TRAIN_STEPS steps of
# AdamW(lr=1e-3), step 1 held against the single-device step within
# GNN_GATE_REL_L2 (the losses are near 1e14 at this depth and width, so
# that they fall shows little)
DIST_TRAIN_STEPS = 4
DIST_FWD_TOL = dict(rtol=2e-4, atol=2e-5)


def layout_batch(layout, batch):
    """A ``GraphBatch`` of ``batch``'s nodes over a one-shard layout's
    edges in the layout's order (source ``send_ids[0, 0][edge_upd]``), so
    that ``graphcast_forward`` sums each destination's edges in the order
    the distributed forward does."""
    import torch
    if not (layout.num_shards == 1 and (layout.edge_dst[0]
                                        < layout.shard_size).all()):
        fail("gnn-dist: the layout is not one shard without pad edges")
    dev = batch.edge_src.device
    src = layout.send_ids[0, 0][layout.edge_upd[0]]
    e = src.shape[0]
    return dataclasses.replace(
        batch, edge_src=torch.from_numpy(src).to(dev),
        edge_dst=torch.from_numpy(layout.edge_dst[0].copy()).to(dev),
        edge_mask=torch.ones(e, dtype=torch.float32, device=dev))


def gnn_dist_gate(dev, layout, dg, mesh, batch) -> None:
    """Part (a): the distributed forward, loss and gradients against
    ``graphcast_forward`` and ``gnn_loss`` on the same edges, at depth
    GNN_GATE_LAYERS, published width, float32."""
    import torch
    from repro_torch.configs import get
    from repro_torch.models import gnn, gnn_dist
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get("graphcast"), n_layers=GNN_GATE_LAYERS)
    n_out = cfg.n_vars or 16
    model = gnn.init_gnn(cfg, batch.node_feat.shape[1], n_out, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    gb = layout_batch(layout, batch)
    with torch.no_grad():
        got = gnn_dist.graphcast_dist_forward(model, cfg, dg, mesh)
        want = gnn.graphcast_forward(model.tree, cfg, gb)
    gap = float((got - want).abs().max())
    same = torch.equal(got, want)
    close = torch.allclose(got, want, **DIST_FWD_TOL)
    scale = float(want.abs().max())
    del got, want
    names, tensors = zip(*model.named_parameters())
    with model.trainable():
        loss_s = gnn.gnn_loss(model, cfg, gb, n_out=n_out)
        grads_s = torch.autograd.grad(loss_s, tensors)
    loss_s, grads_s = loss_s.detach(), dict(zip(names, grads_s))
    loss_d, grads_d = gnn_dist.dist_loss_and_grads(model, cfg, dg, mesh)
    total = float(torch.sqrt(sum(x.double().square().sum()
                                 for x in grads_s.values())))
    worst, worst_name = 0.0, ""
    for name, x in grads_s.items():
        rel = float((grads_d[name] - x).norm()) / max(
            float(x.norm()), GNN_GATE_FLOOR * total)
        if rel > worst:
            worst, worst_name = rel, name
    loss_gap = abs(float(loss_d) - float(loss_s)) / abs(float(loss_s))
    log(f"gnn-dist gate (depth {GNN_GATE_LAYERS}, d {cfg.d_hidden}, "
        f"float32, one rank): forward max_abs_err {gap!r} on outputs up to "
        f"{scale!r} (bit-equal {same}, within rtol "
        f"{DIST_FWD_TOL['rtol']} atol {DIST_FWD_TOL['atol']}: {close}); "
        f"loss {float(loss_d)!r} vs {float(loss_s)!r} (gap {loss_gap!r}); "
        f"largest gradient gap {worst!r} ({worst_name}) of {len(names)} "
        f"leaves; {time.perf_counter() - t0:.1f} s")
    if not close:
        fail("gnn-dist: the distributed forward is not within the "
             "reference test's tolerance of graphcast_forward")
    if loss_gap > GNN_GATE_REL_L2 or worst > GNN_GATE_REL_L2:
        fail(f"gnn-dist: the loss or a gradient leaf is more than "
             f"{GNN_GATE_REL_L2} from the single-device path's")


def step_one_gaps(model, single, init, m_dist, m_single) -> tuple:
    """Step 1 of the distributed path against the single-device step on
    the same edges from the same parameters and moments: (bit-equal,
    the loss's and gnorm's relative gaps, the largest of the parameter
    updates' relative L2 gaps and its leaf). ``init`` holds the
    parameters before the step."""
    import torch
    rel = {k: abs(float(m_dist[k]) - float(m_single[k]))
           / abs(float(m_single[k])) for k in ("loss", "gnorm")}
    same = all(torch.equal(m_dist[k], m_single[k]) for k in rel)
    worst, worst_name = 0.0, ""
    dist_p = dict(model.named_parameters())
    for name, p in single.named_parameters():
        same = same and torch.equal(dist_p[name], p)
        want = p.detach() - init[name]
        gap = float((dist_p[name].detach() - init[name] - want).norm()) / max(
            float(want.norm()), 1e-30)
        if gap > worst:
            worst, worst_name = gap, name
    return same, rel, worst, worst_name


def gnn_dist_phase(dev, card, ogb_ms) -> None:
    """Phase 16: the PCPM-distributed GraphCast in a one-rank NCCL group
    on phase 15's ogb cut graph. (a) ``gnn_dist_gate``; (b) graphcast at
    its published widths and depth, bfloat16 messages, DIST_TRAIN_STEPS
    steps: step 1 against the single-device step (``step_one_gaps``),
    losses finite and falling, a repeated step bit-identical, B2
    and B2-bwd launches and the mesh's collectives as
    ``dist_kernel_calls`` and ``dist_collective_calls`` count them, the
    peak under GNN_PEAK_LIMIT. Prints ms a step and edges/s beside phase
    15's graphcast step at the same cut (``ogb_ms``), the host seconds of
    ``build_sharded_png`` and the model-flops rate."""
    import torch
    from repro_torch import data
    from repro_torch.configs import get
    from repro_torch.core.distributed import (build_mesh,
                                              build_sharded_png)
    from repro_torch.graphs.formats import Graph
    from repro_torch.kernels.embedding_bag import kernel as b2
    from repro_torch.launch.specs import gnn_model_flops
    from repro_torch.models import gnn, gnn_dist
    from repro_torch.optim import AdamW
    from repro_torch.train.trainer import _host_metrics
    t_phase = time.perf_counter()
    shape = gnn_shapes()[f"ogb_products/{GNN_OGB_CUT}"]
    batch = data.batch_for_shape(shape, seed=0, device=dev)
    n, e = batch.num_nodes, batch.edge_src.shape[0]
    g = Graph(n, batch.edge_src.cpu().numpy(), batch.edge_dst.cpu().numpy())
    with OneRankGroup(dev):
        t0 = time.perf_counter()
        layout = build_sharded_png(g, 1)
        png_s = time.perf_counter() - t0
        mesh = build_mesh(1, device=dev)
        dg = gnn_dist.DistGraph.from_png(
            layout, batch.node_feat.cpu().numpy(),
            batch.positions.cpu().numpy(), batch.labels.cpu().numpy(),
            mesh=mesh)
        log(f"gnn-dist at ogb_products/{GNN_OGB_CUT} (N {n}, E {e}): "
            f"build_sharded_png {png_s!r} s on the host (one shard: U "
            f"{dg.u_max}, E_max {dg.e_max}); mesh {mesh.num_shards} rank, "
            f"NCCL")
        gnn_dist_gate(dev, layout, dg, mesh, batch)
        torch.cuda.empty_cache()

        # (b) full width and depth, bfloat16 messages
        cfg = dataclasses.replace(get("graphcast"), act_dtype="bfloat16")
        n_out = cfg.n_vars or 16
        model = gnn.init_gnn(
            cfg, shape.d_feat, n_out, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        opt = AdamW(lr=GNN_TRAIN_LR)
        state = opt.init(model)
        step = gnn_dist.make_dist_train_step(cfg, opt, mesh, n_out=n_out)
        # step 1 of the single-device path on the same edges, from the
        # same parameters (seed 0) and moments: at S = 1 the exchange is a
        # copy, so the distributed step 1 must give the same loss, gnorm
        # and parameters
        init = {k: p.detach().clone() for k, p in model.named_parameters()}
        single = gnn.init_gnn(
            cfg, shape.d_feat, n_out, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        single, _, m_single = gnn.make_gnn_train_step(cfg, opt, n_out=n_out)(
            single, opt.init(single), layout_batch(layout, batch))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        b2.launch_count = b2.bwd_launch_count = 0
        mesh.counts.clear()
        history, times = [], []
        for _ in range(DIST_TRAIN_STEPS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            model, state, metrics = step(model, state, dg)
            end.record()
            history.append(_host_metrics(metrics))   # one host read a step
            times.append(start.elapsed_time(end))
            if single is not None:
                held = step_one_gaps(model, single, init, metrics, m_single)
                single = init = None
        torch.cuda.synchronize()
        launches = {"B2": b2.launch_count, "B2-bwd": b2.bwd_launch_count}
        counts = dict(mesh.counts)
        peak = torch.cuda.max_memory_allocated()
        want = {k: DIST_TRAIN_STEPS * v for k, v in
                gnn_dist.dist_kernel_calls(cfg).items()}
        want_counts = {k: DIST_TRAIN_STEPS * v for k, v in
                       gnn_dist.dist_collective_calls(cfg).items() if v}
        losses = [m["loss"] for m in history]
        ms = float(np.mean(times[1:]))
        flops = gnn_model_flops(cfg, e)
        log(f"gnn-dist train graphcast at ogb_products/{GNN_OGB_CUT}: "
            f"{cfg.n_layers} layers, d_hidden {cfg.d_hidden}, n_out {n_out}, "
            f"bfloat16 messages; "
            + "; ".join(f"step {i + 1} loss {m['loss']!r}, gnorm "
                        f"{m['gnorm']!r}, {t:.2f} ms"
                        for i, (m, t) in enumerate(zip(history, times)))
            + f"; launches {launches} (from the structure {want}); "
            f"collectives {counts} (from the structure {want_counts})")
        same1, rel1, worst1, worst1_name = held
        log(f"gnn-dist step 1 against the single-device step on the same "
            f"edges (full width and depth, bfloat16 messages): bit-equal "
            f"{same1}; loss {history[0]['loss']!r} vs "
            f"{float(m_single['loss'])!r} (relative gap {rel1['loss']!r}), "
            f"gnorm {history[0]['gnorm']!r} vs {float(m_single['gnorm'])!r} "
            f"(relative gap {rel1['gnorm']!r}); largest parameter update "
            f"gap {worst1!r} (relative L2, {worst1_name})")
        log(f"time gnn-dist train graphcast ogb_products/{GNN_OGB_CUT} (CUDA "
            f"events, steps 2-{DIST_TRAIN_STEPS}): {ms!r} ms a step, "
            f"{e / ms * 1e3!r} edges/s (phase 15's graphcast step at the "
            f"same cut: {ogb_ms!r} ms); peak device memory {peak} B; model "
            f"flops 6·E·d²·L = {flops!r} a step, {flops / ms * 1e3!r} "
            f"FLOP/s, {flops / ms * 1e3 / PEAK_BF16_PER_S!r} of the "
            f"bfloat16 peak {PEAK_BF16_PER_S!r} ({card})")
        if launches != want:
            fail(f"gnn-dist: B2/B2-bwd launches {launches}, the structure "
                 f"gives {want}")
        if counts != want_counts:
            fail(f"gnn-dist: collectives {counts}, the structure gives "
                 f"{want_counts}")
        if max(*rel1.values(), worst1) > GNN_GATE_REL_L2:
            fail(f"gnn-dist: step 1's loss, gnorm or a parameter update is "
                 f"more than {GNN_GATE_REL_L2} from the single-device "
                 f"step's")
        if not all(np.isfinite(v) for m in history for v in m.values()):
            fail("gnn-dist: a loss or gnorm is not finite")
        if not losses[-1] < losses[0]:
            fail(f"gnn-dist: the loss did not fall over {DIST_TRAIN_STEPS} "
                 "steps")
        if peak > GNN_PEAK_LIMIT:
            fail(f"gnn-dist: peak {peak} B above {GNN_PEAK_LIMIT}")
        model, state, m1, m2, same = repeated_step(step, model, state, dg)
        same = same and torch.equal(m1["loss"], m2["loss"])
        log(f"gnn-dist repeated step: parameters and loss bit-identical "
            f"{same} (loss {float(m1['loss'])!r})")
        if not same:
            fail("gnn-dist: a step repeated from the same state gave other "
                 "bits")
        del model, state, step, dg, layout
    torch.cuda.empty_cache()
    log(f"phase 16 (PCPM-distributed GraphCast): "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")


class PhaseClock:
    """Wall seconds of each phase of ``main``: ``done(name)`` logs the
    seconds since the last mark, ``summary()`` all of them."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.seconds = {}

    def done(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.t, 1)
        self.t = now
        log(f"phase {name} ended: {self.seconds[name]} s of wall time")

    def summary(self) -> None:
        log(f"phase seconds: {self.seconds}; in all "
            f"{time.perf_counter() - self.t0:.1f} s")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs on a "
             "CUDA card")
    from repro_torch.kernels import build_all
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    clock = PhaseClock()
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
    clock.done("1 (build)")

    # ---------------------------------------------------- 2. B1 checks
    check_b1_test_shapes(dev)
    clock.done("2 (B1 checks)")
    # ---------------------------------------------------- 3-4. PageRank
    tile_entry, warp_timed, reuse = pagerank_phases(dev, card)
    torch.cuda.empty_cache()
    clock.done("3-4 (PageRank)")
    # ---------------------------------------------------- 5. PageRank serving
    kernels = [tile_entry, serving_phase(dev, card, reuse, warp_timed)]
    torch.cuda.empty_cache()
    clock.done("5 (PageRank serving)")
    # ---------------------------------------------------- 6. streaming
    streamed = streaming_phase(dev, card, reuse, *kernels)
    torch.cuda.empty_cache()
    clock.done("6 (streaming)")
    # ---------------------------------------------------- 6b. reliability
    reliability_phase(dev, card, reuse, streamed, *kernels)
    torch.cuda.empty_cache()
    clock.done("6b (reliability)")
    # ---------------------------------------------------- 6c. ingest
    ingest_phase(dev, card, *kernels)
    torch.cuda.empty_cache()
    clock.done("6c (ingest)")
    # ---------------------------------------------------- 7. the gateway
    gateway_phase(dev, card, reuse, streamed, *kernels)
    torch.cuda.empty_cache()
    clock.done("7 (gateway)")
    # ---------------------------------------------------- 7b. sharded
    sharded_phase(dev, card, reuse)
    # the version chain's cached plans (host arrays, and the first graph's
    # plans of the four engines with their uploads) go with phases 6-7
    from repro_torch.core.plan import evict_plans
    evict_plans(reuse["g"])
    del streamed, reuse
    torch.cuda.empty_cache()
    clock.done("7b (sharded)")
    # ---------------------------------------------------- 8. B3 checks
    b3_cases = check_b3_shapes(dev)
    clock.done("8 (B3 checks)")
    # ---------------------------------------------------- 9-10. LM serving
    kernels += lm_phases(dev, card, b3_cases)
    torch.cuda.empty_cache()
    clock.done("9-10 (LM serving)")
    # ---------------------------------------------------- 10b. MoE, SWA LMs
    kernels += moe_phases(dev, card, b3_cases)
    del b3_cases
    torch.cuda.empty_cache()
    clock.done("10b (MoE and SWA)")
    # ---------------------------------------------------- 11. B2 checks
    check_b2_shapes(dev)
    check_b2_views(dev)
    # ---------------------------------------------------- 11-12. MIND serving
    kernels += mind_phases(dev, card)
    torch.cuda.empty_cache()
    clock.done("11-12 (B2, MIND serving)")
    # ---------------------------------------------------- 13. LM training
    kernels += train_phase(dev, card, check_b3_bwd_shapes(dev))
    torch.cuda.empty_cache()
    clock.done("13 (LM training)")
    # ---------------------------------------------------- 14. MIND training
    kernels += mind_train_phase(dev, card)
    torch.cuda.empty_cache()
    clock.done("14 (MIND training)")
    # ---------------------------------------------------- 15. GNN training
    gnn_entries, ogb_ms = gnn_train_phase(dev, card)
    kernels += gnn_entries
    torch.cuda.empty_cache()
    clock.done("15 (GNN training)")
    # ---------------------------------------------------- 16. gnn_dist
    gnn_dist_phase(dev, card, ogb_ms)
    clock.done("16 (PCPM-distributed GraphCast)")
    clock.summary()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
