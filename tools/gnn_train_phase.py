#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` alone, on one CUDA card: kernels B2 and
B2-bwd at the GNNs' shapes against their plain versions, the four GNNs
trained at their published widths and depths (full_graph_sm, molecule,
graphcast at the ogb_products cut), the card against the CPU path at
depth 2, and B2's and B2-bwd's times.

    python3 tools/gnn_train_phase.py      # from the root of a checkout

Prints the phase's lines and its entries of the kernels line. Exits
non-zero where a gate fails.

    python3 tools/gnn_train_phase.py --peak-probe 16 32 64

first runs one graphcast training step (bf16 messages, published widths)
at ogb_products with nodes and edges divided by each number given, and
prints each step's peak device memory (or that it ran out of memory),
the measurement behind ``chip_smoke.GNN_OGB_CUT``.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def peak_probe(dev, cuts) -> None:
    """One graphcast step at ogb_products / cut for each cut: its peak."""
    from repro_torch import data
    from repro_torch.configs import GNN_SHAPES, get
    from repro_torch.models import gnn
    from repro_torch.optim import AdamW
    card = cs.card_line()
    ogb = {s.name: s for s in GNN_SHAPES}["ogb_products"]
    cfg = dataclasses.replace(get("graphcast"), act_dtype="bfloat16")
    for cut in cuts:
        shape = dataclasses.replace(ogb, n_nodes=ogb.n_nodes // cut,
                                    n_edges=ogb.n_edges // cut)
        g = data.batch_for_shape(shape, seed=0, device=dev)
        model = gnn.init_gnn(cfg, shape.d_feat, cfg.n_vars, device=dev)
        opt = AdamW(lr=cs.GNN_TRAIN_LR)
        state = opt.init(model)
        step = gnn.make_gnn_train_step(cfg, opt, n_out=cfg.n_vars)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            step(model, state, g)
            torch.cuda.synchronize()
            cs.log(f"peak probe graphcast ogb_products/{cut} (N "
                   f"{shape.n_nodes}, E {shape.n_edges}): peak "
                   f"{torch.cuda.max_memory_allocated()} B, one step "
                   f"{time.perf_counter() - t0:.2f} s ({card})")
        except torch.OutOfMemoryError as err:
            cs.log(f"peak probe graphcast ogb_products/{cut}: out of "
                   f"memory ({str(err).splitlines()[0][:160]})")
        del model, state, step, g, opt
        torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--peak-probe", type=int, nargs="*", default=[])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import kernel as b2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card} (torch {torch.__version__}, CUDA "
           f"{torch.version.cuda})")
    t0 = time.perf_counter()
    for built in _build.build(b2.SOURCE):
        cs.log(f"build: {built.path.name} took {built.seconds:.2f} s")
    dev = torch.device("cuda")
    if args.peak_probe:
        peak_probe(dev, args.peak_probe)
    entries, _ = cs.gnn_train_phase(dev, card)
    cs.log(f"gnn_train_phase.py: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)


if __name__ == "__main__":
    main()
