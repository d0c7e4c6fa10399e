#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone, on one CUDA card: the
PCPM-distributed GraphCast (``models/gnn_dist.py``) in a one-rank NCCL
group on phase 15's ogb_products cut, (a) against ``graphcast_forward``
at depth 2 in float32, (b) trained at its published widths and depth in
bfloat16 messages, with its times.

    python3 tools/gnn_dist_phase.py [--single]   # from a checkout's root

``--single`` first trains the single-device graphcast cell of phase 15 at
the same cut (``gnn_train_cell``), so both steps are timed in one call.
Prints the phase's lines; exits non-zero where a gate fails.
"""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--single", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    from repro_torch import data
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
    ogb_ms = None
    if args.single:
        name = f"ogb_products/{cs.GNN_OGB_CUT}"
        shape = cs.gnn_shapes()[name]
        batch = data.batch_for_shape(shape, seed=0, device=dev)
        ogb_ms = cs.gnn_train_cell(dev, card, "graphcast", shape,
                                   batch)["ms"]
        del batch
        torch.cuda.empty_cache()
    cs.gnn_dist_phase(dev, card, ogb_ms)
    cs.log(f"gnn_dist_phase.py: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
