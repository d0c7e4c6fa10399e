#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone, on one CUDA card: kernel B2-bwd
against its plain backward (TestEmbeddingBag's shapes, pads, a negative
id, bfloat16, one row read by 300,000 ids), then MIND training at the
reference's train_batch cell (B 65,536, vocab 10M, d 64) and B2-bwd's
times.

    python3 tools/mind_train_phase.py      # from the root of a checkout

Prints the phase's lines and B2-bwd's entry of the kernels line. Exits
non-zero where a gate fails.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
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
        for name, props in cs.ptxas_report(built.log):
            cs.log(f"  ptxas {name}: {props}")
    entries = cs.mind_train_phase(torch.device("cuda"), card)
    cs.log(f"mind_train_phase.py: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)


if __name__ == "__main__":
    main()
