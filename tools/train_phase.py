#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone, on one CUDA card: kernel B3-bwd
against its plain version (TestFlashAttention's shapes, tinyllama's and
mixtral's training shapes), then LM training (tinyllama-1.1b at its
widths, the whole model's gradient two ways, the restart drill, a
compressed step, mixtral-8x7b with its depth cut) and B3-bwd's times.

    python3 tools/train_phase.py      # from the root of a checkout

Prints the phase's lines and B3-bwd's entry of the kernels line. Exits
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
    from repro_torch.kernels.flash_attention import kernel as b3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card} (torch {torch.__version__}, CUDA "
           f"{torch.version.cuda})")
    t0 = time.perf_counter()
    for built in _build.build(b3.SOURCE, b3.BWD_SOURCE):
        cs.log(f"build: {built.path.name} took {built.seconds:.2f} s")
        for name, props in cs.ptxas_report(built.log):
            cs.log(f"  ptxas {name}: {props}")
    dev = torch.device("cuda")
    entries = cs.train_phase(dev, card, cs.check_b3_bwd_shapes(dev))
    cs.log(f"train_phase.py: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)


if __name__ == "__main__":
    main()
