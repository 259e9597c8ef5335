"""Time the NW alignment kernel of one or more checkouts on one GPU.

    python3 chip_nw_bench.py [ROOT ...]

Each ROOT (default: this directory) is a checkout that holds
turingassembler_tpu_torch/; its kernel is built and timed in a process
of its own, in the order given, on the same inputs (chip_smoke.py's
generators, seeded).  To compare two commits, unpack the other one with
`git archive` into a git-ignored directory and name the roots in turns:

    python3 chip_nw_bench.py build/parent . . build/parent

Shapes: the map's remainder DP (B=65,536, Lq=152, Lt=184, fit, BWA
scoring) and the bubble check's (global, bubble scoring) with many
narrow pairs (B=4,096, L=256) and few wide ones (B=32, L=1,024).  One
line a shape: milliseconds by CUDA events over 20 launches after a
warm-up, and G cells/s over the qlen * (tlen + 1) cells of the inputs.
"""

from __future__ import annotations

import os
import subprocess
import sys

def time_root(root: str) -> None:
    import numpy as np
    import torch

    import chip_smoke                 # this directory's input generators
    sys.path.insert(0, os.path.abspath(root))
    from turingassembler_tpu_torch.ops import dp, nw_align

    rng = np.random.default_rng(0)
    shapes = (
        ("map B=65536 Lq=152 Lt=184 fit bwa",
         chip_smoke.map_shape_pairs(rng, 65_536), dp.SCORING_BWA, "fit"),
        ("bubble B=4096 L=256 global bubble",
         chip_smoke.bubble_pairs(rng, 4_096, 256), dp.SCORING_BUBBLE,
         "global"),
        ("bubble B=32 L=1024 global bubble",
         chip_smoke.bubble_pairs(rng, 32, 1_024), dp.SCORING_BUBBLE,
         "global"),
    )
    for name, arrs, sc, mode in shapes:
        q, ql, t, tl = (torch.as_tensor(a).cuda() for a in arrs)
        ms = chip_smoke.cuda_ms(lambda: nw_align.banded_affine_score(
            q, ql, t, tl, *sc, mode=mode), 20)
        cells = int((ql.long() * (tl.long() + 1)).sum())
        print(f"{root}: {name}: {ms:.4f} ms, {cells / ms / 1e6:.1f} G cells/s",
              flush=True)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        time_root(sys.argv[2])
        return
    import chip_smoke
    chip_smoke.device_info()
    for root in sys.argv[1:] or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True, timeout=600)


if __name__ == "__main__":
    main()
