"""Readings of a cell's compared numbers for its control, over many
seeds in one process: the reference in the program's place with one
guarantee of the configuration broken (entries/<entry>.py:control).  The
limits of entries/<entry>.py:LIMITS lie between these readings and the
program's, which are the `checks` of the benchmark's own runs
(asmbench/run.py); those runs never run the control.

    python3 asmbench/control.py --workload <name> --seeds 1 2 3

prints a JSON object a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def reading(cell_name: str, seed: int, *, device: str = "cuda",
            bench: dict | None = None, roots=None) -> dict:
    """The worst of each compared number for one seed, with the control
    in the program's place."""
    import torch

    from asmbench import library, spec
    roots = roots or (spec.HERE,)
    _, config, mix, entry = spec.load_cell(
        cell_name, bench or spec.benchmark(), roots)
    dev = torch.device(device)
    t = time.perf_counter()
    libs = library.make_libraries(config, seed, mix["libraries"], dev)
    judged = entry.control(config, mix, libs, dev)
    worst, failed = entry.check(config, mix, libs, judged, dev)
    return {"workload": cell_name, "seed": seed, "side": "control",
            "numbers": worst, "limits": entry.LIMITS, "failed": failed,
            "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="asmbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for s in args.seeds:
        print(json.dumps(reading(args.workload, s)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
