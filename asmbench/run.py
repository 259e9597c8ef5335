"""Run one cell of the benchmark once on the card:

    python3 asmbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

(or `python3 -m asmbench.run ...`) from the root of a checkout.  Prints
diagnostics and, as its last lines, each number compared beside its
limit on standard error, and one JSON object as the last line of
standard output.  Exits non-zero with no result when no card (or fewer
than the cell asks for) is visible, or when a module of the JAX stack or
of the JAX package is loaded once the run is over.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="asmbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from asmbench import harness, spec
    bench = spec.benchmark()
    chips = spec.cell(args.workload, bench)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"no result: the cell needs {chips} card(s), "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    res = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench, t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"no result: loaded {', '.join(bad)}")
        return 3
    for name, c in res["checks"].items():
        harness.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
