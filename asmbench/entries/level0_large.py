"""level0_large: level0's job (the count of canonical (k0+1)-mers and the
level-0 unitig build, entries/level0.py, unchanged) on a library too
large for the plain reference to hold at once, judged by the reference
in blocks (reference/kmers_blocked.py): the same table and graph, made a
partition of the rows and a block of k-edges at a time.  Judged as
level0 judges: the table after the cutoff and the graph of a sample of
the window's jobs, drawn from the seed."""

from __future__ import annotations

import sys
import time

from asmbench.entries import level0
from asmbench.reference import compare
from asmbench.reference import kmers_blocked as kb
from asmbench.reference import unitigs

program, setup, job, reads, release = (level0.program, level0.setup,
                                       level0.job, level0.reads,
                                       level0.release)
LIMITS = level0.LIMITS


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def control(config, mix, libs, device) -> dict:
    """level0's control in blocks: (k0+1)-mers told apart by a 32-bit
    fingerprint, within each partition of the rows, before the cutoff."""
    rows, counts, g = kb.table_and_graph(
        libs[0], config["k0"], config["min_kmer_count"], device,
        fingerprinted=True)
    return {0: [(0, rows, counts, "reference",
                 compare.ProgramGraph.from_reference(g))]}


def check(config, mix, libs, judged, device):
    """({number: worst reading over the judged jobs}, jobs judged wrong)."""
    k = config["k0"]
    worst = dict.fromkeys(LIMITS, 0)
    failed = 0
    for lib, items in judged.items():
        t = time.perf_counter()
        rows, counts, g = kb.table_and_graph(
            libs[lib], k, config["min_kmer_count"], device)
        rk = unitigs.keys(g)
        _log(f"library {lib}: the reference's {len(rows)} k-edges and "
             f"{g.n} unitigs in {time.perf_counter() - t:.3f} s")
        for _, pr, pc, layout, pg in items:
            t = time.perf_counter()
            if layout == "program":
                pr, pc = kb.program_table(pr, pc, k + 1, device)
            got = {"kmers_wrong": compare.kmers_wrong(pr, pc, rows, counts)}
            del pr, pc
            got["unitigs_wrong"], got["links_wrong"], _ = \
                compare.graph_wrong(pg, g, rk)
            _log(f"library {lib}: compared in "
                 f"{time.perf_counter() - t:.3f} s: {got}")
            failed += any(got[n] > LIMITS[n] for n in LIMITS)
            for n in LIMITS:
                worst[n] = max(worst[n], got[n])
        del rows, counts, g, rk
    return worst, failed
