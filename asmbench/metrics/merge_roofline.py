"""merge_roofline: the count's merges' least time over their device
time in the traced window, percent.

Least time: each merge's bytes (roofline/merge.py: its `count.merge`
span's rows_in read and rows_out written, a counted (k1)-mer a row, k1
from the span's `count` root) over roofline/peaks.py.  Device time: the
busy time of merge_runs' own kernels (csrc/kmer_sort.cu's
merge_split_kernel and merge_kernel, its count and write passes), known
by name: the write pass is launched with no sync after it, so it runs on
after its `count.merge` span closes, and the busy time inside the spans
would leave it out.  None without the tracer's counts (a program that
does not count a merge's rows) or where no merge ran."""

import re

from asmbench import trace
from asmbench.roofline import merge, peaks

KERNEL = re.compile(r"\bmerge_(split_)?kernel\b")


def read(view):
    try:
        from turingassembler_tpu_torch import tracing
    except ImportError:                  # a program without the tracer
        return None
    w = view.window()
    if w is None:
        return None
    recs = [r for r in tracing.records()
            if w[0] <= r[4] * 1e-9 and r[5] * 1e-9 <= w[1]]
    k1 = {r[0]: r[6].get("k1") for r in recs if r[2] == "count"}
    least = 0.0
    for r in recs:
        if r[2] != "count.merge":
            continue
        c = r[6]
        if "rows_in" not in c or "rows_out" not in c or not k1.get(r[1]):
            return None
        least += peaks.least_time(*merge.merge(c["rows_in"], c["rows_out"],
                                               k1[r[1]]))[0]
    busy = trace.measure(trace.union(
        (s, e) for n, s, e in view.device
        if KERNEL.search(n) and w[0] <= s and e <= w[1]))
    if not least or busy <= 0:
        return None
    return 100.0 * least / busy
