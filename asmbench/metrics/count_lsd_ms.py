"""count_lsd_ms: host wall of the program's `count.sort.lsd` spans
(turingassembler_tpu_torch/tracing.py: sort_count's loop over the buckets
over a block's capacity) in the traced window, ms a job.  The loop syncs
with the card at every bucket, so its wall covers its device work.  0
when the count ran and no bucket was over capacity."""


def read(view):
    try:
        from turingassembler_tpu_torch import tracing
    except ImportError:                  # a program without the tracer
        return None
    w = view.window()
    recs = [r for r in tracing.records()
            if w and w[0] <= r[4] * 1e-9 and r[5] * 1e-9 <= w[1]]
    if not any(r[2] == "count" for r in recs):
        return None
    ns = sum(r[5] - r[4] for r in recs if r[2] == "count.sort.lsd")
    return 1e-6 * ns / view.jobs
