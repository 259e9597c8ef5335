"""count_coalesce_ms: host time of the program's `count.coalesce` spans
(turingassembler_tpu_torch/tracing.py: joining the batches into a
record) less their `source_ns` counts (the wait on the batches), in the
traced window, ms a job.  0 when the count ran and made no record."""


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
    ns = sum(r[5] - r[4] - r[6].get("source_ns", 0) for r in recs
             if r[2] == "count.coalesce")
    return 1e-6 * ns / view.jobs
