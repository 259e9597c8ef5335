"""merge_ms: host wall of the program's `count.merge` spans
(turingassembler_tpu_torch/tracing.py: merge_runs of a flush's table into
the running one) in the traced window, ms a job.  The merge syncs once,
after its count pass; its write pass runs on after the span closes, so
the wall is the host's part and the count pass.  0 when the count ran
and merged nothing (one flush a job)."""


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
    ns = sum(r[5] - r[4] for r in recs if r[2] == "count.merge")
    return 1e-6 * ns / view.jobs
