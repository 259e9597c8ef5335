"""rank_ms: host wall of the program's `build.rank` spans
(turingassembler_tpu_torch/tracing.py: rank_chains and the pull of its
scalars) in the traced window, ms a job.  The span ends in that pull, so
its wall covers the ranking's device work and what the build queued
before it.  None where no build ran in the window."""


def read(view):
    try:
        from turingassembler_tpu_torch import tracing
    except ImportError:                  # a program without the tracer
        return None
    w = view.window()
    recs = [r for r in tracing.records()
            if w and w[0] <= r[4] * 1e-9 and r[5] * 1e-9 <= w[1]]
    if not any(r[2] == "build" for r in recs):
        return None
    ns = sum(r[5] - r[4] for r in recs if r[2] == "build.rank")
    return 1e-6 * ns / view.jobs
