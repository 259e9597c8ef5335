"""count_syncs: host syncs (pulls, .item(), a mask's nonzero) the program
counts in its `count` span and every `count.*` span below it
(turingassembler_tpu_torch/tracing.py) in the traced window, a job."""


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
    return sum(r[6].get("syncs", 0) for r in recs
               if r[2].split(".")[0] == "count") / view.jobs
