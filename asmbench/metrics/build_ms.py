"""build_ms: mean host wall of a job's build spans, ms (each span ends in
a device sync)."""


def read(view):
    return view.span_mean_ms("build")
