"""count_ms: mean host wall of a job's count spans, ms (each span ends in
a device sync)."""


def read(view):
    return view.span_mean_ms("count")
