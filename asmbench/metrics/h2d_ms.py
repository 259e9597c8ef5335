"""h2d_ms: device time of the host-to-card copies a job (the profiler's
HtoD memcpy events inside the traced window), ms."""


def read(view):
    return view.copy_ms("HtoD")
