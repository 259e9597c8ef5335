"""device_idle_pct: the share of the traced window (first job's start to
last job's end) in which no kernel, memset or copy runs, percent."""


def read(view):
    return view.idle_pct()
