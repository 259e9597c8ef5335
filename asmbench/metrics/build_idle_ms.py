"""build_idle_ms: the card's idle time inside the program's `build` spans
(turingassembler_tpu_torch/tracing.py) of the traced window, ms a job:
their union's length less the device-busy time within it."""

from asmbench import trace


def read(view):
    try:
        from turingassembler_tpu_torch import tracing
    except ImportError:                  # a program without the tracer
        return None
    w = view.window()
    iv = [(r[4] * 1e-9, r[5] * 1e-9) for r in tracing.records()
          if r[2] == "build"]
    iv = trace.union((s, e) for s, e in iv if w and w[0] <= s and e <= w[1])
    if not iv:
        return None
    idle = trace.measure(iv) - trace.measure(view.busy(iv))
    return 1e3 * idle / view.jobs
