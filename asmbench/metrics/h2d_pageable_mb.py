"""h2d_pageable_mb: bytes the program copied to the card from pageable
host memory (`count.ship` and `map.ship` spans with `pageable` 1,
turingassembler_tpu_torch/tracing.py) in the traced window, MB (10^6
bytes) a job.  0 when the count or the map ran and copied nothing
pageable."""


def read(view):
    try:
        from turingassembler_tpu_torch import tracing
    except ImportError:                  # a program without the tracer
        return None
    w = view.window()
    recs = [r for r in tracing.records()
            if w and w[0] <= r[4] * 1e-9 and r[5] * 1e-9 <= w[1]]
    if not any(r[2] in ("count", "map") for r in recs):
        return None
    return 1e-6 * sum(r[6].get("bytes", 0) for r in recs
                      if r[2] in ("count.ship", "map.ship")
                      and r[6].get("pageable")) / view.jobs
