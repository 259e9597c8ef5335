"""map_dp_pct: the reads the program's map sent to the DP (`pairs` of its
`map.dp` spans, turingassembler_tpu_torch/tracing.py: voted lanes the
gapless bound did not accept) over the reads it mapped (`mapped` of its
`map` spans), in the traced window, percent.  0 when the map ran and
mapped nothing."""


def read(view):
    try:
        from turingassembler_tpu_torch import tracing
    except ImportError:                  # a program without the tracer
        return None
    w = view.window()
    recs = [r for r in tracing.records()
            if w and w[0] <= r[4] * 1e-9 and r[5] * 1e-9 <= w[1]]
    roots = [r for r in recs if r[2] == "map"]
    if not roots:
        return None
    mapped = sum(r[6].get("mapped", 0) for r in roots)
    pairs = sum(r[6].get("pairs", 0) for r in recs if r[2] == "map.dp")
    return 100.0 * pairs / mapped if mapped else 0.0
