#!/usr/bin/env python
"""One traced run of a benchmark cell (asmbench/run.py --trace 1), read
by the program's spans (turingassembler_tpu_torch/tracing.py):

  - the card's idle and busy ms a job by innermost program span open
    (the main thread's spans; "(outside)" where none is open);
  - whether the clocks agree: the share of the window's host-to-card
    copy time inside the program's `count.ship` and `map.ship` spans,
    and for each of the harness's `count`, `build` and `map` spans the
    share of its device-busy time inside the program's root span of the
    same name;
  - each host-to-card copy put down to the span open when the host
    issued it (the copy's runtime call, matched by its CUPTI
    correlation id), and the share of the copies issued in a ship span
    that ran inside one;
  - the jobs' walls and the result line.

Usage, from the root of a checkout, on a machine with the card:

    python3 tools/trace_spans.py --workload ecoli.level0 --seed 7 \
        --seconds 51 --out chiprun_out/trace_spans.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from asmbench import harness, trace  # noqa: E402

OUTSIDE = "(outside)"


def busy_before(busy):
    """B(t): the busy measure of the sorted disjoint union `busy` before
    t, for an array of t."""
    s = np.array([a for a, _ in busy] or [0.0])
    e = np.array([b for _, b in busy] or [0.0])
    cum = np.concatenate([[0.0], np.cumsum(e - s)])

    def at(t):
        i = np.searchsorted(s, t, side="right") - 1
        j = np.maximum(i, 0)
        part = np.clip(t - s[j], 0.0, e[j] - s[j])
        return np.where(i >= 0, cum[j] + part, 0.0)
    return at


def segments(recs, thread, w0, w1):
    """The window cut where `thread`'s innermost open span changes:
    (cuts (m + 1,) array of times, m names, OUTSIDE where none is
    open)."""
    spans = sorted(((r[4] * 1e-9, r[5] * 1e-9, r[2]) for r in recs
                    if r[3] == thread and w0 <= r[4] * 1e-9
                    and r[5] * 1e-9 <= w1), key=lambda x: (x[0], -x[1]))
    cuts, names, stack, t, i = [w0], [], [], w0, 0
    while t < w1:
        while stack and stack[-1][0] <= t:
            stack.pop()
        while i < len(spans) and spans[i][0] <= t:
            if spans[i][1] > t:
                stack.append((spans[i][1], spans[i][2]))
            i += 1
        nxt = min([w1] + ([stack[-1][0]] if stack else [])
                  + ([spans[i][0]] if i < len(spans) else []))
        names.append(stack[-1][1] if stack else OUTSIDE)
        cuts.append(nxt)
        t = nxt
    return np.array(cuts), names


def by_innermost(view, recs, thread, busy):
    """{span name: (idle s, busy s)} over the window, `busy` a sorted
    disjoint union of device intervals, each instant put down to the
    innermost of `thread`'s spans open then."""
    w0, w1 = view.window()
    cuts, names = segments(recs, thread, w0, w1)
    at = busy_before(trace.intersect(busy, [(w0, w1)]))
    busy = np.diff(at(cuts))
    idle = np.diff(cuts) - busy
    out = {}
    for n, a, b in zip(names, idle, busy):
        x = out.setdefault(n, [0.0, 0.0])
        x[0] += a
        x[1] += b
    return out


def share_inside(intervals, spans):
    """The share of the intervals' length inside the union of spans."""
    iv = trace.union(intervals)
    total = trace.measure(iv)
    if not total:
        return None
    return trace.measure(trace.intersect(iv, trace.union(spans))) / total


def issue_sites(copies, recs, thread, window):
    """{span name: device s} of the window's host-to-card copies, each
    put down to the innermost of `thread`'s spans open when its runtime
    call was made, with "ship copies": the device intervals of those
    issued in a ship span, and "unmatched" the copies with no call."""
    calls = copies.get("calls", {})
    cuts, names = segments(recs, thread, *window)
    out, ship = {"unmatched": 0.0}, []
    for s, e, corr in copies.get("h2d", []):
        if not window[0] <= s and e <= window[1]:
            continue
        t = calls.get(corr)
        if t is None:
            out["unmatched"] += e - s
            continue
        i = np.searchsorted(cuts, t, side="right") - 1
        name = names[i] if 0 <= i < len(names) else OUTSIDE
        out[name] = out.get(name, 0.0) + (e - s)
        if name in ("count.ship", "map.ship"):
            ship.append((s, e))
    if not ship and not out["unmatched"] and len(out) == 1:
        return None
    out["ship copies"] = ship
    return out


def clock_offset(copies, ships, window, least_s=1e-3):
    """Bounds on the offset of the profiler's clock from the spans'
    (time.time_ns()), in us, from the window's long host-to-card copies
    (device time over `least_s`: a record's or a batch's bases, one a
    ship span) paired in order with the ship spans: each copy's runtime
    call starts after its span opened and ends before it closed, so
    call end - span end <= offset <= call start - span start.  None
    when the copies and the spans do not pair one to one."""
    calls, ends = copies.get("calls", {}), copies.get("call_ends", {})
    big = sorted((s, e, corr) for s, e, corr in copies.get("h2d", [])
                 if window[0] <= s and e <= window[1] and e - s > least_s
                 and corr in calls)
    ships = sorted(ships)
    if not big or len(big) != len(ships):
        return {"pairs": 0, "long_copies": len(big), "ships": len(ships)}
    lo = [ends[c] - t1 for (_, _, c), (_, t1) in zip(big, ships)]
    hi = [calls[c] - t0 for (_, _, c), (t0, _) in zip(big, ships)]
    # the device's own stamps against the host's: a blocking copy starts
    # after its call and ends before its span closes
    late = np.array([e - t1 for (_, e, _), (_, t1) in zip(big, ships)])
    early = np.array([calls[c] - s for s, _, c in big])
    tenth = np.minimum((10 * (np.array([b[0] for b in big]) - window[0])
                        / (window[1] - window[0])).astype(int), 9)
    return {"pairs": len(big), "lo_us": 1e6 * max(lo), "hi_us": 1e6 * min(hi),
            "call_after_open_us_median": 1e6 * float(np.median(hi)),
            "close_after_call_us_median": -1e6 * float(np.median(lo)),
            "copy_end_after_close_us": {
                q: 1e6 * float(np.quantile(late, x)) for q, x in
                (("median", 0.5), ("p90", 0.9), ("max", 1.0))},
            "copies_ending_after_close": float(np.mean(late > 0)),
            "copy_end_after_close_us_median_by_tenth": [
                1e6 * float(np.median(late[tenth == i]))
                if np.any(tenth == i) else None for i in range(10)],
            "copy_start_before_call_us_max": 1e6 * float(early.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/trace_spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    seen = []
    real = trace.TraceView

    def keep(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    copies = {}
    real_events = trace.profiler_events

    def events(prof):
        from torch.autograd import DeviceType
        evs = prof.profiler.kineto_results.events()
        calls = [e for e in evs if e.device_type() == DeviceType.CPU
                 and "emcpy" in e.name()]
        copies["calls"] = {e.correlation_id(): e.start_ns() * 1e-9
                           for e in calls}
        copies["call_ends"] = {e.correlation_id(): e.end_ns() * 1e-9
                               for e in calls}
        copies["h2d"] = [(e.start_ns() * 1e-9, e.end_ns() * 1e-9,
                          e.correlation_id()) for e in evs
                         if e.device_type() == DeviceType.CUDA
                         and "HtoD" in e.name()]
        return real_events(prof)

    trace.TraceView, trace.profiler_events = keep, events
    res = harness.run(args.workload, args.seed, args.seconds, True)
    trace.TraceView, trace.profiler_events = real, real_events
    if not seen or "calls" not in copies:
        raise SystemExit("tools/trace_spans.py: the harness made no "
                         "TraceView or read no profiler events through "
                         "asmbench/trace.py (renamed?); nothing to read")
    view = seen[0]
    try:
        from turingassembler_tpu_torch import tracing
        recs = tracing.records()
    except ImportError:                  # a program without the tracer
        recs = []
    w0, w1 = view.window()
    inside = [r for r in recs if w0 <= r[4] * 1e-9 and r[5] * 1e-9 <= w1]
    jobs = view.jobs
    walls = sorted(s for _, n, s in view.walls.walls if n == "job")
    out = {"workload": args.workload, "seed": args.seed, "jobs": jobs,
           "job_wall_ms": {"median": 1e3 * walls[len(walls) // 2],
                           "q1": 1e3 * walls[len(walls) // 4],
                           "q3": 1e3 * walls[3 * len(walls) // 4]},
           "program_spans": len(inside), "result": res}
    if inside:
        main = threading.main_thread().ident
        table = by_innermost(view, inside, main, view.busy())
        out["ms_a_job_by_innermost_span"] = {
            n: {"idle": 1e3 * a / jobs, "busy": 1e3 * b / jobs}
            for n, (a, b) in sorted(table.items(), key=lambda kv: -kv[1][0])}
        ship = [(r[4] * 1e-9, r[5] * 1e-9) for r in inside
                if r[2] in ("count.ship", "map.ship")]
        h2d = [(s, e) for n, s, e in view.device
               if "HtoD" in n and w0 <= s and e <= w1]
        out["h2d_ms_a_job_by_innermost_span"] = {
            n: 1e3 * b / jobs for n, (_, b) in
            by_innermost(view, inside, main, trace.union(h2d)).items() if b}
        agree = {"h2d_in_ship": share_inside(h2d, ship),
                 "clock_offset": clock_offset(copies, ship, (w0, w1))}
        issued = issue_sites(copies, inside, main, (w0, w1))
        if issued:
            agree["h2d_issued_in_ship_inside_it"] = share_inside(
                issued.pop("ship copies"), ship)
            out["h2d_ms_a_job_by_issuing_span"] = {
                n: 1e3 * v / jobs for n, v in issued.items()}
        for name in trace.LAYER_SPANS:
            harness_iv = trace.union(view.spans.get(name, []))
            roots = [(r[4] * 1e-9, r[5] * 1e-9) for r in inside
                     if r[2] == name]
            agree[f"busy_in_{name}"] = share_inside(
                view.busy(harness_iv), roots) if harness_iv else None
        out["clocks_agree"] = agree
        counts = {}
        for r in inside:
            c = counts.setdefault(r[2], {"spans": 0})
            c["spans"] += 1
            for k, v in r[6].items():
                c[k] = c.get(k, 0) + v
        out["counts_a_job"] = {n: {k: v / jobs for k, v in c.items()}
                               for n, c in sorted(counts.items())}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    summary = {k: out[k] for k in ("workload", "seed", "jobs",
                                   "job_wall_ms", "program_spans")}
    summary["metrics"] = {k: v["value"] for k, v in
                          res["metrics"].items()}
    summary["correct"] = res["correct"]
    for k in ("clocks_agree", "h2d_ms_a_job_by_innermost_span",
              "h2d_ms_a_job_by_issuing_span",
              "ms_a_job_by_innermost_span"):
        if k in out:
            summary[k] = out[k]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
