"""One run of one cell: make the libraries, set up and warm up, run jobs
back to back for the window, then judge a sample of the outputs against
the reference and print the result line.

The loop is closed with one client: the next job starts when the last
one has returned its output to the host.  Libraries alternate, so no job
sees the data of the job before it.  End-to-end metrics (tracing off):

  reads_per_s   every read of every job over all the window's time
  job_p95_ms    95th percentile (nearest rank) of all the jobs' walls
  setup_s       process start to the first timed job

With tracing on, the same loop runs under torch.profiler (the card's
activity alone) and the line carries the per-layer metrics instead
(metrics/<name>.py read them).
"""

from __future__ import annotations

import gc
import math
import random
import subprocess
import sys
import time

import torch

from asmbench import library, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "turingassembler_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def power_label(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, for the log."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unreadable"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, names compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def drift(starts, walls, parts: int = 10) -> str:
    """Median job wall in each tenth of the window (by the job's start),
    in ms, and the quartiles' spread of all the window's walls as a
    share of their median: the spread inside one run."""
    if not walls:
        return "no jobs"
    s0, s1 = starts[0], starts[-1] + walls[-1]
    bins = [[] for _ in range(parts)]
    for t, w in zip(starts, walls):
        bins[min(int(parts * (t - s0) / (s1 - s0)), parts - 1)].append(w)
    med = ["%.1f" % (1e3 * sorted(b)[len(b) // 2]) if b else "-"
           for b in bins]
    w = sorted(walls)
    q1, q2, q3 = (w[len(w) // 4], w[len(w) // 2], w[3 * len(w) // 4])
    return (f"job wall median by tenth of the window (ms): {' '.join(med)}; "
            f"quartile spread {100 * (q3 - q1) / q2:.2f}% of the median")


def p95(values) -> float:
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


class Reservoir:
    """A uniform sample of up to `size` jobs a library, drawn from the
    seed as the jobs come."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.seen: dict = {}
        self.kept: dict = {}

    def offer(self, lib: int, job: int, out) -> None:
        n = self.seen.get(lib, 0)
        self.seen[lib] = n + 1
        slot = self.kept.setdefault(lib, [])
        if n < self.size:
            slot.append((job, out))
        else:
            i = self.rng.randrange(n + 1)
            if i < self.size:
                slot[i] = (job, out)


def run(cell_name: str, seed: int, seconds: float, traced: bool, *,
        device: str = "cuda", bench: dict | None = None, roots=None,
        t_start: float | None = None) -> dict:
    """One run; returns the result line's object (its `checks` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    roots = roots or (spec.HERE,)
    bench = bench or spec.benchmark()
    cell, config, mix, entry = spec.load_cell(cell_name, bench, roots)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    log(f"cell {cell_name}: config {cell['config']}, traffic "
        f"{cell['traffic']} (entry {mix['entry']}), seed {seed}, "
        f"{seconds} s, trace {int(traced)}")

    t0 = time.perf_counter()
    if on_card:
        torch.zeros(1, device=dev)
    log(f"process start to the card ready: {t0 - t_start:.3f} s to here, "
        f"{time.perf_counter() - t0:.3f} s to start CUDA")
    t0 = time.perf_counter()
    libs = library.make_libraries(config, seed, mix["libraries"], dev)
    log(f"libraries: {[lib.reads for lib in libs]} reads, seeds "
        f"{[lib.seed for lib in libs]}, made in "
        f"{time.perf_counter() - t0:.3f} s")
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    spans = trace.Spans(dev)
    t0 = time.perf_counter()
    state = entry.setup(config, mix, libs, dev, spans)
    log(f"set-up and warm-up: {time.perf_counter() - t0:.3f} s")
    spans.clear()
    keep = Reservoir(mix["checked_jobs_per_library"], seed)
    # what exists now (imports, libraries, set-up) lives to the end:
    # the collector need not walk it again in the window
    gc.collect()
    gc.freeze()

    prof = None
    if traced and on_card:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    walls, starts, least, n_reads, i = [], [], [], 0, 0
    start = time.perf_counter()
    while True:
        lib = i % len(libs)
        spans.job = i
        t = time.perf_counter()
        starts.append(t - start)
        with spans.span("job"):
            out, job_least = entry.job(state, lib, spans)
        walls.append(time.perf_counter() - t)
        least.append(job_least)
        n_reads += entry.reads(state, lib)
        keep.offer(lib, i, out)
        del out
        i += 1
        if time.perf_counter() - start >= seconds:
            break
    window = time.perf_counter() - start
    if prof is not None:
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        log(f"profiler stopped in {time.perf_counter() - t:.3f} s")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"card: {power_label(dev)}")
    log(f"window: {len(walls)} jobs, {n_reads} reads in {window:.6f} s; "
        f"job walls {min(walls):.6f}-{max(walls):.6f} s, median "
        f"{sorted(walls)[len(walls) // 2]:.6f} s")
    log(drift(starts, walls))

    for name in sorted({n for _, n, _ in spans.walls}):
        w = sorted(s for _, n, s in spans.walls if n == name)
        log(f"span {name}: {len(w)}, median {w[len(w) // 2]:.6f} s, "
            f"quartiles {w[len(w) // 4]:.6f}-{w[3 * len(w) // 4]:.6f} s")
    metrics = {}
    result = {"correct": False, "attempted": len(walls), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(dev)
                         if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if traced:
        t = time.perf_counter()
        dev_events = trace.profiler_events(prof) if prof is not None else []
        view = trace.TraceView(spans.clock, dev_events, spans, least)
        del prof
        for m in spec.per_layer_metrics(bench, cell_name):
            v = spec.load_module("metrics", m["name"], roots).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"].update(busy_s=view.busy_s(),
                                window_s=view.window_s())
        result["breakdown"] = view.breakdown()
        log(f"trace: {len(dev_events)} device events, "
            f"{sum(len(v) for v in spans.clock.values())} spans, read in "
            f"{time.perf_counter() - t:.3f} s")
        log("breakdown: " + repr(result["breakdown"]))
    else:
        e2e = {"reads_per_s": n_reads / window,
               "job_p95_ms": 1e3 * p95(walls), "setup_s": setup_s}
        for m in spec.end_to_end_metrics(bench):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the program's state goes before the reference runs
    judged = entry.release(state, keep.kept)
    del state, keep
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    worst, failed = entry.check(config, mix, libs, judged, dev)
    log(f"reference and comparison: {time.perf_counter() - t:.3f} s")
    limits = entry.LIMITS
    result["failed"] = failed
    result["correct"] = all(worst[n] <= limits[n] for n in limits)
    result["checks"] = {n: {"value": worst[n], "limit": limits[n]}
                        for n in limits}
    return result
