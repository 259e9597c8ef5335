"""Spans the harness records around its own calls into the program, and
what the traced run reads from them and from the profiler's device
events.

Every span ends in a device sync, so its wall covers the device work it
queued.  A span keeps its host wall (perf_counter) and its start and end
on the wall clock (time_ns), the clock on which torch.profiler stamps the
card's kernels, memsets and copies, so the traced run profiles the card
alone and places its events inside the spans.  Span names: `job` (one
job, start to its last output on the host), `count`, `build` and `map`
(the calls into those layers); device time outside every job is
`between`.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

LAYER_SPANS = ("count", "build", "map")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host walls of named spans, by job, and their intervals on the wall
    clock in seconds."""

    def __init__(self, device: torch.device):
        self.device = device
        self.job = -1
        self.walls: list = []          # (job, name, seconds)
        self.clock: dict = {}          # name -> [(start, end)]

    def clear(self) -> None:
        self.walls, self.clock = [], {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0, w0 = time.perf_counter(), time.time_ns()
        yield
        sync(self.device)
        self.walls.append((self.job, name, time.perf_counter() - t0))
        self.clock.setdefault(name, []).append((w0 * 1e-9,
                                                time.time_ns() * 1e-9))

    def total(self, name: str) -> float:
        return sum(s for _, n, s in self.walls if n == name)


def union(iv):
    """Sorted disjoint union of (start, end) intervals, as a list of
    tuples."""
    a = np.asarray(list(iv), dtype=np.float64).reshape(-1, 2)
    if not len(a):
        return []
    a = a[np.argsort(a[:, 0], kind="stable")]
    reach = np.maximum.accumulate(a[:, 1])
    new = np.ones(len(a), dtype=bool)
    new[1:] = a[1:, 0] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(a) - 1)
    return list(zip(a[first, 0].tolist(), reach[last].tolist()))


def measure(iv) -> float:
    return sum(e - s for s, e in iv)


def intersect(a, b):
    """Intersection of two sorted disjoint unions."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def profiler_events(prof) -> list:
    """[(name, start, end)] of every kernel, memset and copy a finished
    torch.profiler.profile saw on the card, in seconds on the wall
    clock."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


@dataclass
class TraceView:
    """What a per-layer metric reads: the traced window's spans and its
    device events on the wall clock, the jobs' host walls (Spans) and
    each job's least time by layer (seconds, from roofline/)."""
    spans: dict                      # name -> [(start, end)]
    device: list                     # [(name, start, end)]
    walls: Spans
    least: list = field(default_factory=list)   # per job {layer: s}
    _busy: list | None = field(default=None, repr=False)

    @property
    def jobs(self) -> int:
        return len(self.spans.get("job", []))

    def window(self):
        jobs = self.spans.get("job", [])
        if not jobs:
            return None
        return min(s for s, _ in jobs), max(e for _, e in jobs)

    def busy(self, within=None):
        """Union of the device intervals, clipped to `within` (a union)."""
        if self._busy is None:
            self._busy = union((s, e) for _, s, e in self.device)
        return intersect(self._busy, within) if within is not None \
            else self._busy

    def span_mean_ms(self, name: str):
        """Mean host wall of a job's `name` spans, in ms; None when no
        job had one."""
        jobs = {j for j, n, _ in self.walls.walls if n == name}
        if not jobs:
            return None
        return 1e3 * self.walls.total(name) / len(jobs)

    def roofline_pct(self, layer: str):
        """The layer's least time over its device-busy time inside its
        spans, summed over the window's jobs, in percent; None when the
        layer ran no device work or has no least time."""
        iv = self.spans.get(layer)
        least = sum(j.get(layer, 0.0) for j in self.least)
        if not iv or not least:
            return None
        busy = measure(self.busy(union(iv)))
        return 100.0 * least / busy if busy > 0 else None

    def copy_ms(self, direction: str = "HtoD"):
        """Device time of the window's `direction` copies a job, ms."""
        w = self.window()
        seen = [e - s for n, s, e in self.device
                if direction in n and s >= w[0] and e <= w[1]] if w else []
        return 1e3 * sum(seen) / self.jobs if seen else None

    def idle_pct(self):
        w = self.window()
        if w is None or not self.device:
            return None
        busy = measure(self.busy([w]))
        return 100.0 * (1.0 - busy / (w[1] - w[0]))

    def busy_s(self) -> float:
        w = self.window()
        return measure(self.busy([w])) if w else 0.0

    def window_s(self) -> float:
        w = self.window()
        return w[1] - w[0] if w else 0.0

    def where(self, t: float) -> str:
        """The innermost harness span open at time t."""
        for name in LAYER_SPANS + ("job",):
            if any(s <= t < e for s, e in self.spans.get(name, ())):
                return name
        return "between"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps of the window, each gap named by the span open in it."""
        by_op = {}
        for n, s, e in self.device:
            by_op[n] = by_op.get(n, 0.0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        w = self.window()
        if w is not None:
            prev = w[0]
            for s, e in self.busy([w]) + [(w[1], w[1])]:
                if s > prev:
                    gaps.append((s - prev, (prev + s) / 2))
                prev = max(prev, e)
        gaps.sort(reverse=True)
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[self.where(mid), t]
                              for t, mid in gaps[:top]]}
