"""The benchmark's readers of the program's spans (asmbench/metrics/*.py
over turingassembler_tpu_torch/tracing.py's records), each on a
hand-built TraceView with hand-made records, the values worked by hand:
records outside the traced window left out, a layer whose measured part
never ran reading 0, a layer whose root never ran reading None."""

import sys

import pytest
import torch

import turingassembler_tpu_torch
from asmbench import spec, trace
from turingassembler_tpu_torch import tracing

NAMES = ("count_idle_ms", "count_coalesce_ms", "count_lsd_ms", "count_syncs",
         "build_idle_ms", "map_idle_ms", "map_dp_pct", "map_syncs",
         "h2d_pageable_mb")


def ns(s):
    return int(round(s * 1e9))


class Records:
    """Hand-made records, (id, parent, name, thread, t0, t1, counts),
    times given in seconds."""

    def __init__(self):
        self.recs = []

    def span(self, name, t0, t1, parent=None, **counts):
        rid = len(self.recs) + 1
        self.recs.append((rid, parent, name, 1, ns(t0), ns(t1), counts))
        return rid


def view(jobs, device):
    """A TraceView of the jobs' spans (seconds) and device intervals."""
    return trace.TraceView({"job": jobs},
                           [("kernel", s, e) for s, e in device],
                           trace.Spans(torch.device("cpu")))


def read(name, v, recs, monkeypatch):
    monkeypatch.setattr(tracing, "records", lambda: list(recs.recs))
    return spec.load_module("metrics", name).read(v)


@pytest.fixture
def level0():
    """Two jobs, 10-11 s and 11-12 s: a count and a build each; a count
    at 9 s, before the window, that every reader leaves out."""
    r = Records()
    a = r.span("count", 10.1, 10.5, records=2, rows=100, syncs=1)
    r.span("count.coalesce", 10.10, 10.15, a, source_ns=ns(0.02))
    r.span("count.ship", 10.15, 10.20, a, bytes=1_000_000, pageable=1)
    r.span("count.ship", 10.20, 10.22, a, bytes=500_000, pageable=0)
    r.span("count.extract", 10.22, 10.25, a, rows=100, syncs=1)
    s = r.span("count.sort", 10.25, 10.45, a, syncs=2, over_capacity=3)
    r.span("count.sort.lsd", 10.30, 10.34, s, buckets=3, rows=50, syncs=4)
    r.span("build", 10.5, 10.6, unitigs=4, syncs=3)
    b = r.span("count", 11.1, 11.3, records=1, rows=40)
    r.span("count.coalesce", 11.10, 11.12, b)
    r.span("count.filter", 11.25, 11.3, b, syncs=1)
    r.span("build", 11.3, 11.5, unitigs=4, syncs=3)
    # before the window
    z = r.span("count", 9.0, 9.5, syncs=100)
    r.span("count.ship", 9.0, 9.1, z, bytes=9_000_000, pageable=1)
    r.span("count.coalesce", 9.1, 9.2, z, source_ns=ns(0.05))
    r.span("count.sort.lsd", 9.2, 9.3, z)
    r.span("build", 9.5, 9.6)
    v = view([(10.0, 11.0), (11.0, 12.0)],
             [(9.0, 9.6), (10.2, 10.3), (10.45, 10.6), (11.15, 11.2)])
    return v, r


@pytest.fixture
def aux_map():
    """Two jobs, 20-21 s and 21-22 s, one map each; a map at 23 s, after
    the window."""
    r = Records()
    a = r.span("map", 20.1, 20.4, reads=100, mapped=80)
    r.span("map.ship", 20.10, 20.15, a, bytes=2_000_000, pageable=1)
    r.span("map.vote", 20.15, 20.20, a, pool_builds=1)
    r.span("map.dp", 20.20, 20.30, a, pairs=4, syncs=2)
    r.span("map.pull", 20.30, 20.40, a, syncs=2)
    b = r.span("map", 21.1, 21.2, reads=100, mapped=20)
    r.span("map.ship", 21.10, 21.12, b, bytes=500_000, pageable=0)
    r.span("map.dp", 21.12, 21.15, b, pairs=1, syncs=1)
    z = r.span("map", 23.0, 23.5, reads=100, mapped=1)
    r.span("map.dp", 23.0, 23.1, z, pairs=50, syncs=9)
    r.span("map.ship", 23.1, 23.2, z, bytes=7_000_000, pageable=1)
    v = view([(20.0, 21.0), (21.0, 22.0)], [(20.2, 20.25), (23.0, 23.5)])
    return v, r


@pytest.mark.parametrize("name,want", [
    # count roots 10.1-10.5 and 11.1-11.3 (0.6 s), busy in them 0.1 +
    # 0.05 + 0.05 s: 0.4 s idle over 2 jobs
    ("count_idle_ms", 200.0),
    # coalesce 50 + 20 ms less its source wait 20 ms, over 2 jobs
    ("count_coalesce_ms", 25.0),
    ("count_lsd_ms", 20.0),
    # 1 (root) + 1 (extract) + 2 (sort) + 4 (lsd) + 1 (filter)
    ("count_syncs", 4.5),
    # builds 10.5-10.6 (busy throughout) and 11.3-11.5 (idle)
    ("build_idle_ms", 100.0),
    # one pageable MB in the window
    ("h2d_pageable_mb", 0.5),
])
def test_level0_readers(level0, monkeypatch, name, want):
    v, r = level0
    assert read(name, v, r, monkeypatch) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name,want", [
    # maps 20.1-20.4 and 21.1-21.2 (0.4 s), busy in them 0.05 s
    ("map_idle_ms", 175.0),
    # 4 + 1 pairs to the DP over 80 + 20 reads mapped
    ("map_dp_pct", 5.0),
    ("map_syncs", 2.5),
    ("h2d_pageable_mb", 1.0),
])
def test_map_readers(aux_map, monkeypatch, name, want):
    v, r = aux_map
    assert read(name, v, r, monkeypatch) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", ["count_lsd_ms", "count_coalesce_ms",
                                  "h2d_pageable_mb"])
def test_a_part_that_never_ran_reads_0(name, monkeypatch):
    """A count with no bucket over capacity, no record and nothing copied
    from pageable memory."""
    r = Records()
    r.span("count", 10.1, 10.2, records=0, rows=0)
    v = view([(10.0, 11.0)], [])
    assert read(name, v, r, monkeypatch) == 0


def test_a_map_that_mapped_nothing_reads_0(monkeypatch):
    r = Records()
    a = r.span("map", 10.1, 10.2, reads=5, mapped=0)
    r.span("map.dp", 10.1, 10.2, a, pairs=0, syncs=1)
    v = view([(10.0, 11.0)], [])
    assert read("map_dp_pct", v, r, monkeypatch) == 0
    assert read("map_syncs", v, r, monkeypatch) == 1
    assert read("map_idle_ms", v, r, monkeypatch) == pytest.approx(100.0)


@pytest.mark.parametrize("name", NAMES)
def test_no_root_span_reads_none(name, level0, aux_map, monkeypatch):
    """The level-0 records hold no map, the map's no count or build, and
    a window with no job holds nothing."""
    cell = aux_map if name.startswith(("count", "build")) else level0
    if name == "h2d_pageable_mb":
        r = Records()
        r.span("build", 10.1, 10.2)
        cell = (view([(10.0, 11.0)], []), r)
    assert read(name, *cell, monkeypatch) is None
    assert read(name, view([], []), level0[1], monkeypatch) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_the_tracer_reads_none(name, level0, aux_map,
                                                monkeypatch):
    """As the parent commit's program reads: no tracing module."""
    cell = aux_map if name.startswith("map") else level0
    assert read(name, *cell, monkeypatch) is not None
    monkeypatch.delattr(turingassembler_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "turingassembler_tpu_torch.tracing",
                        None)
    assert spec.load_module("metrics", name).read(cell[0]) is None


def test_the_readers_are_in_the_benchmark():
    bench = spec.benchmark()
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in NAMES:
        m = listed[name]
        assert m["moves"] == "reads_per_s" and m["better"] == "lower"
        assert (spec.HERE / "metrics" / f"{name}.py").is_file()
        want = ("device_trace" if name.endswith("idle_ms")
                else "host_clock")
        assert m["source"] == want
    assert listed["map_dp_pct"]["workloads"] == ["ecoli.aux_map",
                                                 "scerevisiae.aux_map"]
    assert len(listed["h2d_pageable_mb"]["workloads"]) == 4
