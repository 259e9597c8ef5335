"""The human chr14 cell's pieces on the CPU: the configuration's genome at
its full length, the reference in blocks (asmbench/reference/
kmers_blocked.py) against the plain one, the level0_large entry through
the harness at a scaled-down genome, the count's and the build's new
counters (turingassembler_tpu_torch/tracing.py) and the four readers that
read them (asmbench/metrics/{merge_ms,merge_roofline,rank_ms,
build_host_ms}.py) on hand-made records."""

import copy
import json
import math
import sys

import numpy as np
import pytest
import torch

import turingassembler_tpu_torch
from asmbench import harness, library, spec, trace
from asmbench.reference import compare, kmers, unitigs
from asmbench.reference import kmers_blocked as kb
from asmbench.reference import level0 as ref0
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch import tracing
from turingassembler_tpu_torch.graph import device_build as tdb
from turingassembler_tpu_torch.kmer import megasort as tms

CHR14 = spec.load_json("configs", "human-chr14-k63")
# chr14's families scaled down to a 60 kbp genome: 20 Alu-like copies of
# 300 bp at 96%, 4 L1-like copies of 1,500 bp at 98.5%, each 1,400 bp
# past an Alu-like one
SMALL_REPEATS = [
    {"copies": 20, "length": 300, "identity": 0.96, "layout": "spread",
     "first": 1000, "last_from_end": 1000},
    {"copies": 4, "length": 1500, "identity": 0.985, "layout": "spread",
     "first": 1000, "last_from_end": 4053, "offset": 1400}]
SEED = 2 ** 31 + 77


def small_config(length=60_000, name="chr14-small"):
    return dict(copy.deepcopy(CHR14), name=name, genome_length=length,
                repeats=copy.deepcopy(SMALL_REPEATS))


@pytest.fixture(scope="module")
def small_lib():
    cfg = small_config()
    return library.make_library(library.make_genome(cfg, "cpu"),
                                cfg["reads"], 5)


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_the_configuration_is_gages_chr14_whole():
    assert CHR14["genome_length"] == 88_289_540
    assert (CHR14["k0"], CHR14["min_kmer_count"]) == (63, 2)
    assert CHR14["reduced"] == []
    yeast = spec.load_json("configs", "scerevisiae-s288c-k63")
    assert CHR14["reads"] == yeast["reads"]
    assert CHR14["guarantees"] == yeast["guarantees"]
    assert library.n_pairs(CHR14["genome_length"], CHR14["reads"]) \
        == 14_714_924
    listed = {c["name"]: c for c in spec.benchmark()["configs"]}
    assert listed["human-chr14-k63"]["source"] == CHR14["source"]
    assert listed["human-chr14-k63"]["reduced"] == CHR14["reduced"]


def test_the_genome_at_full_length_holds_each_family_at_its_identity():
    """make_genome at 88,289,540 bp: no copy overlaps another, and each
    family's copies match their consensus (the base most copies hold at
    each position) at the file's identity: the family's mean within
    0.003, every copy within six standard deviations."""
    g = library.make_genome(CHR14, "cpu")
    assert g.shape == (CHR14["genome_length"],)
    spans = sorted((s, s + r["length"]) for r in CHR14["repeats"]
                   for s in library.repeat_starts(r, len(g)))
    assert spans[0][0] >= 0 and spans[-1][1] <= len(g)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    for r in CHR14["repeats"]:
        starts = torch.tensor(library.repeat_starts(r, len(g)))
        copies = g[starts[:, None] + torch.arange(r["length"])[None, :]]
        consensus = torch.mode(copies, 0).values
        ident = (copies == consensus).double().mean(1)
        sd = math.sqrt(r["identity"] * (1 - r["identity"]) / r["length"])
        assert len(ident) == r["copies"]
        assert abs(float(ident.mean()) - r["identity"]) < 0.003
        assert float((ident - r["identity"]).abs().max()) < 6 * sd


# ---------------------------------------------------------------------------
# the reference in blocks against the plain one
# ---------------------------------------------------------------------------

def test_partition_bounds_cut_the_first_limb_in_order():
    b = kb.partition_bounds(16, 64)
    assert b[0] == 0 and b[-1] == 1 << 62 and len(b) == 17
    assert all(x < y for x, y in zip(b, b[1:]))
    # the smaller of two uniform values: the first cut near 1/32 of the
    # range, the middle one at 1 - sqrt(1/2)
    assert b[1] == pytest.approx((1 - math.sqrt(15 / 16)) * 2 ** 62)
    assert b[8] == pytest.approx((1 - math.sqrt(0.5)) * 2 ** 62)


@pytest.mark.parametrize("parts,group_rows,empty", [
    (1, 1 << 24, False),
    (7, 5_000, False),
    (16, 100_000, False),
    (5, 20_000, True),        # one partition's range is empty
])
def test_blocked_count_is_the_plain_count(small_lib, parts, group_rows,
                                          empty, monkeypatch):
    monkeypatch.setattr(kb, "PARTS", parts)
    monkeypatch.setattr(kb, "GROUP_ROWS", group_rows)
    if empty:
        real = kb.partition_bounds

        def with_an_empty_range(p, k1):
            b = real(p - 1, k1)
            return b[:2] + b[1:]
        monkeypatch.setattr(kb, "partition_bounds", with_an_empty_range)
    k1 = CHR14["k0"] + 1
    rows, counts = kmers.count(ref0.reads(small_lib), k1, 2, "cpu")
    got_r, got_c = kb.count(ref0.reads(small_lib), k1, 2, "cpu")
    assert len(rows) > 50_000
    assert torch.equal(got_r, rows) and torch.equal(got_c, counts)


def test_blocked_fingerprinted_count_in_one_partition_is_the_plain_one(
        small_lib, monkeypatch):
    monkeypatch.setattr(kb, "PARTS", 1)
    k1 = CHR14["k0"] + 1
    want = kmers.count(ref0.reads(small_lib), k1, 2, "cpu",
                       fingerprinted=True)
    got = kb.count(ref0.reads(small_lib), k1, 2, "cpu", fingerprinted=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


BUILD_CASES = tt.unitig_build_cases()


@pytest.mark.parametrize("name", [n for n, (u, _, _) in BUILD_CASES.items()
                                  if len(u)])
def test_blocked_build_is_the_plain_build(name, monkeypatch):
    """Every edge case of the level-0 build (circular unitigs, palindromes,
    every limb count) in blocks of 64 k-edges: unitigs.build's graph,
    array for array."""
    monkeypatch.setattr(kb, "ROW_BLOCK", 64)
    u, c, k = BUILD_CASES[name]
    rows, counts = compare.program_table(u, c, k + 1, "cpu")
    want = unitigs.build(rows, counts, k)
    got = kb.build(rows, counts, k)
    for f in ("pool", "off", "count", "start", "end", "circular"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.k == want.k


def test_blocked_build_of_a_library_is_the_plain_build(small_lib,
                                                       monkeypatch):
    monkeypatch.setattr(kb, "ROW_BLOCK", 5_000)
    k = CHR14["k0"]
    rows, counts = kmers.count(ref0.reads(small_lib), k + 1, 2, "cpu")
    want = unitigs.build(rows, counts, k)
    got = kb.build(rows, counts, k)
    assert want.n > 100
    for f in ("pool", "off", "count", "start", "end", "circular"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_blocked_program_table_is_the_plain_one(monkeypatch):
    monkeypatch.setattr(kb, "ROW_BLOCK", 37)
    u, c, k = max(BUILD_CASES.values(), key=lambda v: len(v[0]))
    want = compare.program_table(u, c, k + 1, "cpu")
    got = kb.program_table(np.asarray(u), np.asarray(c), k + 1, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the entry through the harness, on the CPU
# ---------------------------------------------------------------------------

def small_bench(tmp_path, cfg):
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / f"{cfg['name']}.json").write_text(
        json.dumps(cfg))
    b = copy.deepcopy(spec.benchmark())
    b["workloads"].append({"name": "small.level0-large",
                           "config": cfg["name"],
                           "traffic": "level0-large", "chips": 1,
                           "why": "test"})
    return b, (tmp_path, spec.HERE)


@pytest.mark.parametrize("max_lanes", [None, 400_000])
def test_level0_large_is_correct_on_a_scaled_down_genome(
        tmp_path, monkeypatch, max_lanes):
    """chr14's families at 60 kbp through level0_large's job (level0's,
    the count and the build) against the reference in blocks: 0 wrong in
    all three numbers; at max_lanes 400,000 (about 1.7 M rows a library)
    the count flushes 5 times and merges 4 times a job."""
    if max_lanes:
        real = tms.count_kedges_megasort_device

        def small_windows(*a, **kw):
            return real(*a, max_lanes=max_lanes, **kw)
        monkeypatch.setattr(tms, "count_kedges_megasort_device",
                            small_windows)
    bench, roots = small_bench(tmp_path, small_config())
    tracing.clear()
    tracing.start()
    try:
        r = harness.run("small.level0-large", SEED, 0.5, False,
                        device="cpu", bench=bench, roots=roots)
    finally:
        tracing.stop()
    recs = tracing.records()
    tracing.clear()
    assert r["correct"] is True and r["failed"] == 0
    assert {n: c["value"] for n, c in r["checks"].items()} == {
        "kmers_wrong": 0, "unitigs_wrong": 0, "links_wrong": 0}
    roots_ = [x for x in recs if x[2] == "count"]
    merges = [x for x in recs if x[2] == "count.merge"]
    assert roots_ and all(x[6]["k1"] == 64 for x in roots_)
    if max_lanes:
        assert all(x[6]["flushes"] == 5 for x in roots_)
        assert len(merges) == 4 * len(roots_)
    else:
        assert all(x[6]["flushes"] == 1 for x in roots_) and not merges


def test_level0_large_control_reads_over_the_limits(monkeypatch):
    """The control (rows told apart by fingerprint within a partition),
    its fingerprints cut to 12 bits so that a 60 kbp library's rows
    collide as a chromosome's 32-bit ones do (about 2.2e7 colliding pairs
    in 4.4e8 rows): the check reads over its limits."""
    real = kmers.fingerprint32
    monkeypatch.setattr(kmers, "fingerprint32",
                        lambda rows: real(rows) & 0xFFF)
    cfg = small_config()
    mix = spec.load_json("traffic", "level0-large")
    entry = spec.load_module("entries", mix["entry"])
    libs = library.make_libraries(cfg, SEED, 1, "cpu")
    worst, failed = entry.check(cfg, mix, libs,
                                entry.control(cfg, mix, libs, "cpu"), "cpu")
    assert failed == 1
    assert worst["kmers_wrong"] > 0 and worst["unitigs_wrong"] > 0


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------

K = 31


@pytest.fixture(scope="module")
def world():
    g = tt.random_genome(6_000, seed=41)
    reads, lens = tt.sim_reads(g, coverage=12, read_len=100, seed=42,
                               error_rate=0.003)
    return [(reads[i:i + 128], lens[i:i + 128])
            for i in range(0, len(reads), 128)]


def traced_count(world, **kw):
    tracing.clear()
    tracing.start()
    try:
        out = tms.count_kedges_megasort_device(iter(world), K, min_count=2,
                                               device="cpu", **kw)
    finally:
        tracing.stop()
    recs = tracing.records()
    tracing.clear()
    return out, recs


def test_count_counts_its_flushes_table_and_merged_rows(world):
    """max_lanes 20,000 over about 50,000 rows: a flush every window, a
    merge every flush after the first; each merge's rows_in is the table
    and the window's unique rows, its rows_out the merged table's, and
    table_rows the largest table, with no sync added (one a flush's sort
    and the cutoff's on the CPU)."""
    (_, _, n), recs = traced_count(world, max_lanes=20_000)
    (root,) = [r for r in recs if r[2] == "count"]
    sorts = [r for r in recs if r[2] == "count.sort"]
    merges = [r for r in recs if r[2] == "count.merge"]
    c = root[6]
    assert c["k1"] == K + 1
    assert c["flushes"] == len(sorts) == -(-c["rows"] // 20_000) >= 3
    assert len(merges) == c["flushes"] - 1
    table = sorts[0][6]["unique"]
    for s, m in zip(sorts[1:], merges):
        assert m[6]["rows_in"] == table + s[6]["unique"]
        assert table <= m[6]["rows_out"] <= m[6]["rows_in"]
        table = m[6]["rows_out"]
    assert c["table_rows"] == table >= n
    assert sum(r[6].get("syncs", 0) for r in recs) == c["flushes"] + 1


def test_count_of_one_flush_counts_one_and_no_merge(world):
    (_, _, n), recs = traced_count(world)
    (root,) = [r for r in recs if r[2] == "count"]
    assert root[6]["flushes"] == 1
    assert root[6]["table_rows"] == [r for r in recs
                                     if r[2] == "count.sort"][0][6]["unique"]
    assert not [r for r in recs if r[2] == "count.merge"]


def test_counters_leave_the_count_as_it_was(world):
    on, _ = traced_count(world, max_lanes=20_000)
    off = tms.count_kedges_megasort_device(iter(world), K, min_count=2,
                                           device="cpu", max_lanes=20_000)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])


def walk_bits(D: int) -> int:
    """csrc/unitig_build.cu:walk_bits at rank_layout's n_r: the offset
    bits that leave the ruler ids room for D heads, at most 10."""
    n_r = -(-D // 16)
    for ob in range(10, 0, -1):
        if n_r + (D >> ob) + 1 + D <= 1 << (31 - ob):
            return ob
    return 0


@pytest.mark.parametrize("D,ob", [(3_999_906, 8), ((1 << 25) - 1, 5),
                                  (186_000_000, 3), (2, 10)])
def test_walk_bits_formula_at_the_documented_lanes(D, ob):
    """PERF.md's ob: 8 at the kernel bench's 3,999,906 lanes, 5 at
    2^25 - 1, 3 at the chromosome's about 1.86e8."""
    assert walk_bits(D) == ob


def test_build_rank_counts_its_lanes_on_the_cpu(world):
    (uniq, counts, n), _ = traced_count(world)
    tracing.clear()
    tracing.start()
    try:
        tdb.build_graph_on_device(uniq, counts, n, K, device="cpu")
    finally:
        tracing.stop()
    recs = tracing.records()
    tracing.clear()
    (rank,) = [r for r in recs if r[2] == "build.rank"]
    # the plain ranking makes no walks: the kernel's figures are the card's
    assert rank[6] == {"lanes": 2 * n, "syncs": 1}


@pytest.mark.card
def test_build_rank_counts_the_kernels_walks_on_the_card(world):
    """On the card build.rank carries rank_chains' walk_bits, equal to
    csrc's formula for the lanes, and the rulers promoted, still in one
    sync; the graph is the one built untraced."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the walks are the rank "
                    "kernel's")
    dev = torch.device("cuda")
    g = tt.random_genome(200_000, seed=7)
    reads, lens = tt.sim_reads(g, coverage=10, read_len=150, seed=8)
    uniq, counts, n = tms.count_kedges_megasort_device(
        iter([(reads, lens)]), K, min_count=1, device=dev)
    off = tdb.build_graph_on_device(uniq, counts, n, K, device=dev)
    tracing.clear()
    tracing.start()
    try:
        on = tdb.build_graph_on_device(uniq, counts, n, K, device=dev)
    finally:
        tracing.stop()
    recs = tracing.records()
    tracing.clear()
    (rank,) = [r for r in recs if r[2] == "build.rank"]
    assert rank[6]["lanes"] == 2 * n
    assert rank[6]["walk_bits"] == walk_bits(2 * n)
    assert rank[6]["promoted"] >= 0 and rank[6]["syncs"] == 1
    np.testing.assert_array_equal(on.seq_data, off.seq_data)
    np.testing.assert_array_equal(on.edge_source, off.edge_source)


# ---------------------------------------------------------------------------
# the readers, on hand-made records
# ---------------------------------------------------------------------------

NAMES = ("merge_ms", "merge_roofline", "rank_ms", "build_host_ms")


def ns(s):
    return int(round(s * 1e9))


class Records:
    """(id, parent, name, thread, t0, t1, counts), times in seconds."""

    def __init__(self):
        self.recs = []

    def span(self, name, t0, t1, parent=None, **counts):
        rid = len(self.recs) + 1
        self.recs.append((rid, parent, name, 1, ns(t0), ns(t1), counts))
        return rid


def merge_kernel(write, s, e):
    return (f"void (anonymous namespace)::merge_kernel<4, {str(write).lower()}>"
            f"((anonymous namespace)::Pair, long long, long long const*, "
            f"long long*, unsigned long long*, long long*, int*)", s, e)


def split_kernel(s, e):
    return ("void (anonymous namespace)::merge_split_kernel<4>"
            "((anonymous namespace)::Pair, long long, long long*)", s, e)


@pytest.fixture
def chr14():
    """Two jobs, 10-12 s and 12-14 s, k1 64: the first merges twice, the
    second once; a merge at 9 s, before the window, left out."""
    r = Records()
    a = r.span("count", 10.0, 11.0, k1=64, flushes=3)
    r.span("count.merge", 10.20, 10.25, a, rows_in=1_000_000_000,
           rows_out=500_000_000, syncs=1, merge_path=1)
    r.span("count.merge", 10.50, 10.52, a, rows_in=300_000_000,
           rows_out=200_000_000, syncs=1, merge_path=1)
    bld = r.span("build", 11.0, 11.9)
    r.span("build.rank", 11.3, 11.4, bld, lanes=186_000_000, walk_bits=3,
           promoted=1000, syncs=1)
    r.span("build.host", 11.5, 11.8, bld)
    b = r.span("count", 12.0, 13.0, k1=64, flushes=2)
    r.span("count.merge", 12.30, 12.33, b, rows_in=500_000_000,
           rows_out=300_000_000, syncs=1, merge_path=1)
    bld = r.span("build", 13.0, 13.8)
    r.span("build.rank", 13.3, 13.5, bld, lanes=186_000_000, syncs=1)
    r.span("build.host", 13.5, 13.6, bld)
    z = r.span("count", 9.0, 9.5, k1=64)
    r.span("count.merge", 9.1, 9.2, z, rows_in=10 ** 10, rows_out=10 ** 10)
    device = [split_kernel(10.24, 10.25), merge_kernel(False, 10.25, 10.27),
              merge_kernel(True, 10.28, 10.31),
              ("void (anonymous namespace)::run_counts_kernel(...)",
               10.31, 10.32),
              merge_kernel(False, 10.51, 10.52),
              merge_kernel(True, 10.52, 10.53),
              merge_kernel(True, 12.32, 12.36),
              ("void (anonymous namespace)::bucket_kernel<4>(...)",
               12.0, 12.3),
              merge_kernel(True, 9.1, 9.3)]
    v = trace.TraceView({"job": [(10.0, 12.0), (12.0, 14.0)]},
                        [(n, s, e) for n, s, e in device],
                        trace.Spans(torch.device("cpu")))
    return v, r


def read(name, v, recs, monkeypatch):
    monkeypatch.setattr(tracing, "records", lambda: list(recs.recs))
    return spec.load_module("metrics", name).read(v)


@pytest.mark.parametrize("name,want", [
    # merges 50 + 20 + 30 ms over 2 jobs
    ("merge_ms", 50.0),
    # (1.5e9 + 0.5e9 + 0.8e9 rows) x 20 bytes at 3.35e12 B/s, over the
    # merge kernels' busy 0.01 + 0.02 + 0.03 + 0.01 + 0.01 + 0.04 s
    ("merge_roofline", 100.0 * 2.8e9 * 20 / 3.35e12 / 0.12),
    # ranks 100 + 200 ms, host graphs 300 + 100 ms, over 2 jobs
    ("rank_ms", 150.0),
    ("build_host_ms", 200.0),
])
def test_chr14_readers(chr14, monkeypatch, name, want):
    v, r = chr14
    assert read(name, v, r, monkeypatch) == pytest.approx(want, rel=1e-9)


def test_merge_readers_of_a_count_that_never_merged(monkeypatch):
    """One flush a job: merge_ms reads 0, merge_roofline nothing."""
    r = Records()
    r.span("count", 10.1, 10.2, k1=46, flushes=1)
    v = trace.TraceView({"job": [(10.0, 11.0)]}, [],
                        trace.Spans(torch.device("cpu")))
    assert read("merge_ms", v, r, monkeypatch) == 0
    assert read("merge_roofline", v, r, monkeypatch) is None


def test_merge_roofline_of_a_program_without_the_counts(chr14, monkeypatch):
    """The parent commit's merges carry no rows: nothing to read, no
    raise."""
    v, r = chr14
    r.recs = [(i, p, n, t, a, b, {k: x for k, x in c.items()
                                  if k not in ("k1", "rows_in", "rows_out")})
              for i, p, n, t, a, b, c in r.recs]
    assert read("merge_roofline", v, r, monkeypatch) is None
    assert read("merge_ms", v, r, monkeypatch) == pytest.approx(50.0)


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_the_tracer_reads_none(name, chr14, monkeypatch):
    v, r = chr14
    assert read(name, v, r, monkeypatch) is not None
    monkeypatch.delattr(turingassembler_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "turingassembler_tpu_torch.tracing",
                        None)
    assert spec.load_module("metrics", name).read(v) is None


def test_the_new_cells_and_readers_are_in_the_benchmark():
    bench = spec.benchmark()
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in NAMES:
        m = listed[name]
        assert m["workloads"] == ["human-chr14.level0"]
        assert m["moves"] == "reads_per_s"
        assert (spec.HERE / "metrics" / f"{name}.py").is_file()
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["human-chr14.level0"]["config"] == "human-chr14-k63"
    assert cells["human-chr14.level0"]["traffic"] == "level0-large"
    assert cells["scerevisiae.aux_map"]["traffic"] == "aux_map"
    assert all(w["chips"] == 1 for w in bench["workloads"])
    c, cfg, mix, entry = spec.load_cell("human-chr14.level0", bench)
    level0 = spec.load_module("entries", "level0")
    assert mix["checked_jobs_per_library"] == 1
    assert entry.LIMITS == level0.LIMITS == {
        "kmers_wrong": 0, "unitigs_wrong": 0, "links_wrong": 0}
    assert all(x in spec.per_layer_metrics(bench, "scerevisiae.aux_map")
               for x in spec.per_layer_metrics(bench, "ecoli.aux_map"))
