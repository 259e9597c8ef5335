"""turingassembler_tpu_torch/tracing.py: spans off and on, how they nest,
their counts, and the span trees of the count, the level-0 build and the
map on the CPU, whose outputs tracing leaves as they are."""

import threading

import numpy as np
import pytest
import torch

from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch import tracing
from turingassembler_tpu_torch.graph import device_build as tdb
from turingassembler_tpu_torch.kmer import megasort as tms
from turingassembler_tpu_torch.mapper import minimizers as tm

torch.set_num_threads(1)

ID, PARENT, NAME, THREAD, T0, T1, COUNTS = range(7)


@pytest.fixture
def traced():
    """Tracing on from start(), the records emptied before and after."""
    tracing.clear()
    tracing.start()
    try:
        yield
    finally:
        tracing.stop()
        tracing.clear()


def by_name(recs, name):
    return [r for r in recs if r[NAME] == name]


def children(recs, parent):
    return [r for r in recs if r[PARENT] == parent[ID]]


def test_off_records_nothing_and_returns_the_shared_no_op():
    tracing.stop()
    tracing.clear()
    assert not tracing.enabled()
    a, b = tracing.span("a", rows=1), tracing.span("b")
    assert a is b
    with a as got:
        tracing.add(rows=3)
        tracing.host_sync()
    assert got is None
    assert tracing.records() == []


def test_a_profiler_session_turns_tracing_on_and_its_exit_off():
    tracing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.enabled()
        with tracing.span("inside"):
            pass
    assert not tracing.enabled()
    with tracing.span("after"):
        pass
    assert [r[NAME] for r in tracing.records()] == ["inside"]
    tracing.clear()


def test_start_and_stop_turn_tracing_on_and_off():
    tracing.clear()
    tracing.start()
    try:
        assert tracing.enabled()
        with tracing.span("on", rows=2):
            pass
    finally:
        tracing.stop()
    assert not tracing.enabled()
    with tracing.span("off"):
        pass
    (r,) = tracing.records()
    assert r[NAME] == "on" and r[COUNTS] == {"rows": 2}
    assert r[THREAD] == threading.get_ident()
    assert 0 < r[T0] <= r[T1]
    tracing.clear()
    assert tracing.records() == []


def test_parents_nest_and_counts_land_on_the_innermost_span(traced):
    with tracing.span("root", rows=1):
        tracing.add(rows=2)
        with tracing.span("root.a"):
            tracing.host_sync()
            with tracing.span("root.a.b"):
                tracing.host_sync(3)
                tracing.add(bytes=10)
            tracing.add(bytes=5)
        tracing.host_sync()
    recs = tracing.records()
    assert [r[NAME] for r in recs] == ["root.a.b", "root.a", "root"]
    b, a, root = recs
    assert root[PARENT] is None
    assert a[PARENT] == root[ID] and b[PARENT] == a[ID]
    assert root[COUNTS] == {"rows": 3, "syncs": 1}
    assert a[COUNTS] == {"syncs": 1, "bytes": 5}
    assert b[COUNTS] == {"syncs": 3, "bytes": 10}
    assert root[T0] <= a[T0] <= b[T0] <= b[T1] <= a[T1] <= root[T1]
    tracing.add(rows=1)                  # no span open: nothing to add to
    assert tracing.records()[2][COUNTS] == {"rows": 3, "syncs": 1}


def test_parents_stay_per_thread(traced):
    inside, go = threading.Barrier(2), threading.Barrier(2)

    def work(tag):
        with tracing.span(f"root.{tag}"):
            inside.wait()               # both roots open at once
            with tracing.span(f"child.{tag}"):
                tracing.host_sync()
                go.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = tracing.records()
    for tag in "xy":
        (root,), (child,) = by_name(recs, f"root.{tag}"), \
            by_name(recs, f"child.{tag}")
        assert root[PARENT] is None and child[PARENT] == root[ID]
        assert child[THREAD] == root[THREAD]
        assert child[COUNTS] == {"syncs": 1} and root[COUNTS] == {}
    assert by_name(recs, "root.x")[0][THREAD] != \
        by_name(recs, "root.y")[0][THREAD]


# ---------------------------------------------------------------------------
# the port's layers on the CPU
# ---------------------------------------------------------------------------

K = 31
RECORD = 300                  # reads a count record here (COUNT_CHUNK)


@pytest.fixture(scope="module")
def world():
    g = tt.random_genome(6_000, seed=41)
    reads, lens = tt.sim_reads(g, coverage=12, read_len=100, seed=42,
                               error_rate=0.003)
    batches = [(reads[i:i + 128], lens[i:i + 128])
               for i in range(0, len(reads), 128)]
    # reads with an indel each: some vote for an edge and fail the
    # gapless bound, so they go to the DP
    mr, ml = tt.sim_indel_reads(g, 200, read_len=100, seed=43)
    sr, sl = tt.sim_reads(g, coverage=2, read_len=100, seed=44)
    return dict(batches=batches, reads=np.concatenate([mr, sr]),
                lens=np.concatenate([ml, sl]))


def run_layers(world, monkeypatch):
    monkeypatch.setattr(tms, "COUNT_CHUNK", RECORD)
    uniq, counts, n = tms.count_kedges_megasort_device(
        iter(world["batches"]), K, min_count=2, device="cpu")
    g = tdb.build_graph_on_device(uniq, counts, n, K, device="cpu")
    index = tm.EdgeMinimizerIndex.build(g, device="cpu")
    mapped = tm.map_reads(index, world["reads"], world["lens"], graph=g,
                          with_hits=False, device="cpu")
    return (uniq[:n].numpy(), counts[:n].numpy(), g.seq_data,
            g.edge_source, *mapped)


def test_count_span_tree(world, monkeypatch, traced):
    monkeypatch.setattr(tms, "COUNT_CHUNK", RECORD)
    waited_in = []

    def source():
        # each batch is asked for inside a record's production
        for b in world["batches"]:
            waited_in.append(tracing._stack()[-1].name)
            yield b

    uniq, counts, n = tms.count_kedges_megasort_device(
        source(), K, min_count=2, device="cpu")
    recs = tracing.records()
    (root,) = by_name(recs, "count")
    reads = sum(len(b) for b, _ in world["batches"])
    n_rec = -(-reads // RECORD)
    assert root[PARENT] is None
    assert root[COUNTS]["records"] == n_rec
    ships = by_name(recs, "count.ship")
    extracts = by_name(recs, "count.extract")
    assert len(ships) == len(extracts) == n_rec
    # one ship a record, its bytes the record's (bases and lengths)
    widths = [max(b.shape[1] for b, _ in world["batches"])] * n_rec
    sizes = [RECORD] * (n_rec - 1) + [reads - RECORD * (n_rec - 1)]
    assert [s[COUNTS]["bytes"] for s in ships] == \
        [r * (w + 4) for r, w in zip(sizes, widths)]
    assert all(s[COUNTS]["pageable"] == 1 for s in ships)
    assert root[COUNTS]["rows"] == sum(e[COUNTS]["rows"] for e in extracts)
    # the wait on the batches inside the records' production: a count on
    # count.coalesce, no span a batch
    coalesce = by_name(recs, "count.coalesce")
    assert len(coalesce) == n_rec + 1        # the last finds the end
    assert waited_in == ["count.coalesce"] * len(world["batches"])
    waits = [c[COUNTS]["source_ns"] for c in coalesce
             if "source_ns" in c[COUNTS]]
    assert len(waits) >= n_rec and all(w >= 0 for w in waits)
    assert sum(waits) <= sum(c[T1] - c[T0] for c in coalesce)
    assert not by_name(recs, "count.source")
    (sort,) = by_name(recs, "count.sort")
    assert sort[COUNTS]["rows"] == root[COUNTS]["rows"]
    (filt,) = by_name(recs, "count.filter")
    assert filt[COUNTS]["syncs"] == 1
    assert sort[COUNTS]["unique"] >= n
    assert not by_name(recs, "count.merge")
    assert not by_name(recs, "count.sort.lsd")      # the card's route
    # every span of the layer hangs under the root
    assert {r[PARENT] for r in children(recs, root)} == {root[ID]}
    assert {r[NAME] for r in children(recs, root)} == {
        "count.coalesce", "count.ship", "count.extract", "count.sort",
        "count.filter"}


def test_count_merges_under_count_merge(world, monkeypatch, traced):
    monkeypatch.setattr(tms, "COUNT_CHUNK", RECORD)
    tms.count_kedges_megasort_device(iter(world["batches"]), K,
                                     max_lanes=20_000, device="cpu")
    recs = tracing.records()
    sorts, merges = by_name(recs, "count.sort"), by_name(recs, "count.merge")
    assert len(sorts) >= 2 and len(merges) == len(sorts) - 1
    (root,) = by_name(recs, "count")
    assert all(m[PARENT] == root[ID] for m in merges)
    assert not by_name(recs, "count.filter")


def test_build_span_tree(world, monkeypatch, traced):
    monkeypatch.setattr(tms, "COUNT_CHUNK", RECORD)
    uniq, counts, n = tms.count_kedges_megasort_device(
        iter(world["batches"]), K, min_count=2, device="cpu")
    tracing.clear()
    g = tdb.build_graph_on_device(uniq, counts, n, K, device="cpu")
    recs = tracing.records()
    (root,) = by_name(recs, "build")
    assert root[COUNTS]["unitigs"] == g.n_e
    assert [r[NAME] for r in children(recs, root)] == [
        "build.front", "build.rank", "build.assemble", "build.host"]
    (asm,) = by_name(recs, "build.assemble")
    assert asm[COUNTS]["syncs"] == 2
    assert asm[COUNTS]["bytes"] == \
        8 * (5 * g.n_e + 2) + len(g.seq_data)
    assert by_name(recs, "build.rank")[0][COUNTS]["syncs"] == 1


def test_map_span_tree(world, monkeypatch):
    monkeypatch.setattr(tms, "COUNT_CHUNK", RECORD)
    uniq, counts, n = tms.count_kedges_megasort_device(
        iter(world["batches"]), K, min_count=2, device="cpu")
    g = tdb.build_graph_on_device(uniq, counts, n, K, device="cpu")
    index = tm.EdgeMinimizerIndex.build(g, device="cpu")
    sent = []
    real = tm._dp_verify_rest

    def spy(*a, **kw):
        sent.append(len(a[6]))
        return real(*a, **kw)

    monkeypatch.setattr(tm, "_dp_verify_rest", spy)
    reads, lens = world["reads"], world["lens"]
    tracing.clear()
    tracing.start()
    try:
        edges, _, _ = tm.map_reads(index, reads, lens, graph=g,
                                   with_hits=False, batch_size=256,
                                   device="cpu")
    finally:
        tracing.stop()
    recs = tracing.records()
    tracing.clear()
    (root,) = by_name(recs, "map")
    assert root[COUNTS] == {"reads": len(reads),
                            "mapped": int((edges >= 0).sum())}
    assert [r[NAME] for r in children(recs, root)] == [
        "map.ship", "map.vote", "map.dp", "map.pull"]
    (ship,) = by_name(recs, "map.ship")
    assert ship[COUNTS] == {"bytes": reads.nbytes + lens.nbytes,
                            "pageable": 1}
    (dp,) = by_name(recs, "map.dp")
    assert sent and dp[COUNTS]["pairs"] == sum(sent) > 0
    assert dp[COUNTS]["syncs"] == 2          # the nonzero, the scores
    (pull,) = by_name(recs, "map.pull")
    assert pull[COUNTS]["syncs"] == 2
    vote = by_name(recs, "map.vote")[0]
    assert vote[COUNTS].get("pool_builds", 0) in (0, 1)


def test_outputs_are_the_same_with_tracing_on_and_off(world, monkeypatch):
    tracing.stop()
    off = run_layers(world, monkeypatch)
    tracing.clear()
    tracing.start()
    try:
        on = run_layers(world, monkeypatch)
    finally:
        tracing.stop()
    names = {r[NAME].split(".")[0] for r in tracing.records()}
    tracing.clear()
    assert names == {"count", "build", "map"}
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# On the card: the counted syncs are the syncs the card sees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["ecoli.level0", "ecoli.aux_map",
                                  "scerevisiae.level0"])
def test_counted_syncs_are_the_cards(cell):
    """At the benchmark's shapes, after a cell's set-up, one job's syncs
    counted by host_sync() in each span equal the synchronizing CUDA calls
    torch's sync debug mode warns of while that span is innermost (a
    pull, an .item(), a nonzero, a blocking copy): a sync added to the
    count, the build or the map without its host_sync() fails here."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the sync debug mode counts the "
                    "card's syncs")
    import warnings

    from asmbench import library, spec, trace
    dev = torch.device("cuda")
    _, config, mix, entry = spec.load_cell(cell, spec.benchmark())
    libs = library.make_libraries(config, 20_240_607, mix["libraries"], dev)
    spans = trace.Spans(dev)
    st = entry.setup(config, mix, libs, dev, spans)
    seen = {}

    def show(message, *a, **kw):
        if "synchroniz" in str(message):
            stack = tracing._stack()
            name = stack[-1].name if stack else None
            seen[name] = seen.get(name, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        tracing.clear()
        tracing.start()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            if mix["entry"] == "level0":
                entry.count_and_build(st, st.batches[0], spans)
            else:
                entry.job(st, 0, spans)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            tracing.stop()
    counted = {}
    for r in tracing.records():
        if r[COUNTS].get("syncs"):
            counted[r[NAME]] = counted.get(r[NAME], 0) + r[COUNTS]["syncs"]
    tracing.clear()
    seen.pop(None, None)                # the harness's own, outside
    assert counted == seen
    assert sum(counted.values()) > 0
