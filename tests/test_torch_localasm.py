"""The port's local assembly (localasm/local.py, localasm/bridge.py), its
count (kmer/count.py) and evaluate.py against the JAX package, module by
module, on the same inputs made from seeds.  Integers, arrays, strings
and EvalResult fields are compared exactly.  The JAX functions run on
the CPU; the port's run with device="cpu" (the NW kernel's plain version
scores the bubble check and the path scoring).
"""

import dataclasses

import numpy as np
import pytest
import torch

from turingassembler_tpu import config as jcfg
from turingassembler_tpu import evaluate as jev
from turingassembler_tpu.graph import structs as jstructs
from turingassembler_tpu.graph.from_contigs import \
    graph_from_contigs as j_from_contigs
from turingassembler_tpu.kmer import count as jcount
from turingassembler_tpu.localasm import bridge as JB
from turingassembler_tpu.localasm import local as JL
from turingassembler_tpu_torch import _build
from turingassembler_tpu_torch import cli as tcli
from turingassembler_tpu_torch import config as tcfg
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch import evaluate as tev
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.kmer import count as tcount
from turingassembler_tpu_torch.localasm import bridge as TB
from turingassembler_tpu_torch.localasm import local as TL
from turingassembler_tpu_torch.ops import nw_align

torch.set_num_threads(1)

ARRAYS = ("node_rc", "adj_off", "adj_list", "edge_source", "edge_target",
          "edge_rc", "edge_count", "seq_off", "seq_data")


def assert_graphs_equal(a, b):
    assert a.ksize == b.ksize
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def jax_graph(g):
    """The port's AsmGraph as the JAX package's (arrays copied)."""
    out = jstructs.AsmGraph(ksize=g.ksize)
    for f in ARRAYS:
        setattr(out, f, getattr(g, f).copy())
    return out


def emap_tuple(m):
    return (m.gl_e, m.lc_e, m.gpos.start, m.gpos.end, m.lpos.start,
            m.lpos.end)


def to_str(codes):
    return np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode()


def find_edge(g, seq):
    """The edge whose sequence starts with seq's first 50 bases and has
    its length."""
    return next(e for e in range(g.n_e)
                if g.edge_len(e) == len(seq)
                and (g.get_seq(e)[:50] == seq[:50]).all())


# ---------------------------------------------------------------------------
# kmer/count.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("n_reads,batch", [(2_500, 1_000), (700, 4_096)])
def test_count_kedges_from_reads(n_reads, batch, min_count):
    """The JAX engine="np" pads the tail batch to batch_size reads of
    length 0; the port does not pad.  Same table either way."""
    genome = tt.random_genome(6_000, seed=n_reads)
    reads, lens = tt.sim_reads(genome, coverage=30, read_len=90,
                               seed=batch, error_rate=0.01)
    reads, lens = reads[:n_reads], lens[:n_reads]
    reads[0, 7] = 4                                  # an N breaks windows
    want = jcount.count_kedges_from_reads(reads, lens, 31, batch_size=batch,
                                          min_count=min_count, engine="np")
    got = tcount.count_kedges_from_reads(reads, lens, 31, batch_size=batch,
                                         min_count=min_count, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert len(got[0]) > 1_000


def test_count_kedges_multi():
    rng = np.random.default_rng(3)
    sets = []
    for i in range(3):
        g = rng.integers(0, 4, 3_000 + 400 * i).astype(np.uint8)
        r, ln = tt.sim_reads(g, coverage=6, read_len=80, error_rate=0.01,
                             seed=i)
        r[0, 5] = 4
        sets.append((r, ln))
    sets.insert(1, None)
    want = JL.count_kedges_multi(sets, 31)
    got = TL.count_kedges_multi(sets, 31)
    assert len(got) == 4 and len(got[1][0]) == 0
    for (ka, ca), (kb, cb) in zip(got, want):
        np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(ca, cb)


# ---------------------------------------------------------------------------
# a gap: two global flank contigs and the reads of the region between
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gap():
    """Flanks A and B of 3,000 bases around a 700-base gap, the reads of
    A + gap + B and of a second haplotype of it (a variant cluster every
    600 bases) at 20x each with 1% substitutions, so the local graph has
    tips, error bubbles and bubbles for the align check; a global graph
    of A and B."""
    rng = np.random.default_rng(5)
    a, mid, b = (rng.integers(0, 4, n).astype(np.uint8)
                 for n in (3_000, 700, 3_000))
    region = np.concatenate([a, mid, b])
    hap_b, _ = tt.second_haplotype(region, seed=3, cell=600)
    ra, la = tt.sim_reads(region, coverage=20, read_len=100, seed=6,
                          error_rate=0.01)
    rb, lb = tt.sim_reads(hap_b, coverage=20, read_len=100, seed=7,
                          error_rate=0.01)
    reads, lens = np.concatenate([ra, rb]), np.concatenate([la, lb])
    jg = j_from_contigs([a, b], 31)
    jg.edge_count[:] = 30 * jg.edge_len()        # coverage 30
    g = convert.graph(jg)
    return dict(jg=jg, g=g, ea=find_edge(g, a), eb=find_edge(g, b),
                reads=reads, lens=lens, region=region)


def build_both(gap, cfg_kw=None):
    kedges, counts = TL.count_kedges_multi([(gap["reads"], gap["lens"])],
                                           31)[0]
    j = JL.build_local_graph(jcfg.Config(), gap["jg"], None, None, gap["ea"],
                             gap["eb"], precounted=(kedges, counts))
    t = TL.build_local_graph(tcfg.Config(), gap["g"], None, None, gap["ea"],
                             gap["eb"], precounted=(kedges, counts),
                             device="cpu")
    return j, t


def test_build_local_graph_precounted(gap, monkeypatch):
    """Flank garbage k-mers, count calibration, the local resolve (its
    bubble check through ops/dp.py): the same graph arrays, node
    numbering included (first appearance, as the JAX package's C++
    library numbers them)."""
    from turingassembler_tpu_torch.resolve import basic
    scored = []
    score = basic.nw_align_scores_batch

    def counted(pairs, device):
        scored.append(len(pairs))
        return score(pairs, device)

    monkeypatch.setattr(basic, "nw_align_scores_batch", counted)
    j, t = build_both(gap)
    assert_graphs_equal(t, j)
    assert t.n_e >= 2 and sum(scored) >= 10


def test_local_graph_numbering_is_the_jax_packages(gap):
    from turingassembler_tpu.graph import build as jbuild
    from turingassembler_tpu_torch.graph import build as tbuild
    kedges, counts = TL.count_kedges_multi([(gap["reads"], gap["lens"])],
                                           31)[0]
    assert jbuild._NATIVE_GRAPH is not None
    assert_graphs_equal(tbuild.build_graph_from_kedges(kedges, counts, 31,
                                                       first_seen=True),
                        jbuild.build_graph_from_kedges(kedges, counts, 31))


def test_flank_maps(gap):
    j, t = build_both(gap)
    for fn in ("get_local_edge_head", "get_local_edge_tail"):
        for e in (gap["ea"], gap["eb"]):
            want = getattr(JL, fn)(gap["jg"], j, e)
            got = getattr(TL, fn)(gap["g"], t, e)
            assert emap_tuple(got) == emap_tuple(want)
    assert TL.get_local_edge_head(gap["g"], t, gap["ea"]).lc_e >= 0


def test_window_cache_keys_carry_the_graph(gap):
    """A window table cached for one global graph never answers a lookup
    for another graph with the same edge id and length."""
    g2 = gap["g"].clone()
    e = gap["ea"]
    g2.seq_data = g2.seq_data.copy()
    lo = int(g2.seq_off[e])
    g2.seq_data[lo:lo + 3_000] = tt.random_genome(3_000, seed=99)
    _, t = build_both(gap)
    TL.clear_global_window_cache()
    assert TL.get_local_edge_tail(gap["g"], t, e).lc_e >= 0
    assert TL.global_contig_key(g2, e) != TL.global_contig_key(gap["g"], e)
    assert TL.get_local_edge_tail(g2, t, e).lc_e == -1
    TL.clear_global_window_cache()


# ---------------------------------------------------------------------------
# MapContig: the union join against the per-edge oracle
# ---------------------------------------------------------------------------

def map_contig_case():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 4, 2_600).astype(np.uint8)
    shared = rng.integers(0, 4, 400).astype(np.uint8)
    contigs = [np.concatenate([base[:1_200], shared]),
               np.concatenate([shared, base[1_200:2_400]]), base[2_400:]]
    q = np.concatenate([rng.integers(0, 4, 300).astype(np.uint8),
                        base[:1_200], shared, base[1_200:2_400],
                        rng.integers(0, 4, 300).astype(np.uint8)])
    jg = j_from_contigs(contigs, 31)
    return jg, convert.graph(jg), q


@pytest.mark.parametrize("collide", [False, True])
def test_map_contig_join_equals_oracle(collide, monkeypatch):
    """collide: every 100-mer hashes to one of two values, so the union
    table sees distinct keys with equal hashes and falls back to the
    void-key order."""
    jg, g, q = map_contig_case()
    if collide:
        monkeypatch.setattr(
            TL, "_hash_void_keys",
            lambda keys, k: (keys.view(np.uint8).reshape(len(keys), k)[:, 0]
                             % 2).astype(np.uint64))
    mc = TL.MapContig(q, g)
    assert (mc.uhash_sorted is None) == collide
    for pos in range(0, len(q), TL.WINDOW_SIZE // 4):
        assert mc._match_window_uncached(pos) == mc._match_window_ref(pos)
    jm = JL.MapContig(q, jg)
    assert mc.find_match() == jm.find_match() >= 0
    np.testing.assert_array_equal(mc.is_match, jm.is_match)
    got, want = mc.match_positions(), jm.match_positions()
    assert (got[0].start, got[0].end, got[1].start, got[1].end) == \
        (want[0].start, want[0].end, want[1].start, want[1].end)


# ---------------------------------------------------------------------------
# a local graph with two paths between its flanks
# ---------------------------------------------------------------------------

FLANK = 1_000


@pytest.fixture(scope="module")
def two_path():
    lg, paths, (e1, e2), (sx, sy) = tt.two_path_local_graph(
        7, flank=FLANK)
    left, right, x = sx[:FLANK], sx[-FLANK:], sx[FLANK:-FLANK]
    jg = j_from_contigs([left, right, x], 31)
    g = convert.graph(jg)
    return dict(lg=lg, paths=paths, lc=(e1, e2), sx=sx, sy=sy, jg=jg, g=g,
                eL=find_edge(g, left), eR=find_edge(g, right),
                eX=find_edge(g, x))


def test_two_path_graph(two_path):
    lg, paths = two_path["lg"], two_path["paths"]
    assert len(paths) == 2
    lens = sorted(len(TB.path_center_seq(lg, p)) for p in paths)
    assert lens == [len(two_path["sy"]), len(two_path["sx"])]


def emaps(tp, jax_side):
    mod, g, lg = (JL, tp["jg"], jax_graph(tp["lg"])) if jax_side \
        else (TL, tp["g"], tp["lg"].clone())
    return (mod, g, lg, mod.get_local_edge_head(g, lg, tp["eL"]),
            mod.get_local_edge_tail(g, lg, tp["eR"]))


def test_filters_and_path_search(two_path):
    """unrelated_filter with the X branch as a scaffold contig removes
    that branch; then the connection and coverage filters; the paths
    found after; each step's graph and flank maps equal."""
    sides = [emaps(two_path, j) for j in (True, False)]
    assert emap_tuple(sides[0][3]) == emap_tuple(sides[1][3])
    assert sides[1][3].lc_e == two_path["lc"][0]
    reads = np.stack([two_path["sx"][:2_000], two_path["sy"][:2_000]])
    lens = np.full(2, 2_000, np.int32)
    kset = TL.read_kmer_set(reads, lens, 37)
    assert kset == JL.read_kmer_set(reads, lens, 37) and len(kset) > 2_500
    results = []
    for mod, g, lg, m1, m2 in sides:
        steps = []
        paths = mod.get_all_paths_kmer_check(lg, m1, m2, 37, kset)
        steps.append((paths,))
        lg, m1, m2 = mod.unrelated_filter(g, lg, m1, m2,
                                          [two_path["eL"], two_path["eX"],
                                           two_path["eR"]])
        steps.append((lg, m1, m2))
        for fn in (mod.connection_filter, mod.coverage_filter):
            lg, m1, m2 = fn(g, lg, m1, m2)
            steps.append((lg, m1, m2))
        steps.append((mod.get_all_paths_kmer_check(lg, m1, m2, 37, kset),))
        results.append(steps)
    for sj, st in zip(*results):
        if len(sj) == 1:
            assert sj[0] == st[0]
        else:
            assert_graphs_equal(st[0], sj[0])
            assert emap_tuple(st[1]) == emap_tuple(sj[1])
            assert emap_tuple(st[2]) == emap_tuple(sj[2])
    assert len(results[1][0][0]) == 2 and len(results[1][-1][0]) == 1


@pytest.mark.parametrize("source", ["x", "y"])
def test_score_paths_two_paths(two_path, source):
    """The reads of one allele, with 0.5% substitutions and a single-base
    indel in 2% of reads: the same best path as the JAX function, and it
    is the path the reads came from."""
    lg, paths = two_path["lg"], two_path["paths"]
    seq = two_path["s" + source]
    reads, lens, n1 = tt.read_pairs_of(seq, 600, seed=8)
    want = JB._score_paths_impl(jax_graph(lg), paths, reads, lens, n1)
    got = TB.score_paths(lg, paths, reads, lens, n1, device="cpu")
    assert got == want
    assert len(TB.path_center_seq(lg, paths[got])) == len(seq)
    edges, starts, accept, scores, _ = TB.path_read_hits(
        lg, paths, reads, lens, device="cpu")
    assert accept.sum() > 300 and (accept == (edges >= 0)).all()
    assert (scores[accept] >= lens[accept] - TB.FULL_LEN_SLACK).all()


def test_score_paths_no_paths(two_path):
    reads, lens, n1 = tt.read_pairs_of(two_path["sx"], 10, seed=1)
    assert TB.score_paths(two_path["lg"], [], reads, lens, n1,
                          device="cpu") == -1


def bridge_case(tp, kind):
    """(port args, JAX args) of try_bridging for one outcome."""
    reads, lens, n1 = tt.read_pairs_of(tp["sx"], 600, seed=9)
    local = (reads, lens, n1)
    if kind == "path_not_found":            # no read crosses a branch
        other = tt.random_genome(3_000, seed=10)
        local = tt.read_pairs_of(other, 300, seed=11)
    out = []
    for jax_side in (False, True):
        mod, g, lg, m1, m2 = emaps(tp, jax_side)
        if kind == "local_not_found":
            m1 = mod.EdgeMap(gl_e=tp["eL"])
        elif kind == "trivial":
            lg = (j_from_contigs if jax_side else
                  lambda s, k: convert.graph(j_from_contigs(s, k)))(
                [tp["sx"]], 31)
            m1 = mod.get_local_edge_head(g, lg, tp["eL"])
            m2 = mod.get_local_edge_tail(g, lg, tp["eR"])
        cfg = (jcfg if jax_side else tcfg).Config()
        out.append((cfg, g, lg, [tp["eL"], tp["eR"]], m1, m2, local))
    return out


@pytest.mark.parametrize("kind,code", [("local_not_found", 0),
                                       ("trivial", 1),
                                       ("multiple_path", 2),
                                       ("path_not_found", 3)])
def test_try_bridging_outcomes(two_path, kind, code):
    port, jax_args = bridge_case(two_path, kind)
    want = JB.try_bridging(*jax_args)
    got = TB.try_bridging(*port, device="cpu")
    assert got == want
    assert got[0] == code
    if code == 2:       # the path of the reads' allele, gapless
        assert got[1] == to_str(two_path["sx"])
    if code in (0, 3):
        assert "N" * TB.DUMP_N_LEN in got[1]


# ---------------------------------------------------------------------------
# the joins and the merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["keep_global", "keep_local", "max_global",
                                  "max_local"])
def test_sync_global_local(mode):
    rng = np.random.default_rng(2)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for _ in range(20):
        gs = acgt[rng.integers(0, 4, rng.integers(50, 200))].tobytes().decode()
        ls = acgt[rng.integers(0, 4, rng.integers(50, 200))].tobytes().decode()
        g0, l0 = (int(rng.integers(0, len(s) // 2)) for s in (gs, ls))
        g1, l1 = (int(rng.integers(a, len(s))) for a, s in ((g0, gs),
                                                             (l0, ls)))
        got = TB.sync_global_local(gs, ls, TL.SubseqPos(g0, g1),
                                   TL.SubseqPos(l0, l1), mode)
        want = JB.sync_global_local(gs, ls, JL.SubseqPos(g0, g1),
                                    JL.SubseqPos(l0, l1), mode)
        assert got == want


def test_joins_and_merge(two_path):
    tp = two_path
    (_, jg, jlg, jm1, jm2), (_, g, lg, m1, m2) = (emaps(tp, True),
                                                  emaps(tp, False))
    assert TB.join_bridge_dump(g, tp["eL"], tp["eR"]) == \
        JB.join_bridge_dump(jg, tp["eL"], tp["eR"])
    for p in tp["paths"]:
        assert TB.join_bridge_by_path(g, lg, p, m1, m2) == \
            JB.join_bridge_by_path(jg, jlg, p, jm1, jm2)
        assert TB.path_center_seq(lg, p) == JB.path_center_seq(jlg, p)
    assert TB.join_bridge_no_path(g, lg, m1, m2) == \
        JB.join_bridge_no_path(jg, jlg, jm1, jm2)
    one = convert.graph(j_from_contigs([tp["sx"]], 31))
    jone = j_from_contigs([tp["sx"]], 31)
    t1, t2 = (TL.get_local_edge_head(g, one, tp["eL"]),
              TL.get_local_edge_tail(g, one, tp["eR"]))
    j1, j2 = (JL.get_local_edge_head(jg, jone, tp["eL"]),
              JL.get_local_edge_tail(jg, jone, tp["eR"]))
    assert TB.join_trivial_bridge(g, one, t1, t2) == \
        JB.join_trivial_bridge(jg, jone, j1, j2)
    # the merge of consecutive bridges over a path of three contigs
    path = [tp["eL"], tp["eX"], tp["eR"]]
    bridged = [TB.join_bridge_dump(g, a, b) for a, b in zip(path, path[1:])]
    merged = TB._merge_bridges(g, path, bridged)
    assert merged == JB._merge_bridges(jg, path, bridged)
    assert merged.count("N" * TB.DUMP_N_LEN) == 2


def test_parse_scaffold_paths(tmp_path):
    p = tmp_path / "paths.txt"
    p.write_text("2\n3\n4 7 1\n2\n0 9\n")
    assert TB.parse_scaffold_paths(str(p)) == \
        JB.parse_scaffold_paths(str(p)) == [[4, 7, 1], [0, 9]]


# ---------------------------------------------------------------------------
# read_kmer_set, _max_consec_missing, recount_local_graph_cov
# ---------------------------------------------------------------------------

def test_read_kmer_set_and_missing_runs():
    rng = np.random.default_rng(4)
    reads = rng.integers(0, 4, (50, 120)).astype(np.uint8)
    lens = rng.integers(30, 121, 50).astype(np.int32)
    reads[np.arange(120)[None, :] >= lens[:, None]] = 255
    reads[3, 10] = 4
    kset = TL.read_kmer_set(reads, lens, 37)
    assert kset == JL.read_kmer_set(reads, lens, 37)
    for _ in range(30):
        a = rng.integers(0, 4, rng.integers(31, 90)).astype(np.uint8)
        b = rng.integers(0, 4, rng.integers(31, 90)).astype(np.uint8)
        if rng.random() < 0.5:
            a = reads[rng.integers(0, 50), :60].copy() % 4
        assert TL._max_consec_missing(a, b, 31, 37, kset) == \
            JL._max_consec_missing(a, b, 31, 37, kset)


def cov_fixture():
    rng = np.random.default_rng(7)
    a, b, c = (rng.integers(0, 4, n).astype(np.uint8)
               for n in (4_000, 4_000, 600))
    jg = j_from_contigs([to_str(s) for s in (a, b, c)], 31)
    g = convert.graph(jg)
    return jg, g, (a, b, c), [find_edge(g, s) for s in (a, b, c)]


def reads_from(seq, lo, hi, n, seed):
    rng = np.random.default_rng(seed)
    starts = rng.integers(lo, hi - 100 + 1, n)
    return (np.stack([seq[s:s + 100] for s in starts]).astype(np.uint8),
            np.full(n, 100, np.int32))


@pytest.mark.parametrize("case", ["deep_flank", "head_and_interior",
                                  "rc_flank"])
def test_recount_local_graph_cov(case):
    """The three positional-gate cases of tests/test_localcov.py."""
    jg, g, (a, b, c), (ea, eb, ec) = cov_fixture()
    e1 = ea
    if case == "deep_flank":
        reads, lens = reads_from(a, 3_100, 4_000, 200, 1)
    elif case == "head_and_interior":
        ra, la = reads_from(a, 0, 1_000, 300, 2)
        rc_, lc = reads_from(c, 0, 600, 100, 3)
        reads, lens = np.concatenate([ra, rc_]), np.concatenate([la, lc])
    else:
        e1 = int(g.edge_rc[ea])
        reads, lens = reads_from(a, 0, 900, 200, 4)
    JL.recount_local_graph_cov(jg, jg, e1, eb, reads, lens, lc_e1=e1,
                               lc_e2=eb)
    TL.recount_local_graph_cov(g, g, e1, eb, reads, lens, lc_e1=e1,
                               lc_e2=eb, device="cpu")
    np.testing.assert_array_equal(g.edge_count, jg.edge_count)
    if case == "head_and_interior":
        assert g.edge_count[ec] > 0 and g.edge_count[ea] > 0
    else:
        assert g.edge_count[e1] == 0


# ---------------------------------------------------------------------------
# entry points on a machine without a GPU
# ---------------------------------------------------------------------------

def test_entry_points_raise_without_gpu(gap, two_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    reads, lens = gap["reads"][:10], gap["lens"][:10]
    kedges, counts = TL.count_kedges_multi([(gap["reads"], gap["lens"])],
                                           31)[0]
    calls = [
        lambda: tcount.count_kedges_from_reads(reads, lens, 31),
        lambda: TL.build_local_graph(tcfg.Config(), gap["g"], None, None,
                                     gap["ea"], gap["eb"],
                                     precounted=(kedges, counts)),
        lambda: TB.score_paths(two_path["lg"], two_path["paths"], reads,
                               lens, 5),
        lambda: TB.build_bridge(tcfg.Config(), gap["g"], None, "missing"),
    ]
    before = nw_align.COUNT.launches
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
    assert nw_align.COUNT.launches == before


def test_launch_count_from_threads():
    """The bridge stage's worker threads launch the NW kernel: its
    counter must lose no update under contention (16 threads, more than
    this machine's cores, a switch interval of a microsecond)."""
    import sys
    import threading
    count = _build.LaunchCount({"banded_affine_score": ("pairs",)})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda i=i: [
            count.add("banded_affine_score", i + 1, 150, 182, pairs=i + 1)
            for _ in range(2_000)]) for i in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert count.launches == 32_000 == len(count.shapes)
    assert count.total("pairs") == 2_000 * sum(range(1, 17))
    count.reset()
    assert (count.launches, count.total("pairs"), count.shapes) == (0, 0, [])


# ---------------------------------------------------------------------------
# evaluate.py
# ---------------------------------------------------------------------------

def eval_cases():
    g20 = to_str(tt.random_genome(20_000, seed=3))
    half = len(g20) // 2
    g100 = to_str(tt.random_genome(100_000, seed=7))
    rng = np.random.default_rng(3)
    carr = list(g100)
    for p in sorted(rng.choice(np.arange(1_000, 99_000), 12, replace=False)):
        carr[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[carr[p]]
    rc = str.maketrans("ACGT", "TGCA")
    two = [("chr1", g20), ("chr2", g100[:30_000])]
    return {
        "perfect": ([g20], g20),
        "halves": ([g20[:half], g20[half:]], g20),
        "swapped_halves": ([g20[half:] + g20[:half]], g20),
        "substitutions": (["".join(carr)], g100),
        "prefix": ([g100[:50_000]], g100),
        "deletion": ([g100[:30_000] + g100[30_005:60_000]], g100),
        "reverse_complement": ([g20[5_000:15_000].translate(rc)[::-1],
                                g20[:4_000]], g20),
        "inversion_glued": ([g20[:8_000]
                             + g20[8_000:12_000].translate(rc)[::-1]
                             + g20[12_000:]], g20),
        "translocation": ([g20[:9_000] + g100[5_000:14_000]], two),
        "with_n_gap": ([g20[:9_000] + "N" * 100 + g20[9_100:]], g20),
    }


@pytest.mark.parametrize("name", list(eval_cases()))
def test_evaluate_assembly(name):
    contigs, genome = eval_cases()[name]
    got = tev.evaluate_assembly(contigs, genome)
    want = jev.evaluate_assembly(contigs, genome)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert str(got) == str(want)
    if name in ("swapped_halves", "inversion_glued", "translocation"):
        assert got.n_misassemblies >= 1
    else:
        assert got.n_misassemblies == 0


def test_evaluate_inverted_repeat_family_fault():
    """The JAX package's _anchor_index keeps the k-mers of a sequence X
    that occurs once when rc(X) occurs twice (both rc copies fall to the
    duplicate pass first), so a correct contig across one rc(X) copy,
    read off either strand, anchors that copy to X's locus: two phantom
    misassemblies.  The port copies the fault (ROADMAP queue C)."""
    rng = np.random.default_rng(12)
    p1, p2, p3, p4 = (to_str(rng.integers(0, 4, 5_000).astype(
        np.uint8)) for _ in range(4))
    x = to_str(rng.integers(0, 4, 1_500).astype(np.uint8))
    rc = str.maketrans("ACGT", "TGCA")
    xr = x.translate(rc)[::-1]
    genome = p1 + x + p2 + xr + p3 + xr + p4
    locus = p2[-2_000:] + xr + p3[:2_000]
    contig = locus.translate(rc)[::-1]
    got = tev.evaluate_assembly([contig], genome)
    want = jev.evaluate_assembly([contig], genome)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_misassemblies == 2 and got.n_inversions == 2
    fwd = tev.evaluate_assembly([locus], genome)
    assert dataclasses.asdict(fwd) == dataclasses.asdict(
        jev.evaluate_assembly([locus], genome))
    assert fwd.n_misassemblies == 2
    # without the second rc copy the same contig is one clean block
    assert tev.evaluate_assembly(
        [contig], p1 + x + p2 + xr + p3 + p4).n_misassemblies == 0


def test_cli_evaluate(tmp_path, capsys):
    from turingassembler_tpu import cli as jcli
    contigs, genome = eval_cases()["swapped_halves"]
    asm, ref = tmp_path / "asm.fasta", tmp_path / "ref.fasta"
    asm.write_text("".join(f">c{i}\n{s}\n" for i, s in enumerate(contigs)))
    ref.write_text(f">g\n{genome}\n")
    args = ["evaluate", "-f", str(asm), "-ref", str(ref), "-o", str(tmp_path)]
    assert tcli.main(args + ["--device", "cpu"]) == 1
    got = capsys.readouterr().out
    assert jcli.main(args) == 1
    assert got == capsys.readouterr().out
    assert "misassemblies=1" in got
    assert tcli.main(["evaluate", "-o", str(tmp_path), "--device",
                      "cpu"]) == 2
