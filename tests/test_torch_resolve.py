"""The port's graph simplification passes against the JAX package's, on
error-laden diploid graphs: each pass of resolve/basic.py, each of
resolve/vectorized.py, the bulge passes, the bubble DP batch, and the
fixpoint loop with and without the vectorised prepass.

The same JAX-built graph goes into both packages (the port's through
convert.graph).  Tolerance: exact equality of counts and graph arrays.
"""

import numpy as np
import pytest
import torch

from turingassembler_tpu.graph import build as jbuild
from turingassembler_tpu.graph.mutable import MutableGraph as JMutable
from turingassembler_tpu.kmer.count import count_kedges_from_reads
from turingassembler_tpu.ops.pallas_align import banded_affine_score
from turingassembler_tpu.resolve import basic as jbasic
from turingassembler_tpu.resolve import bulges as jbulges
from turingassembler_tpu.resolve import driver as jfix
from turingassembler_tpu.resolve import vectorized as jvec
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch import testing as tt
from turingassembler_tpu_torch.graph.mutable import MutableGraph as TMutable
from turingassembler_tpu_torch.ops import nw_align
from turingassembler_tpu_torch.resolve import basic as tbasic
from turingassembler_tpu_torch.resolve import bulges as tbulges
from turingassembler_tpu_torch.resolve import driver as tfix
from turingassembler_tpu_torch.resolve import vectorized as tvec

torch.set_num_threads(1)

GRAPH_ARRAYS = ("node_rc", "adj_off", "adj_list", "edge_source",
                "edge_target", "edge_rc", "edge_count", "seq_off", "seq_data")
K = 45


def assert_graphs_equal(a, b):
    for f in GRAPH_ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert sorted(a.holes) == sorted(b.holes)


def hard_graph(seed):
    """Level-0 graph (built on the host by the JAX package) of two
    haplotypes with read errors at min count 1: tips, chimeric links and error bubbles; a
    3-unit tandem repeat (a simple loop); variant clusters every 600 bp
    whose bubbles reach the alignment check; one 300 bp region replaced
    in the second haplotype (a bulge)."""
    rng = np.random.default_rng(seed)

    def rnd(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    unit = rnd(40)
    a = np.concatenate([rnd(3000), unit, unit, unit, rnd(3000), rnd(300),
                        rnd(6000)])
    b, _ = tt.second_haplotype(a, seed=seed + 1, cell=600)
    b = b.copy()
    b[6200:6500] = rnd(300)
    ra, la = tt.sim_reads(a, 25, 100, seed=seed + 2, error_rate=0.01)
    rb, lb = tt.sim_reads(b, 25, 100, seed=seed + 3, error_rate=0.01)
    ke, c = count_kedges_from_reads(np.concatenate([ra, rb]),
                                    np.concatenate([la, lb]), K, engine="np")
    return jbuild.build_graph_from_kedges(ke, c, K)


@pytest.fixture(scope="module", params=[1, 2])
def graphs(request):
    """(level-0 graph, the graph after tips, topo tips and chimeric
    removal with condense: what the loop and bubble passes meet)."""
    g0 = hard_graph(request.param)
    g1 = g0
    for fn in (jbasic.remove_tips, jbasic.remove_tips_topo,
               jbasic.remove_chimeric):
        g1, _ = jfix._pass_and_condense(g1, fn)
    return g0, g1


BASIC_PASSES = ["remove_tips", "remove_tips_topo", "remove_chimeric",
                "unroll_simple_loop", "resolve_simple_bubble",
                "resolve_align_bubble", "resolve_loop", "lazy_condense",
                "resolve_dump_loop", "resolve_dump_branch"]
# passes that must find work on the cleaned graph, so the comparison is
# not of two no-ops
MUST_FIRE = {"unroll_simple_loop", "resolve_simple_bubble",
             "resolve_align_bubble", "resolve_dump_branch"}


@pytest.mark.parametrize("stage", ["level0", "cleaned"])
@pytest.mark.parametrize("name", BASIC_PASSES)
def test_basic_pass(graphs, name, stage):
    g = graphs[0] if stage == "level0" else graphs[1]
    mj = JMutable.from_asm(g)
    mt = TMutable.from_asm(convert.graph(g))
    kw = {"device": "cpu"} if name == "resolve_align_bubble" else {}
    cj = getattr(jbasic, name)(mj)
    ct = getattr(tbasic, name)(mt, **kw)
    assert cj == ct
    assert_graphs_equal(mj.to_asm(), mt.to_asm())
    if stage == "level0" and name.startswith("remove_"):
        assert ct > 100
    if stage == "cleaned" and name in MUST_FIRE:
        assert ct > 0


def test_check_align_bubble_single_edge(graphs):
    """The per-edge form scores its pairs on the spot."""
    g = graphs[1]
    mj = JMutable.from_asm(g)
    mt = TMutable.from_asm(convert.graph(g))
    hits = 0
    for se in range(mj.n_e):
        if mj.edges[se].source == -1:
            continue
        cj = jbasic.check_align_bubble(mj, se)
        ct = tbasic.check_align_bubble(mt, se, device="cpu")
        assert cj == ct
        hits += ct > 0
    assert hits > 3
    assert_graphs_equal(mj.to_asm(), mt.to_asm())


def bubble_pairs(seed):
    """Branch pairs as the bubble check meets them, plus the edge cases:
    a 999-long pair, a pair whose lengths differ by 150, identical and
    unrelated pairs, a 1-base pair."""
    rng = np.random.default_rng(seed)

    def rnd(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    pairs = []
    for _ in range(40):
        a = rnd(int(rng.integers(90, 400)))
        b = a.copy()
        for _ in range(int(rng.integers(0, 4))):
            b[rng.integers(0, len(b))] = rng.integers(0, 4)
        cut = int(rng.integers(0, 40))
        at = int(rng.integers(0, len(b) - cut))
        pairs.append((a, np.concatenate([b[:at], b[at + cut:]])))
    long_a = rnd(999)
    long_b = long_a.copy()
    long_b[[5, 500, 990]] = (long_b[[5, 500, 990]] + 1) % 4
    pairs.append((long_a, long_b))
    wide = rnd(400)
    pairs.append((wide, wide[:250]))            # lengths differ by 150
    pairs.append((rnd(120), rnd(130)))
    pairs.append((long_a[:1], long_a[:1]))
    return pairs


@pytest.mark.parametrize("seed", [0, 1])
def test_nw_align_scores_batch(seed):
    pairs = bubble_pairs(seed)
    want = jbasic.nw_align_scores_batch(pairs)
    got = tbasic.nw_align_scores_batch(pairs, device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(pairs),)
    np.testing.assert_array_equal(got, want)
    assert got[40] == 999 - 2 * 3 and got[-1] == 1


def test_nw_align_scores_batch_empty_makes_no_tensor():
    before = nw_align.COUNT.launches
    got = tbasic.nw_align_scores_batch([], device="cuda")   # no GPU needed
    assert got.shape == (0,) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jbasic.nw_align_scores_batch([]))
    assert nw_align.COUNT.launches == before


def test_wide_length_difference_is_refused_either_way():
    """A pair whose lengths differ by 128 or more: the port's full-width
    score equals the JAX package's on both of its lowerings (the scan,
    and the Pallas kernel in interpret mode under the band the bubble
    check names), and the accept rule refuses it, so the port's dropping
    of the band and the power-of-two pad changes no decision."""
    rng = np.random.default_rng(4)
    for diff in (128, 150, 300):
        a = rng.integers(0, 4, 500).astype(np.uint8)
        b = a[: 500 - diff]
        got = int(tbasic.nw_align_scores_batch([(a, b)], device="cpu")[0])
        assert got == int(jbasic.nw_align_scores_batch([(a, b)])[0])
        L = 512
        q = np.full((1, L), 255, np.uint8)
        t = np.full((1, L), 255, np.uint8)
        q[0, :500], t[0, :len(b)] = a, b
        pallas = int(np.asarray(banded_affine_score(
            q, np.array([500], np.int32), t, np.array([len(b)], np.int32),
            W=256, match=1, mismatch=-1, go=0, ge=3, interpret=True,
            mode="global"))[0])
        assert pallas == got == (500 - diff) - 3 * diff
        assert not tbasic._bubble_accept(got, 500, len(b))
        assert not jbasic._bubble_accept(got, 500, len(b))


VEC_PASSES = ["remove_tips", "remove_tips_topo", "remove_chimeric",
              "resolve_simple_bubble"]


@pytest.mark.parametrize("name", VEC_PASSES)
def test_vectorized_pass(graphs, name):
    g = graphs[0]
    gj, gt = g.clone(), convert.graph(g)
    cj = getattr(jvec, name)(gj)
    ct = getattr(tvec, name)(gt)
    assert cj == ct and ct > 0
    assert_graphs_equal(gj, gt)


@pytest.mark.parametrize("name", ["resolve_simple_bulges",
                                  "resolve_complex_bulges"])
def test_vectorized_bulges(graphs, name):
    g = jfix.resolve_graph_operation(graphs[1])
    want = getattr(jvec, name)(g.clone())
    got = getattr(tvec, name)(convert.graph(g))
    assert_graphs_equal(want, got)
    if name == "resolve_simple_bulges":
        assert got.n_e < g.n_e


@pytest.mark.parametrize("vec_min", [10, 1 << 60])
def test_bulge_passes_ite(graphs, vec_min, monkeypatch):
    """resolve_simple_bulges_ite and resolve_complex_bulges_ite, through
    their vectorised form (threshold low) and their per-node form."""
    monkeypatch.setattr(jfix, "VEC_MIN_EDGES", vec_min)
    monkeypatch.setattr(tfix, "VEC_MIN_EDGES", vec_min)
    g = jfix.resolve_graph_operation(graphs[1])
    gt = convert.graph(g)
    j1 = jbulges.resolve_simple_bulges_ite(g)
    t1 = tbulges.resolve_simple_bulges_ite(gt)
    assert_graphs_equal(j1, t1)
    j2 = jbulges.resolve_complex_bulges_ite(j1)
    t2 = tbulges.resolve_complex_bulges_ite(t1)
    assert_graphs_equal(j2, t2)
    assert int(t2.alive_mask().sum()) < int(g.alive_mask().sum())


@pytest.mark.parametrize("vec_min", [10, 1 << 60])
def test_resolve_graph_operation(graphs, vec_min, monkeypatch):
    """The fixpoint loop from level 0, with the vectorised prepass
    forced on (threshold low in both packages) and off."""
    monkeypatch.setattr(jfix, "VEC_MIN_EDGES", vec_min)
    monkeypatch.setattr(tfix, "VEC_MIN_EDGES", vec_min)
    g = graphs[0]
    lines_j, lines_t = [], []
    want = jfix.resolve_graph_operation(g.clone(), log=lines_j.append)
    got = tfix.resolve_graph_operation(convert.graph(g),
                                          log=lines_t.append, device="cpu")
    assert_graphs_equal(want, got)
    assert lines_j == lines_t
    assert any("vectorized prepass" in x for x in lines_t) == (vec_min == 10)
    assert got.n_e < g.n_e // 10


def test_resolve_chain_takes_device_as_argument():
    """No pass reads a global for its device: asking for CUDA without a
    GPU raises from the bubble check, and only when there are pairs."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    a = np.zeros(120, np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tbasic.nw_align_scores_batch([(a, a)])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tbasic.nw_align_scores_batch([(a, a)], device="cuda")
