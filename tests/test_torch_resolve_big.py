"""The port's 2-1-2 repeat resolution by coverage (resolve/big.py)
against the JAX package's.

The graph is make_212_genome of tests/test_resolve_big.py: two sequences
through one 60 bp repeat, reads from a numpy seed at two depths (the
coverage pass joins only legs whose coverages separate 1.7x), built by
the JAX package and carried across with convert.graph.  Tolerance:
exact — the 2-1-2 case per edge, the join counts, the graph arrays.
"""

import numpy as np
import pytest

from test_resolve_big import make_212_genome
from turingassembler_tpu import testing as jt
from turingassembler_tpu.graph.build import build_graph_from_kedges
from turingassembler_tpu.graph.mutable import MutableGraph as JMutable
from turingassembler_tpu.kmer.count import count_kedges_from_reads
from turingassembler_tpu.resolve import big as JBIG
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch.graph.condense import asm_condense
from turingassembler_tpu_torch.graph.invariants import check_graph
from turingassembler_tpu_torch.graph.mutable import MutableGraph as TMutable
from turingassembler_tpu_torch.resolve import big as TBIG

ARRAYS = ("node_rc", "adj_off", "adj_list", "edge_source", "edge_target",
          "edge_rc", "edge_count", "seq_off", "seq_data")

# (haplotype 0 depth, haplotype 1 depth, resolves): at 50x against 20x
# the legs separate and the pass joins; at equal depth it refuses
DEPTHS = {"split": (50, 20, True), "equal": (35, 35, False)}


@pytest.fixture(scope="module", params=list(DEPTHS))
def case(request):
    c0, c1, resolves = DEPTHS[request.param]
    k = 21
    h0, h1 = make_212_genome(rep_len=60, k=k)
    r0, l0 = jt.sim_reads(h0, coverage=c0, read_len=150, seed=3)
    r1, l1 = jt.sim_reads(h1, coverage=c1, read_len=150, seed=4)
    ke, c = count_kedges_from_reads(np.concatenate([r0, r1]),
                                    np.concatenate([l0, l1]), k)
    return build_graph_from_kedges(ke, c, k), resolves


def mutables(g):
    return JMutable.from_asm(g.clone()), TMutable.from_asm(convert.graph(g))


def assert_same(jm, tm):
    want, got = convert.graph(jm.to_asm()), tm.to_asm()
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_is_case_2_1_2(case):
    g, _ = case
    jm, tm = mutables(g)
    got = [TBIG.is_case_2_1_2(tm, e) for e in range(tm.n_e)]
    assert got == [JBIG.is_case_2_1_2(jm, e) for e in range(jm.n_e)]
    assert sum(got) >= 1
    for e in np.flatnonzero(got):
        assert TBIG._legs(tm, int(e)) == JBIG._legs(jm, int(e))
        assert TBIG._gate_212(tm, int(e)) and JBIG._gate_212(jm, int(e))


def test_resolve_212_by_cov_1step(case):
    g, resolves = case
    jm, tm = mutables(g)
    n = TBIG.resolve_212_by_cov_1step(tm)
    assert n == JBIG.resolve_212_by_cov_1step(jm)
    assert (n >= 1) == resolves
    assert_same(jm, tm)


def test_resolve_212_by_cov(case):
    """The worklist pass equals the JAX one, and its oracle (one-step
    rescans to the fixpoint) in the port gives the same live edges."""
    g, resolves = case
    jm, tm = mutables(g)
    n = TBIG.resolve_212_by_cov(tm)
    assert n == JBIG.resolve_212_by_cov(jm)
    assert (n >= 1) == resolves
    assert_same(jm, tm)
    check_graph(asm_condense(tm.to_asm()), check_seq=True)

    oracle = TMutable.from_asm(convert.graph(g))
    n_o = 0
    while True:
        r = TBIG.resolve_212_by_cov_1step(oracle)
        if not r:
            break
        n_o += r
    assert n_o == n

    def key(mg):
        gx = mg.to_asm()
        return sorted((gx.get_seq(int(e)).tobytes(), int(gx.edge_count[e]))
                      for e in np.flatnonzero(gx.alive_mask()))
    assert key(oracle) == key(tm)


def test_try_212_cov_and_similar_cov(case):
    g, _ = case
    jm, tm = mutables(g)
    for e in range(tm.n_e):
        assert TBIG._try_212_cov(tm, e) == JBIG._try_212_cov(jm, e)
    assert_same(jm, tm)
    for a, b in ((10.0, 8.1), (10.0, 8.0), (8.0, 10.0), (3.0, 30.0)):
        assert TBIG._similar_cov(a, b) == JBIG._similar_cov(a, b)
