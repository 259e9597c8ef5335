"""The port's barcode-guided repeat resolution (resolve/barcodes.py)
against the JAX package's: the 2-2 bridge tiers, the n-m node pass, the
complex-jungle pass, and the worklist twins.

The graphs are those of tests/test_barcode_resolve.py: two haplotypes
through a shared repeat (or a shared k-mer, or two repeats in swapped
order), reads from a numpy seed, the level-0 graph built by the JAX
package and carried across with convert.graph, barcode sets attached per
haplotype.  Tolerance: exact — the graph arrays, the barcode dicts in
insertion order, and the saved .bin bytes.
"""

import numpy as np
import pytest
import torch

from test_barcode_resolve import _attach_sets, _bridge_2_2_graph
from turingassembler_tpu import testing as jt
from turingassembler_tpu.graph.build import build_graph_from_kedges
from turingassembler_tpu.graph.mutable import MutableGraph as JMutable
from turingassembler_tpu.io import asmg as jasmg
from turingassembler_tpu.kmer.count import count_kedges_from_reads
from turingassembler_tpu.resolve import barcodes as JB
from turingassembler_tpu.resolve import driver as jdriver
from turingassembler_tpu_torch import convert
from turingassembler_tpu_torch.graph.invariants import check_graph
from turingassembler_tpu_torch.graph.mutable import MutableGraph as TMutable
from turingassembler_tpu_torch.io import asmg as tasmg
from turingassembler_tpu_torch.resolve import barcodes as TB
from turingassembler_tpu_torch.resolve import driver as tdriver

torch.set_num_threads(1)

ARRAYS = ("node_rc", "adj_off", "adj_list", "edge_source", "edge_target",
          "edge_rc", "edge_count", "seq_off", "seq_data")

# barcode sets per haplotype part, as tests/test_barcode_resolve.py
# gives them to each strictness tier of the 2-2 bridge
TIERS = {
    "high": (7, {"A0": range(0, 150), "B0": range(0, 150),
                 "A1": range(150, 300), "B1": range(150, 300),
                 "R": range(0, 300, 10)}),
    "med": (17, {"A0": range(0, 150),
                 "B0": list(range(0, 150)) + list(range(940, 1000)),
                 "A1": range(900, 1050),
                 "B1": list(range(950, 1050)) + list(range(2000, 2050)),
                 "R": range(3000, 3030)}),
    "low": (19, {"A0": list(range(0, 1000)), "A1": list(range(2000, 3000)),
                 "B0": (list(range(0, 50)) + list(range(2950, 2980))
                        + list(range(20000, 20920))),
                 "B1": (list(range(2000, 2050)) + list(range(950, 980))
                        + list(range(30000, 30920))),
                 "R": range(40000, 40030)}),
}


def _labeller(g, parts):
    """Name of the haplotype part an edge's middle lies in, else "R"."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    strs = {name: jt.codes_to_str(p) for name, p in parts.items()}

    def which(e):
        s = jt.codes_to_str(g.get_seq(e))
        rc = "".join(comp[ch] for ch in reversed(s))
        for name, hs in strs.items():
            if s[50:-50] and (s[50:-50] in hs or rc[50:-50] in hs):
                return name
        return "R"
    return which


def _haplotype_graph(h0, h1, seeds, k=21):
    r0, l0 = jt.sim_reads(h0, coverage=30, read_len=100, seed=seeds[0])
    r1, l1 = jt.sim_reads(h1, coverage=30, read_len=100, seed=seeds[1])
    ke, c = count_kedges_from_reads(np.concatenate([r0, r1]),
                                    np.concatenate([l0, l1]), k)
    g = build_graph_from_kedges(ke, c, k)
    g.barcodes = [[{}, {}, {}] for _ in range(g.n_e)]
    g.barcodes_scaf = [{} for _ in range(g.n_e)]
    g.barcodes_cov = [{} for _ in range(g.n_e)]
    g.aux_flag |= 1
    return g


def tier_graph(tier):
    seed, bsets = TIERS[tier]
    g, which, _ = _bridge_2_2_graph(np.random.default_rng(seed))
    _attach_sets(g, which, bsets)
    return g


def n_m_node_graph():
    """2-in/2-out node: one shared k-mer between two haplotypes."""
    rng = np.random.default_rng(23)
    parts = {n: rng.integers(0, 4, 3500).astype(np.uint8)
             for n in ("A0", "A1", "B0", "B1")}
    S = rng.integers(0, 4, 21).astype(np.uint8)
    g = _haplotype_graph(np.concatenate([parts["A0"], S, parts["B0"]]),
                         np.concatenate([parts["A1"], S, parts["B1"]]),
                         (3, 4))
    _attach_sets(g, _labeller(g, parts),
                 {"A0": range(0, 150), "B0": range(0, 150),
                  "A1": range(150, 300), "B1": range(150, 300),
                  "R": range(0, 300, 10)})
    return g


def jungle_graph():
    """Two molecules through the same two short repeats in swapped order:
    a tangle of short edges between four long flanks."""
    rng = np.random.default_rng(21)
    parts = {n: rng.integers(0, 4, 6000).astype(np.uint8)
             for n in ("A", "B", "C", "D")}
    R1 = rng.integers(0, 4, 300).astype(np.uint8)
    R2 = rng.integers(0, 4, 300).astype(np.uint8)
    g = _haplotype_graph(
        np.concatenate([parts["A"], R1, R2, parts["B"]]),
        np.concatenate([parts["C"], R2, R1, parts["D"]]), (5, 6))
    _attach_sets(g, _labeller(g, parts),
                 {"A": range(0, 150), "B": range(0, 150),
                  "C": range(150, 300), "D": range(150, 300),
                  "R": range(0, 300, 10)})
    return g


GRAPHS = {"high": lambda: tier_graph("high"),
          "med": lambda: tier_graph("med"),
          "low": lambda: tier_graph("low"),
          "n_m_node": n_m_node_graph, "jungle": jungle_graph}


@pytest.fixture(scope="module")
def graphs():
    return {name: make() for name, make in GRAPHS.items()}


def dict_items(g):
    """Barcode aux info as lists of (key, value) in insertion order (None
    where the graph carries none: condense drops it)."""
    items = lambda ds: None if ds is None else [list(d.items()) for d in ds]  # noqa: E731
    return (None if g.barcodes is None else [items(lv) for lv in g.barcodes],
            items(g.barcodes_scaf), items(g.barcodes_cov))


def assert_same_graph(jg, tg, tmp_path, name="g"):
    """The port's graph equals the JAX package's: arrays, holes, barcode
    aux info with its dicts in insertion order, and the .bin bytes."""
    want = convert.graph(jg)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(tg, f), getattr(want, f),
                                      err_msg=f)
    assert sorted(tg.holes) == sorted(want.holes)
    assert dict_items(tg) == dict_items(want)
    assert tg.candidates == want.candidates
    assert tg.aux_flag == want.aux_flag
    jp, tp = tmp_path / f"{name}_jax.bin", tmp_path / f"{name}_port.bin"
    jasmg.save_graph(jg, str(jp))
    tasmg.save_graph(tg, str(tp))
    assert jp.read_bytes() == tp.read_bytes()


def alive(g):
    return int(g.alive_mask().sum())


# ---------------------------------------------------------------------------
# the three entry points (full-rescan oracles below VEC_MIN_EDGES)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["high", "med", "low", "n_m_node"])
def test_resolve_n_m_simple(graphs, name, tmp_path):
    g = graphs[name]
    jg = JB.resolve_n_m_simple(g.clone())
    tg = TB.resolve_n_m_simple(convert.graph(g))
    check_graph(tg, check_seq=True)
    assert_same_graph(jg, tg, tmp_path)
    if name != "n_m_node":          # each tier joins its bridge
        assert alive(tg) < alive(g)


@pytest.mark.parametrize("name", ["high", "n_m_node", "jungle"])
def test_resolve_n_m_bridges(graphs, name, tmp_path):
    g = graphs[name]
    jg = JB.resolve_n_m_bridges(g.clone())
    tg = TB.resolve_n_m_bridges(convert.graph(g))
    check_graph(tg, check_seq=True)
    assert_same_graph(jg, tg, tmp_path)
    if name == "n_m_node":          # the node pass joins the legs
        assert alive(tg) < alive(g)


@pytest.mark.parametrize("name", ["jungle", "high"])
def test_resolve_complex(graphs, name, tmp_path):
    g = graphs[name]
    jg = JB.resolve_complex(g.clone())
    tg = TB.resolve_complex(convert.graph(g))
    assert_same_graph(jg, tg, tmp_path)
    if name == "jungle":            # legs joined over 50-N gaps
        assert alive(tg) < alive(g)
        assert tg.holes


def test_level_chain(graphs, tmp_path):
    """build_3_4 then build_4_5 on one graph, as the CLI chains them.
    Condense drops the aux info, so level 4 carries no barcode sets and
    resolve_complex joins nothing there, in both packages, though it
    joins the same jungle given its barcodes."""
    g = graphs["jungle"]
    j4, t4 = JB.resolve_n_m_simple(g.clone()), TB.resolve_n_m_simple(
        convert.graph(g))
    assert j4.barcodes is None and t4.barcodes is None
    jg, tg = JB.resolve_complex(j4), TB.resolve_complex(t4)
    assert_same_graph(jg, tg, tmp_path)
    assert alive(tg) == alive(t4) and not tg.holes
    assert alive(TB.resolve_complex(convert.graph(g))) < alive(t4)


# ---------------------------------------------------------------------------
# the worklist twins, called directly
# ---------------------------------------------------------------------------

def _alive_key(g):
    return sorted((g.get_seq(int(e)).tobytes(), int(g.edge_count[e]))
                  for e in np.flatnonzero(g.alive_mask()))


@pytest.mark.parametrize("name", ["high", "med", "low", "n_m_node"])
def test_n_m_simple_fast(graphs, name, tmp_path):
    """The port's worklist twin equals the JAX twin exactly, and yields
    the live edges of the port's own full-rescan oracle."""
    g = graphs[name]
    tg = TB.resolve_n_m_simple_fast(convert.graph(g))
    assert_same_graph(JB.resolve_n_m_simple_fast(g.clone()), tg, tmp_path)
    assert _alive_key(tg) == _alive_key(TB.resolve_n_m_simple(
        convert.graph(g)))


@pytest.mark.parametrize("name", ["n_m_node", "jungle", "high"])
def test_n_m_bridges_fast(graphs, name, tmp_path):
    g = graphs[name]
    tg = TB.resolve_n_m_bridges_fast(convert.graph(g))
    assert_same_graph(JB.resolve_n_m_bridges_fast(g.clone()), tg, tmp_path)
    assert _alive_key(tg) == _alive_key(TB.resolve_n_m_bridges(
        convert.graph(g)))
    again = TB.resolve_n_m_bridges_fast(tg.clone())
    assert _alive_key(again) == _alive_key(tg)


def test_vec_min_edges_dispatch(graphs, monkeypatch, tmp_path):
    """With VEC_MIN_EDGES set low in both packages, the entry points take
    their worklist twins, and still agree."""
    monkeypatch.setattr(jdriver, "VEC_MIN_EDGES", 1)
    monkeypatch.setattr(tdriver, "VEC_MIN_EDGES", 1)
    calls = []
    fast = TB.resolve_n_m_simple_fast
    monkeypatch.setattr(TB, "resolve_n_m_simple_fast",
                        lambda g: calls.append(g.n_e) or fast(g))
    for name in ("low", "n_m_node"):
        g = graphs[name]
        jg = JB.resolve_n_m_bridges(JB.resolve_n_m_simple(g.clone()))
        tg = TB.resolve_n_m_bridges(TB.resolve_n_m_simple(convert.graph(g)))
        assert_same_graph(jg, tg, tmp_path, name)
    assert len(calls) == 2


def test_gates_and_dirty_edges(graphs):
    """The worklist gates and the dirty-edge sets, node by node and edge
    by edge, on every graph."""
    for g in graphs.values():
        jm, tm = JMutable.from_asm(g.clone()), TMutable.from_asm(
            convert.graph(g))
        for e in range(tm.n_e):
            assert TB._gate_2_2(tm, e) == JB._gate_2_2(jm, e)
            assert TB._gate_n_m_bridge(tm, e) == JB._gate_n_m_bridge(jm, e)
        for u in range(tm.n_v):
            assert TB._gate_n_m_node(tm, u) == JB._gate_n_m_node(jm, u)
        nodes = list(range(0, tm.n_v, 3)) + [-1, tm.n_v]
        assert TB._dirty_edges(tm, nodes) == JB._dirty_edges(jm, nodes)
        assert TB._mean_cov(tm) == JB._mean_cov(jm)


@pytest.mark.parametrize("name", ["high", "med", "low"])
def test_tiers_before_condense(graphs, name, tmp_path):
    """The three tiers on the mutable graph, compared before condense
    (which drops the aux info): the surviving edges keep their barcode
    dicts, and each tier returns the JAX tier's count."""
    g = graphs[name]
    jm, tm = JMutable.from_asm(g.clone()), TMutable.from_asm(convert.graph(g))
    jr, tr = JB.BarcodeResolver(jm), TB.BarcodeResolver(tm)
    for tier in ("high", "med", "low"):
        check = f"check_2_2_{tier}_strict"
        assert TB._resolve_2_2_tier(tm, tr, getattr(tr, check)) == \
            JB._resolve_2_2_tier(jm, jr, getattr(jr, check))
    tg = tm.to_asm()
    assert tg.barcodes is not None
    assert_same_graph(jm.to_asm(), tg, tmp_path)
