"""Fixpoint simplification loops (a copy of
turingassembler_tpu/resolve/driver.py with the bubble DP's device passed
down as an argument).

Mirrors `resolve_graph_operation` (reference src/basic_resolve.c:1068-1106)
and the local variant (:1027-1066): tips -> condense -> topo tips ->
condense -> chimeric -> condense -> {loops + bubbles + lazy-condense}* ->
condense, iterated until no tip/chimeric change.
"""

from __future__ import annotations

from ..graph.condense import asm_condense
from ..graph.mutable import MutableGraph
from ..graph.structs import AsmGraph
from . import basic


def _pass_and_condense(g: AsmGraph, fn) -> tuple:
    mg = MutableGraph.from_asm(g)
    cnt = fn(mg)
    return asm_condense(mg.to_asm()), cnt


def _loops_and_bubbles(g: AsmGraph, device="cuda") -> AsmGraph:
    mg = MutableGraph.from_asm(g)
    while True:
        cnt = basic.unroll_simple_loop(mg)
        cnt += basic.resolve_simple_bubble(mg)
        cnt += basic.resolve_align_bubble(mg, device=device)
        cnt += basic.resolve_loop(mg)
        basic.lazy_condense(mg)
        if cnt == 0:
            break
    return mg.to_asm()


# above this edge count the mask->tombstone passes (resolve/vectorized)
# run first to shrink the graph before any python-object conversion —
# metagenome-scale graphs never pay the per-edge loops for the bulk of
# the tip/chimeric/bubble mass
VEC_MIN_EDGES = 20_000


def _vectorized_prepass(g: AsmGraph, log=None) -> AsmGraph:
    from . import vectorized as V
    g = g.clone()   # the passes tombstone in place; don't touch the input
    it = 0
    while g.n_e >= VEC_MIN_EDGES:
        it += 1
        c_tips = V.remove_tips(g)
        g = asm_condense(g)
        c_topo = V.remove_tips_topo(g)
        g = asm_condense(g)
        c_chim = V.remove_chimeric(g)
        g = asm_condense(g)
        c_bub = V.resolve_simple_bubble(g)
        g = asm_condense(g)
        if log:
            log(f"vectorized prepass {it}: tips={c_tips} topo={c_topo} "
                f"chimeric={c_chim} bubbles={c_bub} -> n_e={g.n_e}")
        if c_tips + c_topo + c_chim + c_bub == 0:
            break
    return g


def resolve_graph_operation(g: AsmGraph, log=None,
                            device="cuda") -> AsmGraph:
    """`device` is where the align-bubble check scores its candidate
    pairs (the NW kernel on "cuda"); every other pass is host code."""
    if g.n_e >= VEC_MIN_EDGES:
        g = _vectorized_prepass(g, log)
    it = 0
    while True:
        it += 1
        g, cnt_tips = _pass_and_condense(g, basic.remove_tips)
        g, cnt_topo = _pass_and_condense(g, basic.remove_tips_topo)
        g, cnt_chim = _pass_and_condense(g, basic.remove_chimeric)
        g = _loops_and_bubbles(g, device)
        g = asm_condense(g)
        if log:
            log(f"resolve iteration {it}: tips={cnt_tips} "
                f"topo={cnt_topo} chimeric={cnt_chim}")
        if cnt_tips + cnt_topo + cnt_chim == 0:
            return g


# the local-graph variant runs the identical schedule (reference
# resolve_local_graph_operation basic_resolve.c:1027-1066)
resolve_local_graph_operation = resolve_graph_operation
