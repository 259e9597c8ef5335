"""2-1-2 repeat resolution by coverage — rebuild of src/resolve_big.c
(resolve_212_by_cov_1step :496-545).

A "2-1-2" is a short middle edge e with exactly two in-legs (a0, a1) and
two out-legs (o0, o1).  Legs pair up when their coverages separate
>= 1.7x on both sides and match across (similar_cov = within 0.8x).

The host half of turingassembler_tpu/resolve/big.py, copied line for
line.  Its span k-mer resolver (SpanKmerTable, resolve_using_pair_kmer,
resolve_212_pair_kmer_all), whose table is built by jitted device code,
has no command that calls it and is not ported.
"""

from __future__ import annotations

from ..graph.mutable import MutableGraph


def _legs(g: MutableGraph, i_e: int):
    source = g.edges[i_e].source
    target = g.edges[i_e].target
    src_rc = g.node_rc[source]
    i_a0 = g.edges[g.node_adj[src_rc][0]].rc_id
    i_a1 = g.edges[g.node_adj[src_rc][1]].rc_id
    i_o0 = g.node_adj[target][0]
    i_o1 = g.node_adj[target][1]
    return i_a0, i_a1, i_o0, i_o1


def is_case_2_1_2(g: MutableGraph, i_e: int) -> bool:
    """reference resolve_big.c is_case_2_1_2."""
    if g.edges[i_e].source == -1:
        return False
    source = g.edges[i_e].source
    target = g.edges[i_e].target
    src_rc = g.node_rc[source]
    if g.deg(target) != 2 or g.deg(src_rc) != 2:
        return False
    i_a0r = g.node_adj[src_rc][0]
    i_a1r = g.node_adj[src_rc][1]
    i_a0, i_a1 = g.edges[i_a0r].rc_id, g.edges[i_a1r].rc_id
    i_o0 = g.node_adj[target][0]
    i_o1 = g.node_adj[target][1]
    if g.edges[i_a0].rc_id in (i_o0, i_o1) or g.edges[i_a1].rc_id in (i_o0, i_o1):
        return False
    if g.edges[i_a0].rc_id == i_a1 or g.edges[i_a1].rc_id == i_a0:
        return False
    return True



def _similar_cov(c1: float, c2: float) -> bool:
    return c2 > c1 * 0.8 and c1 > c2 * 0.8


def _try_212_cov(g: MutableGraph, i_e: int) -> int:
    """Single-edge body of the coverage 2-1-2 resolution (reference
    resolve_212_by_cov, src/resolve_big.c): join when each in-leg has a
    >=1.7x coverage-dominant partner out-leg with matching coverage."""
    if g.edges[i_e].source == -1 or not is_case_2_1_2(g, i_e):
        return 0
    i_a0, i_a1, i_o0, i_o1 = _legs(g, i_e)
    a0, a1 = g.edges[i_a0], g.edges[i_a1]
    o0, o1 = g.edges[i_o0], g.edges[i_o1]
    nodes = [a0.source, a0.target, a1.source, o0.source, o0.target, o1.target]
    expanded = []
    for u in nodes:
        expanded += [u, g.node_rc[u]]
    if len(set(expanded)) != len(expanded):
        return 0
    ca0, ca1 = g.edge_cov(i_a0), g.edge_cov(i_a1)
    co0, co1 = g.edge_cov(i_o0), g.edge_cov(i_o1)
    if not (ca0 > 1.7 * ca1 or ca1 > 1.7 * ca0):
        return 0
    if not (co0 > 1.7 * co1 or co1 > 1.7 * co0):
        return 0
    half = g.edges[i_e].count // 2
    if _similar_cov(ca0, co0) and _similar_cov(ca1, co1):
        g.join_edge3(i_a0, i_e, i_o0, half)
        g.join_edge3(i_a1, i_e, i_o1, half)
        g.remove_edge_pair(i_e)
        return 1
    if _similar_cov(ca0, co1) and _similar_cov(ca1, co0):
        g.join_edge3(i_a0, i_e, i_o1, half)
        g.join_edge3(i_a1, i_e, i_o0, half)
        g.remove_edge_pair(i_e)
        return 1
    return 0


def resolve_212_by_cov_1step(g: MutableGraph) -> int:
    count = 0
    for i_e in range(g.n_e):
        if g.edges[i_e].source == -1 or not is_case_2_1_2(g, i_e):
            continue
        i_a0, i_a1, i_o0, i_o1 = _legs(g, i_e)
        a0, a1 = g.edges[i_a0], g.edges[i_a1]
        o0, o1 = g.edges[i_o0], g.edges[i_o1]
        nodes = [a0.source, a0.target, a1.source, o0.source, o0.target, o1.target]
        expanded = []
        for u in nodes:
            expanded += [u, g.node_rc[u]]
        if len(set(expanded)) != len(expanded):
            continue
        ca0, ca1 = g.edge_cov(i_a0), g.edge_cov(i_a1)
        co0, co1 = g.edge_cov(i_o0), g.edge_cov(i_o1)
        if not (ca0 > 1.7 * ca1 or ca1 > 1.7 * ca0):
            continue
        if not (co0 > 1.7 * co1 or co1 > 1.7 * co0):
            continue
        half = g.edges[i_e].count // 2
        if _similar_cov(ca0, co0) and _similar_cov(ca1, co1):
            g.join_edge3(i_a0, i_e, i_o0, half)
            g.join_edge3(i_a1, i_e, i_o1, half)
            g.remove_edge_pair(i_e)
            count += 1
        elif _similar_cov(ca0, co1) and _similar_cov(ca1, co0):
            g.join_edge3(i_a0, i_e, i_o1, half)
            g.join_edge3(i_a1, i_e, i_o0, half)
            g.remove_edge_pair(i_e)
            count += 1
    return count


def _gate_212(g: MutableGraph, i_e: int) -> bool:
    e = g.edges[i_e]
    if e.source == -1:
        return False
    return g.deg(e.target) == 2 and g.deg(g.node_rc[e.source]) == 2


def resolve_212_by_cov(g: MutableGraph) -> int:
    """Worklist fixpoint of the coverage 2-1-2 pass — same result as
    `while resolve_212_by_cov_1step(g)` (the full rescans only ever act
    on edges passing the cheap 2-1-2 topology gate, and an untouched
    non-candidate repeats its outcome), but each round visits only
    gated candidates and mutations re-enqueue their distance-1
    neighborhood via the MutableGraph journal (the same pattern as
    resolve/barcodes' n-m worklists)."""
    import heapq

    from .barcodes import _dirty_edges

    total = 0
    pending = sorted(e for e in range(g.n_e) if _gate_212(g, e))
    while True:
        cnt_local = 0
        n_round = g.n_e
        heap = list(pending)
        heapq.heapify(heap)
        seen = set()
        nxt = set()
        while heap:
            i_e = heapq.heappop(heap)
            if i_e in seen:
                continue
            seen.add(i_e)
            if not _gate_212(g, i_e):
                continue
            g.touch_log = set()
            c = _try_212_cov(g, i_e)
            touched = g.touch_log
            g.touch_log = None
            cnt_local += c
            if touched:
                for d in _dirty_edges(g, touched):
                    if d >= n_round or d <= i_e or d in seen:
                        nxt.add(d)
                    else:
                        heapq.heappush(heap, d)
                nxt.add(i_e)
        total += cnt_local
        if cnt_local == 0:
            return total
        pending = sorted(d for d in nxt if d < g.n_e)
