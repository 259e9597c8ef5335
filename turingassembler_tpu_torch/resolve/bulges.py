"""Simple and complex bulge resolution.

Simple bulges (reference src/basic_resolve.c:1607-1741): an edge
e: u->v (<= 1000 bp) is removed when an alternative u->v path of similar
length (0.8x-1.2x) exists that avoids e; rejected (u,v,len) combinations
are memoized across condense iterations through node-id maps
(asm_condense_map) so repeated DFS work is skipped.

Complex bulges (reference src/complex_resolve.c:12-475): per source
vertex, grow a dominated-vertex set B (BFS with full in-degree
accounting), take its closure, reject complex closures (rc-symmetric /
self-loop / >= 1000 bp internal edge), and when the closure stops being
a tree, keep one BFS tree to the sinks and tombstone every other
internal edge; iterate with condense until no bulge remains.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Set

from ..graph.condense import asm_condense
from ..graph.mutable import MutableGraph
from ..graph.structs import AsmGraph

MAX_VISITED = 100000            # reference basic_resolve.c:25
MAX_BULGE_LEN = 1000            # reference basic_resolve.c:26
MAX_ALT_RATIO = 1.2             # reference basic_resolve.c:27
MIN_ALT_RATIO = 0.8             # reference basic_resolve.c:28


# ---------------------------------------------------------------------------
# simple bulges
# ---------------------------------------------------------------------------

def _find_alternative_path(g: MutableGraph, u: int, v: int, avoid_e: int,
                           length: int) -> bool:
    """Iterative DFS translation of find_alternative_path_dfs
    (basic_resolve.c:1607-1631): path u->v avoiding avoid_e with length
    in [0.8, 1.2] * length; start length = ksize."""
    visited = set()
    total = 0
    minl = MIN_ALT_RATIO * length
    maxl = MAX_ALT_RATIO * length

    # stack entries: (node, cur_len, iterator over adj indices)
    def adj_edges(x):
        return list(g.node_adj[x])

    stack = [(u, g.ksize, iter(adj_edges(u)))]
    visited.add(u)
    # note: target test happens on entry in the reference; replicate by
    # checking children before descending
    if u == v and g.ksize >= minl:
        return True
    while stack:
        node, cur_len, it = stack[-1]
        if total > MAX_VISITED:
            return False
        advanced = False
        for e in it:
            if e == avoid_e:
                continue
            nxt = g.edges[e].target
            nlen = cur_len + g.edges[e].seq_len - g.ksize
            if nlen > maxl:
                continue
            if nxt == v and nlen >= minl:
                return True
            if nxt in visited:
                continue
            if nxt == v:
                continue  # reached v but wrong length; v never marked
            total += 1
            visited.add(nxt)
            stack.append((nxt, nlen, iter(adj_edges(nxt))))
            advanced = True
            break
        if not advanced:
            stack.pop()
            visited.discard(node)
    return False


def _resolve_simple_bulges_once(g: MutableGraph, memo: Dict, node_map) -> int:
    res = 0
    for e in range(g.n_e):
        rc = g.edges[e].rc_id
        u = g.edges[e].source
        if u == -1:
            continue
        v = g.edges[e].target
        if u == g.node_rc[v]:
            continue
        if g.edges[e].seq_len > MAX_BULGE_LEN:
            continue
        if e > rc:
            continue
        code = (node_map[u], node_map[v])
        lens = memo.setdefault(code, [])
        L = g.edges[e].seq_len
        if any(MIN_ALT_RATIO * L <= x <= MAX_ALT_RATIO * L for x in lens):
            continue
        if _find_alternative_path(g, u, v, e, L):
            g.remove_edge_pair(e)
            res += 1
        else:
            lens.append(L)
    return res


def resolve_simple_bulges_ite(g: AsmGraph) -> AsmGraph:
    """Iterate simple-bulge removal + condense to fixpoint (reference
    asm_resolve_simple_bulges_ite basic_resolve.c:1700-1741).

    Above the fixpoint loop's vectorization threshold the array-graph twin
    runs instead (resolve/vectorized.resolve_simple_bulges — same
    candidate order, memo, and DFS, no per-edge python objects); this
    MutableGraph form is the oracle, equivalence-tested in
    tests/test_vectorized_resolve.py."""
    from .driver import VEC_MIN_EDGES
    if g.n_e >= VEC_MIN_EDGES:
        from .vectorized import resolve_simple_bulges
        return resolve_simple_bulges(g)
    memo: Dict = {}
    node_map = list(range(g.n_v))
    while True:
        mg = MutableGraph.from_asm(g)
        resolved = _resolve_simple_bulges_once(mg, memo, node_map)
        if not resolved:
            return g
        g2, new_to_old = asm_condense(mg.to_asm(), return_map=True)
        node_map = [node_map[old] for old in new_to_old]
        g = g2


# ---------------------------------------------------------------------------
# complex bulges
# ---------------------------------------------------------------------------

def _in_edges(g: MutableGraph, v: int):
    """(edge, parent) pairs of in-edges via rc adjacency."""
    v_rc = g.node_rc[v]
    out = []
    for e_rc in g.node_adj[v_rc]:
        e = g.edges[e_rc].rc_id
        out.append((e, g.edges[e].source))
    return out


def _get_dominated(g: MutableGraph, s: int):
    """BFS dominated set (reference get_dominated_vertices
    complex_resolve.c:66-107)."""
    s_parents = {p for _, p in _in_edges(g, s)}
    dom: Set[int] = set()
    deg_in: Dict[int, int] = {}
    q = deque([s])
    while q:
        v = q.popleft()
        dom.add(v)
        for e in g.node_adj[v]:
            u = g.edges[e].target
            deg_in[u] = deg_in.get(u, 0) + 1
            u_rc = g.node_rc[u]
            if deg_in[u] == g.deg(u_rc) and u not in s_parents:
                q.append(u)
    return dom


def _get_distance_order(g: MutableGraph, s: int, dom: Set[int]):
    """BFS pop order within dom (reference get_distance :233-263)."""
    L = {s: 0}
    order = []
    q = deque([s])
    while q:
        v = q.popleft()
        order.append(v)
        for e in g.node_adj[v]:
            u = g.edges[e].target
            if u not in dom:
                continue
            if u not in L:
                L[u] = L[v] + 1
                q.append(u)
    return order


def _closure(g: MutableGraph, B: Set[int], B_list: List[int], dom: Set[int]) -> bool:
    """Expand B to closure (reference get_closure :148-199); False if a
    successor escapes dom."""
    in_queue: Set[int] = set()
    q = deque()
    for v in list(B_list):
        if any(g.edges[e].target in B for e in g.node_adj[v]):
            in_queue.add(v)
            q.append(v)

    def add_dfs(v0: int):
        stack = [(v0, 0)]
        while stack:
            v, depth = stack.pop()
            int_vertex = depth > 0 or any(
                g.edges[e].target in B for e in g.node_adj[v])
            if int_vertex and v not in in_queue:
                in_queue.add(v)
                q.append(v)
            if v in B:
                continue
            B.add(v)
            B_list.append(v)
            for _, p in _in_edges(g, v):
                stack.append((p, depth + 1))

    while q:
        v = q.popleft()
        for e in g.node_adj[v]:
            u = g.edges[e].target
            if u not in dom:
                return False
            if u in B:
                continue
            add_dfs(u)
    return True


def _is_complex_closure(g: MutableGraph, s: int, B: Set[int], B_list) -> bool:
    for e in g.node_adj[s]:
        if g.edges[e].target == s:
            return True
    longest = 0
    for v in B_list:
        if g.node_rc[v] in B:
            return True
        for e in g.node_adj[v]:
            if g.edges[e].target in B:
                longest = max(longest, g.edges[e].seq_len)
    return longest >= 1000


def _is_closure_tree(g: MutableGraph, B: Set[int], B_list) -> bool:
    for v in B_list:
        c = sum(1 for _, p in _in_edges(g, v) if p in B)
        if c > 1:
            return False
    return True


def _bfs_to_sinks(g: MutableGraph, s: int, B: Set[int]):
    PE = {s: -1}
    q = deque([s])
    visited = {s}
    while q:
        v = q.popleft()
        for e in g.node_adj[v]:
            u = g.edges[e].target
            if u not in B:
                continue
            if u not in visited:
                visited.add(u)
                PE[u] = e
                q.append(u)
    return PE


def _supress_bulge(g: MutableGraph, s: int, B: Set[int], B_list, PE) -> None:
    mark = {s}
    for v in B_list:
        if any(g.edges[e].target in B for e in g.node_adj[v]):
            continue  # not a sink
        w = v
        while w not in mark:
            mark.add(w)
            e = PE.get(w, -2)
            if e < 0:
                break
            w = g.edges[e].source
    rm = set()
    for v in B_list:
        for e in list(g.node_adj[v]):
            u = g.edges[e].target
            rc = g.edges[e].rc_id
            if u not in B:
                continue
            if v not in mark or u not in mark or \
                    (PE.get(u, -2) != e and PE.get(u, -2) != rc):
                rm.add(e)
                rm.add(rc)
    for e in rm:
        g.remove_edge(e)


def _resolve_bulges_once(g: MutableGraph) -> int:
    res = 0
    for s in range(g.n_v):
        dom = _get_dominated(g, s)
        order = _get_distance_order(g, s, dom)
        B = {s}
        B_list = [s]
        ci = 1  # order[0] == s, already in B
        while True:
            nxt = -1
            while ci < len(order):
                cand = order[ci]
                ci += 1
                if cand not in B:
                    nxt = cand
                    break
            if nxt == -1:
                break
            B.add(nxt)
            B_list.append(nxt)
            if not _closure(g, B, B_list, dom):
                break
            if _is_complex_closure(g, s, B, B_list):
                break
            if _is_closure_tree(g, B, B_list):
                continue
            PE = _bfs_to_sinks(g, s, B)
            _supress_bulge(g, s, B, B_list, PE)
            res += 1
            break
    return res


def resolve_complex_bulges_ite(g: AsmGraph) -> AsmGraph:
    """Iterate complex-bulge suppression + condense (reference
    asm_resolve_complex_bulges_ite complex_resolve.c:449-470).

    Above the fixpoint loop's vectorization threshold the array-graph twin
    runs instead (resolve/vectorized.resolve_complex_bulges — same
    per-source algorithm on CSR arrays behind an exact candidate-source
    prefilter); this MutableGraph form is the oracle, equivalence-tested
    in tests/test_vectorized_resolve.py."""
    from .driver import VEC_MIN_EDGES
    if g.n_e >= VEC_MIN_EDGES:
        from .vectorized import resolve_complex_bulges
        return resolve_complex_bulges(g)
    while True:
        mg = MutableGraph.from_asm(g)
        resolved = _resolve_bulges_once(mg)
        if not resolved:
            return g
        g = asm_condense(mg.to_asm())
