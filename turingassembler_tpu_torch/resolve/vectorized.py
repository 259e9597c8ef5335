"""Vectorized simplification passes over the struct-of-arrays graph.

The per-node Python passes in resolve/basic.py are faithful oracles but
iterate edges one at a time — fine at the bacterial scale (n_e ~ 1e3),
quadratic pain at metagenome scale.  These implementations compute each
pass predicate on a snapshot of the whole graph with numpy segment
reductions (mask -> tombstone -> condense, SURVEY.md §7.5), iterating
snapshots to an in-pass fixpoint so cascades (a removed tip exposing
another) are still taken.

Semantics mirror the same reference passes:
  remove_tips            src/basic_resolve.c:641-696
  remove_tips_topo       src/basic_resolve.c:541-639
  remove_chimeric        src/basic_resolve.c:713-742
  resolve_simple_bubble  src/basic_resolve.c:980-1012
and the thresholds come from the same config block.  The fixpoint loop uses
these as a pre-pass on large graphs and keeps resolve/basic.py as the
oracle (equivalence-tested in tests/test_vectorized_resolve.py).
"""

from __future__ import annotations

import numpy as np

from ..graph.structs import AsmGraph
from .basic import (
    CHIMERIC_LEN_THRES,
    CHIMERIC_RATIO_THRES,
    MIN_NOTICE_LEN,
    MIN_TIPS_LEG,
    TIPS_COV_THRES,
    TIPS_HARD_THRESHOLD,
    TIPS_LEN_THRES,
    TIPS_RATIO_THRES,
)


def _segmax(values: np.ndarray, seg: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, values.dtype)
    np.maximum.at(out, seg, values)
    return out


def _remove_pairs(g: AsmGraph, rm: np.ndarray) -> int:
    """Tombstone edges and their rcs; return the number of removed
    PAIRS — the python oracles count one per remove_edge_pair (the rc
    is skipped as already-dead when the loop reaches it)."""
    removed = np.zeros(g.n_e, bool)
    removed[rm] = True
    removed[g.edge_rc[rm]] = True
    ids = np.flatnonzero(removed)
    g.edge_source[ids] = -1
    return (len(ids) + 1) // 2


def _node_views(g: AsmGraph):
    """(alive edge ids, per-edge arrays, per-node out-degree)."""
    alive = g.alive_mask()
    eids = np.flatnonzero(alive)
    src = g.edge_source[eids].astype(np.int64)
    tgt = g.edge_target[eids].astype(np.int64)
    cov = g.edge_cov()[eids]
    lens = g.edge_len()[eids].astype(np.int64)
    deg = np.bincount(src, minlength=g.n_v).astype(np.int64)
    return eids, src, tgt, cov, lens, deg


def remove_tips(g: AsmGraph) -> int:
    """Snapshot remove_tips iterated to fixpoint.  Tombstones in place."""
    rc_node = g.node_rc.astype(np.int64)
    total = 0
    while True:
        eids, src, tgt, cov, lens, deg = _node_views(g)
        if len(eids) == 0:
            break
        covmax = _segmax(cov, src, g.n_v)
        lenmax = _segmax(lens, src, g.n_v)
        # extend flag per node: any out-edge with live target or long leg
        ext_e = (deg[tgt] != 0) | (lens >= MIN_TIPS_LEG)
        ext = np.zeros(g.n_v, bool)
        np.logical_or.at(ext, src, ext_e)

        max_cov = np.maximum(covmax[src], covmax[rc_node[src]])
        extend_l = ext[src]
        extend_r = ext[rc_node[src]]
        len_fw = lenmax[src]
        len_rv = lenmax[rc_node[src]]
        is_tip = (deg[tgt] == 0) & (cov < max_cov) & (
            ((lens < TIPS_LEN_THRES) & extend_l & extend_r
             & (cov < TIPS_HARD_THRESHOLD))
            | ((cov < TIPS_COV_THRES) & (cov < max_cov * TIPS_RATIO_THRES))
            | ((len_fw >= MIN_TIPS_LEG) & (len_rv >= MIN_TIPS_LEG)
               & (cov < max_cov * TIPS_RATIO_THRES)))
        rm = eids[is_tip]
        if len(rm) == 0:
            break
        total += _remove_pairs(g, rm)
    return total


def _topo_longest(g: AsmGraph, max_len: int = 1000):
    """Longest acyclic path to a sink per node, capped (reference
    find_topo, src/basic_resolve.c:541-575).  Kahn order on arrays;
    degs[v] > 0 afterwards marks nodes on cycles (never drained)."""
    n_v = g.n_v
    rc = g.node_rc.astype(np.int64)
    alive = g.alive_mask()
    eids = np.flatnonzero(alive)
    src = g.edge_source[eids].astype(np.int64)
    tgt = g.edge_target[eids].astype(np.int64)
    lens = g.edge_len()[eids].astype(np.int64)
    degs = np.bincount(src, minlength=n_v).astype(np.int64)
    d = np.zeros(n_v, np.int64)
    # CSR by source so node_adj[u_rc] is bucket u_rc
    order = np.argsort(src, kind="stable")
    by_tgt = tgt[order]
    by_len = lens[order]
    boff = np.concatenate([[0], np.cumsum(
        np.bincount(src, minlength=n_v))]).astype(np.int64)
    queue = list(np.flatnonzero(degs == 0))
    qi = 0
    ksize = g.ksize
    while qi < len(queue):
        u = int(queue[qi]); qi += 1
        u_rc = int(rc[u])
        for j in range(boff[u_rc], boff[u_rc + 1]):
            v = int(rc[by_tgt[j]])
            degs[v] -= 1
            cand = d[u] + int(by_len[j]) - ksize
            if cand > d[v]:
                d[v] = cand
            if d[v] > max_len:
                d[v] = max_len
            if degs[v] == 0:
                queue.append(v)
    return d, degs


def remove_tips_topo(g: AsmGraph, max_len: int = 1000) -> int:
    """Snapshot remove_tips_topo, same predicate as the Python oracle
    (basic.remove_tips_topo; reference src/basic_resolve.c:577-639)."""
    rc_node = g.node_rc.astype(np.int64)
    total = 0
    while True:
        d, degs_cyc = _topo_longest(g, max_len)
        eids, src, tgt, cov, lens, deg = _node_views(g)
        if len(eids) == 0:
            break
        covmax = _segmax(cov, src, g.n_v)
        lenmax = _segmax(lens, src, g.n_v)
        # extend flag: any out-edge continuing (cycle node or reaching
        # MIN_TIPS_LEG through its target's longest path)
        ext_e = (degs_cyc[tgt] != 0) | (d[tgt] + lens - g.ksize
                                        >= MIN_TIPS_LEG)
        ext = np.zeros(g.n_v, bool)
        np.logical_or.at(ext, src, ext_e)

        cov_fw = covmax[src]
        max_cov = np.maximum(cov_fw, covmax[rc_node[src]])
        extend_l = ext[src]
        extend_r = ext[rc_node[src]]
        len_fw = lenmax[src]
        len_rv = lenmax[rc_node[src]]
        my_reach = d[tgt] + lens - g.ksize
        is_tip = ((degs_cyc[tgt] == 0) & (cov < max_cov)
                  & (d[tgt] < TIPS_LEN_THRES) & (
            ((my_reach < TIPS_LEN_THRES)
             & ((extend_l & extend_r & (cov < TIPS_HARD_THRESHOLD))
                | (cov < cov_fw)))
            | ((cov < TIPS_COV_THRES) & (cov < max_cov * TIPS_RATIO_THRES))
            | ((len_fw >= MIN_TIPS_LEG) & (len_rv >= MIN_TIPS_LEG)
               & (cov < max_cov * TIPS_RATIO_THRES)
               & (cov < TIPS_COV_THRES))))
        rm = eids[is_tip]
        if len(rm) == 0:
            break
        total += _remove_pairs(g, rm)
    return total


def remove_chimeric(g: AsmGraph) -> int:
    rc_node = g.node_rc.astype(np.int64)
    total = 0
    while True:
        eids, src, tgt, cov, lens, deg = _node_views(g)
        if len(eids) == 0:
            break
        covmax = _segmax(cov, src, g.n_v)
        cov_fw = np.minimum(covmax[src], covmax[rc_node[src]])
        cov_rv = np.minimum(covmax[tgt], covmax[rc_node[tgt]])
        is_chim = (((cov < CHIMERIC_RATIO_THRES * cov_fw)
                    | (cov < CHIMERIC_RATIO_THRES * cov_rv))
                   & (lens < CHIMERIC_LEN_THRES) & (cov < 15))
        rm = eids[is_chim]
        if len(rm) == 0:
            break
        total += _remove_pairs(g, rm)
    return total


def resolve_simple_bubble(g: AsmGraph) -> int:
    """Parallel short edges between the same node pair: keep the longest
    (first max in edge-id order), sum counts onto it and its rc
    (reference bubble_keep_longest, src/basic_resolve.c:901-1012)."""
    rc_node = g.node_rc.astype(np.int64)
    alive = g.alive_mask()
    lens_all = g.edge_len()
    cand = (alive & (lens_all < MIN_NOTICE_LEN)
            & (g.edge_source != rc_node[np.clip(g.edge_target, 0,
                                                g.n_v - 1)]))
    eids = np.flatnonzero(cand)
    if len(eids) < 2:
        return 0
    key = g.edge_source[eids] * np.int64(g.n_v) + g.edge_target[eids]
    order = np.argsort(key, kind="stable")   # stable: ids ascend in group
    ek, kk = eids[order], key[order]
    starts = np.flatnonzero(np.concatenate([[True], kk[1:] != kk[:-1]]))
    ends = np.append(starts[1:], len(ek))
    groups = [(int(ek[s]), ek[s:e]) for s, e in zip(starts, ends)
              if e - s >= 2]
    # process in ascending min-edge-id order — the order the sequential
    # edge loop would first touch each bubble (rc groups interleave)
    groups.sort(key=lambda t: t[0])
    cnt = 0
    for _, grp in groups:
        branch = [int(e) for e in grp if g.edge_source[e] >= 0]
        if len(branch) < 2:
            continue
        blens = lens_all[branch]
        kept = branch[int(np.argmax(blens))]
        total = int(g.edge_count[branch].sum())
        for e in branch:
            if e != kept:
                g.edge_source[e] = -1
                g.edge_source[g.edge_rc[e]] = -1
        g.edge_count[kept] = total
        g.edge_count[g.edge_rc[kept]] = total
        cnt += len(branch) - 1
    return cnt


# ---------------------------------------------------------------------------
# simple bulges without python-object graphs (VERDICT r2 #7)
# ---------------------------------------------------------------------------

def _csr(g: AsmGraph):
    """CSR adjacency (by source) over ALL edges; callers mask dead ones.
    Within-source order is ascending edge id — the same order
    MutableGraph.node_adj iterates."""
    src = g.edge_source.astype(np.int64)
    live = src >= 0
    eids = np.flatnonzero(live)
    order = np.argsort(src[eids], kind="stable")
    adj_e = eids[order]
    boff = np.concatenate([[0], np.cumsum(
        np.bincount(src[eids], minlength=g.n_v))]).astype(np.int64)
    return adj_e, boff


def _alt_path_exists(adj_e, boff, tgt, lens, dead, ksize: int,
                     u: int, v: int, avoid_e: int, length: int,
                     max_visited: int = 100000) -> bool:
    """find_alternative_path_dfs on CSR arrays (reference
    src/basic_resolve.c:1607-1631): simple path u->v avoiding avoid_e
    with total length in [0.8, 1.2]*length, starting at ksize."""
    minl = 0.8 * length
    maxl = 1.2 * length
    if u == v and ksize >= minl:
        return True
    visited = {u}
    stack = [(u, ksize, int(boff[u]))]
    total = 0
    while stack:
        node, cur_len, j = stack[-1]
        if total > max_visited:
            return False
        advanced = False
        while j < boff[node + 1]:
            e = int(adj_e[j])
            j += 1
            if e == avoid_e or dead[e]:
                continue
            nxt = int(tgt[e])
            nlen = cur_len + int(lens[e]) - ksize
            if nlen > maxl:
                continue
            if nxt == v and nlen >= minl:
                return True
            if nxt in visited or nxt == v:
                continue
            total += 1
            visited.add(nxt)
            stack[-1] = (node, cur_len, j)
            stack.append((nxt, nlen, int(boff[nxt])))
            advanced = True
            break
        if not advanced:
            stack.pop()
            visited.discard(node)
    return False


def _simple_bulges_round(g: AsmGraph, memo, node_map) -> int:
    """One in-place bulge round over the array graph — same candidate
    order, memoization, and DFS semantics as the MutableGraph oracle
    (resolve/bulges._resolve_simple_bulges_once; reference
    src/basic_resolve.c:1633-1698)."""
    from .bulges import MAX_BULGE_LEN, MAX_ALT_RATIO, MIN_ALT_RATIO
    adj_e, boff = _csr(g)
    src = g.edge_source
    tgt = g.edge_target
    rc = g.edge_rc
    lens = g.edge_len()
    rc_node = g.node_rc
    dead = src < 0
    cand = (~dead & (lens <= MAX_BULGE_LEN)
            & (np.arange(g.n_e) <= rc)
            & (src != rc_node[np.clip(tgt, 0, g.n_v - 1)]))
    res = 0
    for e in np.flatnonzero(cand):
        e = int(e)
        if dead[e]:
            continue
        u, v = int(src[e]), int(tgt[e])
        L = int(lens[e])
        code = (int(node_map[u]), int(node_map[v]))
        mlens = memo.setdefault(code, [])
        if any(MIN_ALT_RATIO * L <= x <= MAX_ALT_RATIO * L for x in mlens):
            continue
        if _alt_path_exists(adj_e, boff, tgt, lens, dead, g.ksize,
                            u, v, e, L):
            dead[e] = dead[int(rc[e])] = True
            g.edge_source[e] = -1
            g.edge_source[int(rc[e])] = -1
            res += 1
        else:
            mlens.append(L)
    return res


def resolve_simple_bulges(g: AsmGraph) -> AsmGraph:
    """Array-graph twin of bulges.resolve_simple_bulges_ite: bulge round
    -> condense (node-map carried for the memo) to fixpoint.  No
    MutableGraph conversion, so metagenome-scale graphs skip the
    per-edge python-object build entirely."""
    from ..graph.condense import asm_condense
    memo: dict = {}
    node_map = np.arange(g.n_v, dtype=np.int64)
    g = g.clone()
    while True:
        resolved = _simple_bulges_round(g, memo, node_map)
        if not resolved:
            return g
        g, new_to_old = asm_condense(g, return_map=True)
        node_map = node_map[np.asarray(new_to_old, np.int64)]


# ---------------------------------------------------------------------------
# complex bulges without python-object graphs (VERDICT r3 #6)
# ---------------------------------------------------------------------------

def _bulge_candidate_sources(g: AsmGraph) -> np.ndarray:
    """Sources whose dominated set can grow past {s} — the only sources
    the per-source pass (reference get_dominated_vertices,
    src/complex_resolve.c:66-107) can mutate anything from.

    dom(s) grows iff some successor u of s has ALL of its in-edges
    coming from s (multi-edges counted) and u is not a parent of s; a
    source failing that provably breaks out of the bulge loop with no
    removal (order == [s]), so skipping it is exact.  Computed for all
    sources at once with one sorted (src, tgt) pair count."""
    src = g.edge_source.astype(np.int64)
    live = src >= 0
    eids = np.flatnonzero(live)
    if len(eids) == 0:
        return np.zeros(0, np.int64)
    s = src[eids]
    t = g.edge_target[eids].astype(np.int64)
    indeg = np.bincount(t, minlength=g.n_v).astype(np.int64)
    key = s * np.int64(g.n_v) + t
    uk, cnt = np.unique(key, return_counts=True)
    us, ut = uk // g.n_v, uk % g.n_v
    full = (cnt == indeg[ut]) & (us != ut)
    if not full.any():
        return np.zeros(0, np.int64)
    # u must not be a parent of s: edge u->s must not exist
    back = ut[full] * np.int64(g.n_v) + us[full]
    has_back = np.isin(back, uk, assume_unique=False)
    return np.unique(us[full][~has_back])


class _CsrView:
    """Frozen CSR snapshot of an array graph plus a dead-edge mask the
    bulge pass tombstones into (adjacency is rebuilt lazily only after
    a resolution — removals are rare)."""

    def __init__(self, g: AsmGraph):
        self.g = g
        self.tgt = g.edge_target.astype(np.int64)
        self.srcv = g.edge_source.astype(np.int64)
        self.rc = g.edge_rc.astype(np.int64)
        self.rc_node = g.node_rc.astype(np.int64)
        self.lens = g.edge_len().astype(np.int64)
        self.adj_e, self.boff = _csr(g)
        self.dead = g.edge_source < 0

    def adj(self, v: int):
        """Live out-edge ids of v, ascending (MutableGraph order)."""
        for j in range(self.boff[v], self.boff[v + 1]):
            e = int(self.adj_e[j])
            if not self.dead[e]:
                yield e

    def deg(self, v: int) -> int:
        d = 0
        for j in range(self.boff[v], self.boff[v + 1]):
            if not self.dead[self.adj_e[j]]:
                d += 1
        return d

    def in_edges(self, v: int):
        """(edge, parent) of live in-edges via rc adjacency."""
        for e_rc in self.adj(int(self.rc_node[v])):
            e = int(self.rc[e_rc])
            yield e, int(self.srcv[e])

    def remove_edge(self, e: int):
        self.dead[e] = True
        self.g.edge_source[e] = -1


def _try_resolve_bulge_at(cv: _CsrView, s: int) -> bool:
    """The full per-source bulge algorithm of the MutableGraph oracle
    (resolve/bulges._resolve_bulges_once body; reference
    src/complex_resolve.c:264-447) on the CSR view.  Returns True when
    a bulge was suppressed (edges tombstoned in place)."""
    from collections import deque

    # get_dominated_vertices (complex_resolve.c:66-107)
    s_parents = {p for _, p in cv.in_edges(s)}
    dom = set()
    deg_in = {}
    q = deque([s])
    while q:
        v = q.popleft()
        dom.add(v)
        for e in cv.adj(v):
            u = int(cv.tgt[e])
            deg_in[u] = deg_in.get(u, 0) + 1
            if deg_in[u] == cv.deg(int(cv.rc_node[u])) and u not in s_parents:
                q.append(u)

    # get_distance pop order within dom (:233-263)
    L = {s: 0}
    order = []
    q = deque([s])
    while q:
        v = q.popleft()
        order.append(v)
        for e in cv.adj(v):
            u = int(cv.tgt[e])
            if u in dom and u not in L:
                L[u] = L[v] + 1
                q.append(u)

    B = {s}
    B_list = [s]
    ci = 1
    while True:
        nxt = -1
        while ci < len(order):
            cand = order[ci]
            ci += 1
            if cand not in B:
                nxt = cand
                break
        if nxt == -1:
            return False
        B.add(nxt)
        B_list.append(nxt)

        # get_closure (:148-199)
        in_queue = set()
        q = deque()
        escaped = False
        for v in list(B_list):
            if any(int(cv.tgt[e]) in B for e in cv.adj(v)):
                in_queue.add(v)
                q.append(v)

        def add_dfs(v0: int):
            stack = [(v0, 0)]
            while stack:
                v, depth = stack.pop()
                int_vertex = depth > 0 or any(
                    int(cv.tgt[e]) in B for e in cv.adj(v))
                if int_vertex and v not in in_queue:
                    in_queue.add(v)
                    q.append(v)
                if v in B:
                    continue
                B.add(v)
                B_list.append(v)
                for _, p in cv.in_edges(v):
                    stack.append((p, depth + 1))

        while q:
            v = q.popleft()
            for e in cv.adj(v):
                u = int(cv.tgt[e])
                if u not in dom:
                    escaped = True
                    break
                if u not in B:
                    add_dfs(u)
            if escaped:
                break
        if escaped:
            return False

        # is_complex_closure (:201-231)
        complex_cl = any(int(cv.tgt[e]) == s for e in cv.adj(s))
        if not complex_cl:
            longest = 0
            for v in B_list:
                if int(cv.rc_node[v]) in B:
                    complex_cl = True
                    break
                for e in cv.adj(v):
                    if int(cv.tgt[e]) in B:
                        longest = max(longest, int(cv.lens[e]))
            complex_cl = complex_cl or longest >= 1000
        if complex_cl:
            return False

        # is_closure_tree (:109-124)
        tree = True
        for v in B_list:
            c = sum(1 for _, p in cv.in_edges(v) if p in B)
            if c > 1:
                tree = False
                break
        if tree:
            continue

        # bfs_to_sinks + supress_bulge (:266-340)
        PE = {s: -1}
        visited = {s}
        q = deque([s])
        while q:
            v = q.popleft()
            for e in cv.adj(v):
                u = int(cv.tgt[e])
                if u in B and u not in visited:
                    visited.add(u)
                    PE[u] = e
                    q.append(u)
        mark = {s}
        for v in B_list:
            if any(int(cv.tgt[e]) in B for e in cv.adj(v)):
                continue  # not a sink
            w = v
            while w not in mark:
                mark.add(w)
                e = PE.get(w, -2)
                if e < 0:
                    break
                w = int(cv.srcv[e])
        rm = set()
        for v in B_list:
            for e in cv.adj(v):
                u = int(cv.tgt[e])
                rc = int(cv.rc[e])
                if u not in B:
                    continue
                if v not in mark or u not in mark or \
                        (PE.get(u, -2) != e and PE.get(u, -2) != rc):
                    rm.add(e)
                    rm.add(rc)
        for e in rm:
            cv.remove_edge(e)
        return True


def _complex_bulges_round(g: AsmGraph) -> int:
    """One in-place round — same result as the oracle's
    _resolve_bulges_once loop over ALL sources, visiting only sources
    whose dominated set can grow.  The candidate prefilter is recomputed
    after every resolution (a removal can flip later sources' candidacy
    both ways), so the processed graph state at each source matches the
    oracle's sequential mutation order exactly."""
    res = 0
    s_min = 0
    while True:
        cand = _bulge_candidate_sources(g)
        cand = cand[cand >= s_min]
        cv = _CsrView(g)
        advanced = False
        for s in cand:
            if _try_resolve_bulge_at(cv, int(s)):
                res += 1
                s_min = int(s) + 1
                advanced = True
                break
        if not advanced:
            return res


def resolve_complex_bulges(g: AsmGraph) -> AsmGraph:
    """Array-graph twin of bulges.resolve_complex_bulges_ite (reference
    asm_resolve_complex_bulges_ite, src/complex_resolve.c:449-470):
    bulge round -> condense to fixpoint, no MutableGraph conversion."""
    from ..graph.condense import asm_condense
    g = g.clone()
    while True:
        resolved = _complex_bulges_round(g)
        if not resolved:
            return g
        g = asm_condense(g)
