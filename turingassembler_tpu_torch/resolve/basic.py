"""Basic simplification passes, faithful to src/basic_resolve.c.

Pass-by-pass provenance:
  remove_tips          — basic_resolve.c:641-696
  find_topo            — basic_resolve.c:541-575 (longest path to sink, capped)
  remove_tips_topo     — basic_resolve.c:577-639
  remove_chimeric      — basic_resolve.c:713-742
  check_simple_loop    — basic_resolve.c:744-875 (self loop / reverse loop /
                         double loop classification and unrolling)
  check_loop           — basic_resolve.c:1108-1181 (4-edge false loop)
  simple bubble        — basic_resolve.c:980-1012 (keep longest, sum counts)
  align bubble         — basic_resolve.c:929-977 (NW verification, gap -3,
                         +1/-1 match/mismatch; accept if score > 50% len and
                         len - score < 200)
  lazy condense        — basic_resolve.c:72-102 (in-place join of (1,1) nodes)

Thresholds come from config.GraphThresholds (assembly_graph.h:97-135).
The graphs here are post-level-0 and small; these passes run host-side.
The align-bubble DP goes through ops/dp.py to the NW kernel on the
device the caller names.  A copy of turingassembler_tpu/resolve/basic.py
but for that DP call.
"""

from __future__ import annotations

import numpy as np

from ..config import GraphThresholds
from ..graph.mutable import MutableGraph

T = GraphThresholds()

MIN_NOTICE_LEN = T.min_notice_len
TIPS_RATIO_THRES = T.tips_ratio_thres
TIPS_COV_THRES = T.tips_cov_thres
TIPS_LEN_THRES = T.tips_len_thres
MIN_TIPS_LEG = T.min_tips_leg
TIPS_HARD_THRESHOLD = T.tips_hard_threshold
CHIMERIC_RATIO_THRES = T.chimeric_ratio_thres
CHIMERIC_LEN_THRES = T.chimeric_len_thres
MIN_UNROLL_LOOP = T.min_unroll_loop


def remove_tips(g: MutableGraph) -> int:
    cnt = 0
    for u in range(g.n_v):
        u_rc = g.node_rc[u]
        cov_fw = cov_rv = 0.0
        len_fw = len_rv = 0
        extend_left = extend_right = False
        for e in g.node_adj[u]:
            cov = g.edge_cov(e)
            cov_fw = max(cov_fw, cov)
            len_fw = max(len_fw, g.edges[e].seq_len)
            v = g.edges[e].target
            extend_left |= (g.deg(v) != 0 or g.edges[e].seq_len >= MIN_TIPS_LEG)
        for e in g.node_adj[u_rc]:
            cov = g.edge_cov(e)
            cov_rv = max(cov_rv, cov)
            len_rv = max(len_rv, g.edges[e].seq_len)
            v = g.edges[e].target
            extend_right |= (g.deg(v) != 0 or g.edges[e].seq_len >= MIN_TIPS_LEG)
        max_cov = max(cov_fw, cov_rv)
        j = 0
        adj = g.node_adj[u]
        while j < len(adj):
            e = adj[j]
            v = g.edges[e].target
            cov = g.edge_cov(e)
            if g.deg(v) == 0 and cov < max_cov and (
                (g.edges[e].seq_len < TIPS_LEN_THRES and extend_left and extend_right
                 and cov < TIPS_HARD_THRESHOLD)
                or (cov < TIPS_COV_THRES and cov < max_cov * TIPS_RATIO_THRES)
                or (len_fw >= MIN_TIPS_LEG and len_rv >= MIN_TIPS_LEG
                    and cov < max_cov * TIPS_RATIO_THRES)
            ):
                g.remove_edge_pair(e)
                cnt += 1
                # removal swaps in place; re-examine index j
            else:
                j += 1
    return cnt


def find_topo(g: MutableGraph, max_len: int = 1000):
    """Longest acyclic path length from each node to a sink, capped.
    Returns (d, degs): degs[v] > 0 marks nodes on cycles (never drained)."""
    n_v = g.n_v
    d = [0] * n_v
    degs = [g.deg(u) for u in range(n_v)]
    ksize = g.ksize
    queue = [u for u in range(n_v) if degs[u] == 0]
    qi = 0
    while qi < len(queue):
        u = queue[qi]; qi += 1
        u_rc = g.node_rc[u]
        for e in g.node_adj[u_rc]:
            v_rc = g.edges[e].target
            v = g.node_rc[v_rc]
            degs[v] -= 1
            cand = d[u] + g.edges[e].seq_len - ksize
            if cand > d[v]:
                d[v] = cand
            if d[v] > max_len:
                d[v] = max_len
            if degs[v] == 0:
                queue.append(v)
    return d, degs


def remove_tips_topo(g: MutableGraph) -> int:
    d, degs = find_topo(g, 1000)
    cnt = 0
    for u in range(g.n_v):
        u_rc = g.node_rc[u]
        cov_fw = cov_rv = 0.0
        len_fw = len_rv = 0
        extend_left = extend_right = False
        for e in g.node_adj[u]:
            cov = g.edge_cov(e)
            cov_fw = max(cov_fw, cov)
            len_fw = max(len_fw, g.edges[e].seq_len)
            v = g.edges[e].target
            extend_left |= (degs[v] != 0 or
                            d[v] + g.edges[e].seq_len - g.ksize >= MIN_TIPS_LEG)
        for e in g.node_adj[u_rc]:
            cov = g.edge_cov(e)
            cov_rv = max(cov_rv, cov)
            len_rv = max(len_rv, g.edges[e].seq_len)
            v = g.edges[e].target
            extend_right |= (degs[v] != 0 or
                             d[v] + g.edges[e].seq_len - g.ksize >= MIN_TIPS_LEG)
        max_cov = max(cov_fw, cov_rv)
        j = 0
        adj = g.node_adj[u]
        while j < len(adj):
            e = adj[j]
            v = g.edges[e].target
            cov = g.edge_cov(e)
            if (degs[v] == 0 and cov < max_cov and d[v] < TIPS_LEN_THRES and
                ((d[v] + g.edges[e].seq_len - g.ksize < TIPS_LEN_THRES and
                  ((extend_left and extend_right and cov < 30) or cov < cov_fw))
                 or (cov < TIPS_COV_THRES and cov < max_cov * TIPS_RATIO_THRES)
                 or (len_fw >= MIN_TIPS_LEG and len_rv >= MIN_TIPS_LEG
                     and cov < max_cov * TIPS_RATIO_THRES and cov < TIPS_COV_THRES))):
                g.remove_edge_pair(e)
                cnt += 1
            else:
                j += 1
    return cnt


def _max_out_cov(g: MutableGraph, u: int) -> float:
    cur = 0.0
    for e in g.node_adj[u]:
        if g.edges[e].source == -1:
            continue
        cur = max(cur, g.edge_cov(e))
    return cur


def remove_chimeric(g: MutableGraph) -> int:
    cnt = 0
    for e in range(g.n_e):
        ed = g.edges[e]
        if ed.source == -1:
            continue
        u, v = ed.source, ed.target
        u_rc, v_rc = g.node_rc[u], g.node_rc[v]
        cov = g.edge_cov(e)
        cov_fw = min(_max_out_cov(g, u), _max_out_cov(g, u_rc))
        cov_rv = min(_max_out_cov(g, v), _max_out_cov(g, v_rc))
        if ((cov < CHIMERIC_RATIO_THRES * cov_fw or cov < CHIMERIC_RATIO_THRES * cov_rv)
                and ed.seq_len < CHIMERIC_LEN_THRES and cov < 15):
            g.remove_edge_pair(e)
            cnt += 1
    return cnt


def _convert_cov_range(fcov: float):
    """reference convert_cov_range (src/assembly_graph.h:205-214)."""
    eps = 1e-6
    icov = int(fcov)
    if fcov + eps < icov + 0.25:
        return icov, icov
    elif fcov + eps > icov + 0.25 and fcov + eps < icov + 0.75:
        return icov, icov + 1
    return icov + 1, icov + 1


def check_simple_loop(g: MutableGraph, e: int) -> int:
    """0 none, 1 self-loop, 2 self-loop-reverse, 3 double-loop,
    -1 false loop removed (reference basic_resolve.c:744-875)."""
    if g.edges[e].seq_len >= MIN_NOTICE_LEN:
        return 0
    e_rc = g.edges[e].rc_id
    u, v = g.edges[e].source, g.edges[e].target
    u_rc, v_rc = g.node_rc[u], g.node_rc[v]
    cov = g.edge_cov(e)
    if u == v:  # self loop
        sum_cov, n_edges = 0.0, 0
        found = False
        for ee in g.node_adj[u_rc]:
            if ee != e_rc:
                sum_cov += g.edge_cov(g.edges[ee].rc_id)
                n_edges += 1
                found = True
        for ee in g.node_adj[u]:
            if ee != e:
                sum_cov += g.edge_cov(ee)
                n_edges += 1
                found = True
        if not found:
            return 0
        if cov < sum_cov / n_edges * 0.5:
            g.remove_edge_pair(e)
            return -1
        if g.deg(u_rc) > 2 or g.deg(u) > 2:
            return 0
        # split node: detach the loop from the through-path
        nv = g.create_node()
        nv_rc = g.node_rc[nv]
        g.edges[e].target = nv
        g.node_adj[u_rc].remove(e_rc)
        g.edges[e_rc].source = nv_rc
        g.node_adj[nv_rc].append(e_rc)
        g.node_adj[nv] = [x for x in g.node_adj[u] if x != e]
        g.node_adj[u] = [e]
        for e_t in g.node_adj[nv]:
            g.edges[e_t].source = nv
            g.edges[g.edges[e_t].rc_id].target = nv_rc
        return 1
    elif u == v_rc:  # self loop reverse (hairpin)
        sum_cov, n_edges = 0.0, 0
        for ee in g.node_adj[u_rc]:
            sum_cov += g.edge_cov(ee)
            n_edges += 1
        for ee in g.node_adj[u]:
            if ee != e and ee != e_rc:
                sum_cov += g.edge_cov(ee)
                n_edges += 1
        if n_edges and cov < sum_cov / n_edges * 0.5:
            g.remove_edge_pair(e)
            return -1
        return 0
    else:
        if (g.deg(u) != 1 or g.deg(v_rc) != 1 or
                g.deg(u_rc) > 2 or g.deg(v) > 2):
            return 0
        e1 = e2 = e_return = e_return_rc = -1
        for ee in g.node_adj[v]:
            if g.edges[ee].target == u:
                e_return = ee
            else:
                e2 = ee
        for ee in g.node_adj[u_rc]:
            if g.edges[ee].target == v_rc:
                e_return_rc = ee
            else:
                e1 = g.edges[ee].rc_id
        if e_return == -1 or e_return_rc == -1:
            return 0
        if g.edges[e_return].seq_len >= MIN_UNROLL_LOOP:
            return 0
        if e1 == -1 and e2 == -1:
            return 0
        if e1 == -1:
            mean_cov = g.edge_cov(e2)
        elif e2 == -1:
            mean_cov = g.edge_cov(e1)
        else:
            mean_cov = (g.edge_cov(e1) + g.edge_cov(e2)) / 2
        if mean_cov <= 0:
            return 0
        rcov_e = _convert_cov_range(cov / mean_cov)
        rcov_ret = _convert_cov_range(g.edge_cov(e_return) / mean_cov)
        rep = min(rcov_e[0] - 1, rcov_ret[0])
        if rep <= 0:
            rep = 1
        g.unroll_loop_forward(e, e_return, rep)
        g.unroll_loop_forward(e_rc, e_return_rc, rep)
        g.remove_edge_pair(e_return)
        return 3


def unroll_simple_loop(g: MutableGraph) -> int:
    cnt = 0
    for e in range(g.n_e):
        if g.edges[e].source == -1:
            continue
        if check_simple_loop(g, e) != 0:
            cnt += 1
    return cnt


def check_loop(g: MutableGraph, i_e2: int) -> int:
    """4-edge false-loop removal (reference basic_resolve.c:1108-1181)."""
    e2 = g.edges[i_e2]
    i_a, i_b = e2.source, e2.target
    i_a_rc, i_b_rc = g.node_rc[i_a], g.node_rc[i_b]
    if g.deg(i_a) != 1 or g.deg(i_b) != 1:
        return 0
    if g.deg(i_a_rc) != 2 or g.deg(i_b_rc) != 2:
        return 0
    b1 = False
    i_e4 = None
    for ee in g.node_adj[i_a_rc]:
        if g.edges[ee].target == i_b:
            b1 = True
    if not b1:
        return 0
    for ee in g.node_adj[i_b_rc]:
        if g.edges[ee].target == i_a:
            i_e4 = ee
        elif g.edges[ee].target != i_a_rc:
            return 0
    if i_e4 is None:
        return 0
    cov_e2 = g.edge_cov(i_e2)
    cov_e4 = g.edge_cov(i_e4)
    if cov_e2 < cov_e4:
        return 0
    if g.edges[i_e4].seq_len > 200:
        return 0
    g.remove_edge_pair(i_e4)
    return 1


def resolve_loop(g: MutableGraph) -> int:
    cnt = 0
    for e in range(g.n_e):
        if g.edges[e].source != -1:
            cnt += check_loop(g, e)
    return cnt


def _bubble_keep_longest(g: MutableGraph, branch) -> int:
    e_kept, max_len, sum_cnt = -1, 0, 0
    for e in branch:
        if g.edges[e].seq_len > max_len:
            max_len = g.edges[e].seq_len
            e_kept = e
        sum_cnt += g.edges[e].count
    for e in branch:
        if e != e_kept:
            g.remove_edge_pair(e)
    g.edges[e_kept].count = sum_cnt
    g.edges[g.edges[e_kept].rc_id].count = sum_cnt
    return len(branch) - 1


def nw_align_scores_batch(pairs, device="cuda") -> np.ndarray:
    """Batched bubble NW (reference basic_resolve.c:929-953: gap -3,
    match +1, mismatch -1) through the port's single DP entry
    (ops/dp.py; linear gap = affine with go=0, ge=3) on `device`.

    pairs: list of (s1, s2) uint8 code arrays.  Returns (len(pairs),)
    int scores.  The pairs are padded to the batch's longest sequence
    and scored in one launch, full width (the JAX package pads to a
    power of two and names a band; its DP is full width all the same, so
    the scores are equal).  A pair whose lengths differ by 128 or more
    loses at least 3 * 128 to gaps, and _bubble_accept refuses it: it
    allows a deficit under 200."""
    from ..ops import dp
    if not pairs:
        return np.zeros(0, np.int32)
    L = max(max(len(a), len(b)) for a, b in pairs)
    B = len(pairs)
    q = np.full((B, L), 255, np.uint8)
    t = np.full((B, L), 255, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for i, (a, b) in enumerate(pairs):
        q[i, : len(a)] = a
        t[i, : len(b)] = b
        qlen[i], tlen[i] = len(a), len(b)
    return dp.affine_scores(q, qlen, t, tlen, dp.SCORING_BUBBLE,
                            mode="global", device=device)


def _bubble_accept(score: int, len1: int, len2: int) -> bool:
    mx = max(len1, len2)
    return score * 100 > 50 * mx and mx - score < MIN_NOTICE_LEN * 2


def check_simple_bubble(g: MutableGraph, se: int) -> int:
    u, v = g.edges[se].source, g.edges[se].target
    if u == g.node_rc[v]:
        return 0
    branch = [e for e in g.node_adj[u]
              if g.edges[e].target == v and g.edges[e].seq_len < MIN_NOTICE_LEN]
    if len(branch) < 2:
        return 0
    return _bubble_keep_longest(g, branch)


def _align_bubble_candidates(g: MutableGraph, se: int):
    """Candidate partner edges of se for the align-bubble check
    (same endpoints, both < 1000 bp; reference basic_resolve.c:955-977)."""
    u, v = g.edges[se].source, g.edges[se].target
    if u == g.node_rc[v] or g.edges[se].seq_len >= 1000:
        return []
    return [e for e in g.node_adj[u]
            if g.edges[e].seq_len < 1000 and g.edges[e].target == v
            and e != se]


def check_align_bubble(g: MutableGraph, se: int,
                       accepted=None, device="cuda") -> int:
    """accepted: optional precomputed {(se, e): bool} from the batched
    DP pass; when None the pairs are scored on the spot."""
    cand = _align_bubble_candidates(g, se)
    if accepted is None:
        scores = nw_align_scores_batch(
            [(g.edges[se].seq, g.edges[e].seq) for e in cand], device)
        accepted = {
            (se, e): _bubble_accept(int(s), g.edges[se].seq_len,
                                    g.edges[e].seq_len)
            for e, s in zip(cand, scores)}
    branch = [se] + [e for e in cand if accepted.get((se, e), False)]
    if len(branch) < 2:
        return 0
    _bubble_keep_longest(g, branch)
    return len(branch)


def resolve_simple_bubble(g: MutableGraph) -> int:
    cnt = 0
    for e in range(g.n_e):
        if g.edges[e].source != -1:
            cnt += check_simple_bubble(g, e)
    return cnt


def resolve_align_bubble(g: MutableGraph, device="cuda") -> int:
    """Pass-level batching: collect every candidate pair first, score
    them all in one DP dispatch, then apply merges in reference order.
    Scores depend only on sequences, which merges never change (they
    only remove edges and sum counts), so pre-scoring is exact."""
    all_pairs = []
    per_edge = {}
    for se in range(g.n_e):
        if g.edges[se].source == -1:
            continue
        cand = _align_bubble_candidates(g, se)
        if cand:
            per_edge[se] = cand
            all_pairs.extend((se, e) for e in cand)
    scores = nw_align_scores_batch(
        [(g.edges[a].seq, g.edges[b].seq) for a, b in all_pairs], device)
    accepted = {
        (a, b): _bubble_accept(int(s), g.edges[a].seq_len, g.edges[b].seq_len)
        for (a, b), s in zip(all_pairs, scores)}
    cnt = 0
    for se, cand in per_edge.items():
        if g.edges[se].source == -1:
            continue
        branch = [se] + [e for e in cand
                         if g.edges[e].source != -1
                         and accepted.get((se, e), False)]
        if len(branch) < 2:
            continue
        _bubble_keep_longest(g, branch)
        cnt += len(branch)
    return cnt


def _merge_barcodes(g: MutableGraph, dst: int, src: int) -> None:
    """Merge src's barcode stores into dst (reference
    asm_append_barcode_readpair) when aux info is attached."""
    d, s = g.edges[dst], g.edges[src]
    if getattr(d, "barcodes", None) is None or \
            getattr(s, "barcodes", None) is None:
        return
    for lvl in range(3):
        for bc, c in s.barcodes[lvl].items():
            d.barcodes[lvl][bc] = d.barcodes[lvl].get(bc, 0) + c


def resolve_dump_loop(g: MutableGraph) -> int:
    """Duplicate a loop-through edge:  e1 ->(e)-> O <-(loop)-> O ->(e2)
    becomes e · loop · e (reference asm_resolve_dump_loop,
    src/basic_resolve.c:1221-1276; kept out of the assembly3 flow there,
    src/process.c:499-501 — exposed as its own pass here too)."""
    res = 0
    tmp_n_e = g.n_e
    for e in range(tmp_n_e):
        ed = g.edges[e]
        rc = ed.rc_id
        if e > rc or ed.source == -1:
            continue
        tg = ed.target
        sr = g.node_rc[ed.source]
        if g.deg(tg) != 2 or g.deg(sr) != 2:
            continue
        loop_e = -1
        for i in range(2):
            for j in range(2):
                if g.node_adj[tg][i] == g.edges[g.node_adj[sr][j]].rc_id:
                    loop_e = g.node_adj[tg][i]
                    break
            if loop_e != -1:
                break
        if loop_e == -1:
            continue
        a0 = g.edges[g.node_adj[sr][0]].rc_id
        e1 = a0 if a0 != loop_e else g.edges[g.node_adj[sr][1]].rc_id
        e2 = g.node_adj[tg][0] if g.node_adj[tg][0] != loop_e \
            else g.node_adj[tg][1]
        if e1 == e2 or e == loop_e:
            continue
        g.append_seq(loop_e, e, g.ksize)
        _merge_barcodes(g, loop_e, e)
        g.append_seq(e, loop_e, g.ksize)
        _merge_barcodes(g, e, loop_e)
        g.edges[e].count += g.edges[e].count + g.edges[loop_e].count
        loop_e_rc = g.edges[loop_e].rc_id
        e_rc = g.edges[e].rc_id
        g.append_seq(loop_e_rc, e_rc, g.ksize)
        _merge_barcodes(g, loop_e_rc, e_rc)
        g.append_seq(e_rc, loop_e_rc, g.ksize)
        _merge_barcodes(g, e_rc, loop_e_rc)
        g.edges[e_rc].count = g.edges[e].count
        g.remove_edge_pair(loop_e)
        res += 1
    return res


def resolve_dump_branch(g: MutableGraph) -> int:
    """Collapse a 2-branch: e -> O ={mid0,mid1}= O -> next; drop the
    lower-coverage middle branch (reference asm_resolve_dump_branch,
    src/basic_resolve.c:1278-1317)."""
    res = 0
    for e in range(g.n_e):
        ed = g.edges[e]
        rc = ed.rc_id
        if e > rc or ed.source == -1:
            continue
        tg = ed.target
        if g.deg(tg) != 2:
            continue
        next_edge = [-1, -2]
        mid_edge = [0, 0]
        for i in range(2):
            mid_e = g.node_adj[tg][i]
            mid_edge[i] = mid_e
            mid_tg = g.edges[mid_e].target
            if g.deg(mid_tg) != 1:
                break
            next_edge[i] = g.node_adj[mid_tg][0]
        if next_edge[0] != next_edge[1] or next_edge[0] == e:
            continue
        trash = mid_edge[0] if g.edge_cov(mid_edge[0]) < \
            g.edge_cov(mid_edge[1]) else mid_edge[1]
        g.remove_edge_pair(trash)
        res += 1
    return res


def lazy_condense(g: MutableGraph) -> None:
    """In-place join of (1,1) nodes (reference asm_lazy_condense
    basic_resolve.c:72-102)."""
    for u in range(g.n_v):
        u_rc = g.node_rc[u]
        if g.deg(u) == 1 and g.deg(u_rc) == 1:
            e1 = g.node_adj[u][0]
            e2 = g.node_adj[u_rc][0]
            if e1 == e2 or e1 == g.edges[e2].rc_id:
                continue
            # chain through u_rc: rc(e1) -> u_rc -> e2; the reference calls
            # asm_join_edge(g, rc(e1), e1, e2, rc(e2)) which merges rc(e1)
            # followed by e2 (survivors rc(e1) and rc(e2))
            g.join_edge(g.edges[e1].rc_id, e2)
