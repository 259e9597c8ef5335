"""Graph condensation — rebuild keeping only branching nodes.

Faithful to the reference's `asm_condense` (src/basic_resolve.c:251-375):

- node kept iff it is a single-loop anchor (deg_fw==deg_rv==1 and the fw
  edge is the rc of the rv out-edge: a self-loop), or it is branching
  (NOT (1,1), NOT isolated, NOT a short dead-end per `is_dead_end`
  src/basic_resolve.c:54-70 — an isolated edge < 250 bp whose two
  endpoint nodes both have total degree 1 is dropped entirely);
- new edges walk chains of dropped (1,1) middle nodes, concatenating
  sequences with k-overlap and summing counts; each produces its rc
  clone, so edges stay in adjacent rc pairs (p, p+1).
"""

from __future__ import annotations

import numpy as np

from .structs import AsmGraph

DEAD_END_LEN = 250  # reference src/basic_resolve.c:69


def _is_dead_end(g: AsmGraph, u: int, deg, lens_h) -> bool:
    u_rc = int(g.node_rc[u])
    if deg[u] + deg[u_rc] != 1:
        return False
    e = int(g.node_adj(u)[0]) if deg[u] else int(g.node_adj(u_rc)[0])
    v = int(g.edge_target[e])
    v_rc = int(g.node_rc[v])
    if deg[v] + deg[v_rc] != 1:
        return False
    return lens_h[e] < DEAD_END_LEN


def asm_condense(g0: AsmGraph, return_map: bool = False):
    """Vectorized condense; the per-node python walk is kept as
    `asm_condense_py`, the parity oracle of the tests."""
    return asm_condense_fast(g0, return_map)


def _keep_mask(g0: AsmGraph, deg: np.ndarray, lens_h: np.ndarray):
    """Vectorized node-keep predicate (same clauses as the python loop)."""
    n_v = g0.n_v
    node_rc = g0.node_rc
    first_adj = np.full(n_v, -1, np.int64)
    nz = deg > 0
    first_adj[nz] = g0.adj_list[g0.adj_off[:-1][nz]]
    deg_rv = deg[node_rc]
    rv_e = first_adj[node_rc]
    rc_of_rv = np.where(rv_e >= 0, g0.edge_rc[np.maximum(rv_e, 0)], -2)
    deg11 = (deg == 1) & (deg_rv == 1)
    single_loop = deg11 & (first_adj == rc_of_rv)
    isolated = (deg + deg_rv) == 0
    tot1 = (deg + deg_rv) == 1
    e_de = np.where(deg > 0, first_adj, rv_e)
    e_de_c = np.maximum(e_de, 0)
    v = g0.edge_target[e_de_c]
    totv = deg[v] + deg[node_rc[v]]
    dead = tot1 & (totv == 1) & (lens_h[e_de_c] < DEAD_END_LEN)
    keep = single_loop | ~(deg11 | isolated | dead)
    return keep, first_adj


def asm_condense_fast(g0: AsmGraph, return_map: bool = False):
    from .build import _pointer_double_to_head

    g0.rebuild_adjacency()
    deg = g0.node_deg()
    lens_h = g0.edge_lens_with_holes()
    keep, first_adj = _keep_mask(g0, deg, lens_h)
    node_id = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int64)
    n_v = int(keep.sum())
    new_node_rc = node_id[g0.node_rc[keep]]

    k = g0.ksize
    n_e = g0.n_e
    alive = g0.edge_source >= 0
    tgt = g0.edge_target
    tgt_c = np.maximum(tgt, 0)
    # follow into dropped (1,1) middle nodes only; each has exactly one
    # in-edge, so chains are proper linked lists in edge space
    follow = alive & ~keep[tgt_c] & (deg[tgt_c] == 1) & (tgt >= 0)
    nxt = np.where(follow, first_adj[tgt_c], -1)
    prev = np.full(n_e, -1, np.int64)
    vn = np.flatnonzero(nxt >= 0)
    prev[nxt[vn]] = vn
    head_of, dist = _pointer_double_to_head(prev)
    head_of = head_of.astype(np.int64)

    # chain heads = alive edges out of kept nodes, ordered exactly as the
    # python walk finds them: ascending (source node, edge id)
    src_c = np.maximum(g0.edge_source, 0)
    heads_mask = alive & keep[src_c]
    heads = np.flatnonzero(heads_mask)
    heads = heads[np.lexsort((heads, g0.edge_source[heads]))]
    n_ch = len(heads)
    if n_ch == 0:
        g = AsmGraph(ksize=k)
        g.node_rc = new_node_rc
        g.rebuild_adjacency()
        if return_map:
            return g, np.flatnonzero(keep).astype(np.int64)
        return g
    head_rank = np.full(n_e, -1, np.int64)
    head_rank[heads] = np.arange(n_ch)

    members = np.flatnonzero(alive)
    rk = head_rank[head_of[members]]
    inchain = rk >= 0  # excludes dropped isolated/dead-end edges + pure middle cycles
    members, rk = members[inchain], rk[inchain]
    order = np.lexsort((dist[members], rk))
    mo, rm = members[order], rk[order]
    d = dist[mo]

    lens = g0.edge_len()
    seg_bounds = np.concatenate([np.flatnonzero(np.diff(rm) != 0) + 1,
                                 [len(rm)]]).astype(np.int64)
    seg_starts = np.concatenate([[0], seg_bounds[:-1]]).astype(np.int64)
    last_e = mo[seg_bounds - 1]
    chain_count = np.add.reduceat(g0.edge_count[mo], seg_starts) \
        if len(mo) else np.zeros(0, np.int64)
    out_len_seg = lens[mo] - k * (d > 0)
    chain_len = np.add.reduceat(out_len_seg, seg_starts) \
        if len(mo) else np.zeros(0, np.int64)

    # rc pairing: the reverse walk of chain c starts at rc(last edge);
    # the representative of each pair is the one the python loop reaches
    # first (smaller head rank).  A palindromic chain is its own partner.
    partner = head_rank[g0.edge_rc[last_e]] if n_ch else np.zeros(0, np.int64)
    rep = np.arange(n_ch) <= partner
    reps = np.flatnonzero(rep)               # already in rank order
    n_pairs = len(reps)

    # gather member segments of representative chains into the fw pool
    msel = rep[rm]
    mo_r, rm_r, d_r = mo[msel], rm[msel], d[msel]
    rep_of_rank = np.full(n_ch, -1, np.int64)
    rep_of_rank[reps] = np.arange(n_pairs)
    rr = rep_of_rank[rm_r]
    out_lens_r = (lens[mo_r] - k * (d_r > 0)).astype(np.int64)
    src_start = (g0.seq_off[mo_r] + k * (d_r > 0)).astype(np.int64)
    rep_len = chain_len[reps]
    tot = int(out_lens_r.sum())
    seg_out_off = np.concatenate([[0], np.cumsum(out_lens_r)]).astype(np.int64)
    seg_ids = np.repeat(np.arange(len(mo_r)), out_lens_r)
    within = np.arange(tot, dtype=np.int64) - seg_out_off[seg_ids]
    fwpool = g0.seq_data[src_start[seg_ids] + within]
    fpool_off = np.concatenate([[0], np.cumsum(rep_len)]).astype(np.int64)

    # interleave fw / rc spans in the new pool
    new_lens = np.repeat(rep_len, 2)
    new_seq_off = np.concatenate([[0], np.cumsum(new_lens)]).astype(np.int64)
    new_seq = np.empty(int(new_lens.sum()), np.uint8)
    cid = np.repeat(np.arange(n_pairs), rep_len)
    win = np.arange(tot, dtype=np.int64) - fpool_off[cid]
    new_seq[new_seq_off[0::2][:n_pairs][cid] + win] = fwpool
    rev = fpool_off[cid] + (rep_len[cid] - 1 - win)
    new_seq[new_seq_off[1::2][:n_pairs][cid] + win] = 3 - fwpool[rev]

    g = AsmGraph(ksize=k)
    g.node_rc = new_node_rc
    x = node_id[g0.edge_source[heads[reps]]]
    tv_old = g0.edge_target[last_e[reps]]
    g.edge_source = np.empty(2 * n_pairs, np.int64)
    g.edge_target = np.empty(2 * n_pairs, np.int64)
    g.edge_source[0::2] = x
    g.edge_target[0::2] = node_id[tv_old]
    g.edge_source[1::2] = node_id[g0.node_rc[tv_old]]
    g.edge_target[1::2] = node_id[g0.node_rc[g0.edge_source[heads[reps]]]]
    g.edge_rc = np.empty(2 * n_pairs, np.int64)
    g.edge_rc[0::2] = np.arange(n_pairs) * 2 + 1
    g.edge_rc[1::2] = np.arange(n_pairs) * 2
    g.edge_count = np.repeat(chain_count[reps], 2)
    g.seq_off = new_seq_off
    g.seq_data = new_seq

    # holes: rare (post-scaffolding graphs) — python walk only for the
    # chains that actually carry hole-bearing edges
    if g0.holes:
        holed = np.zeros(n_e, bool)
        holed[np.fromiter(g0.holes.keys(), np.int64, len(g0.holes))] = True
        hchains = np.unique(rr[holed[mo_r]]) if len(mo_r) else []
        for ci in hchains:
            sel = rr == ci
            edges_c = mo_r[sel]
            dj = d_r[sel]
            olens = out_lens_r[sel]
            base = np.concatenate([[0], np.cumsum(olens[:-1])]) - k * (dj > 0)
            holes = []
            for e_, b_ in zip(edges_c.tolist(), base.tolist()):
                holes.extend(_edge_holes(g0, e_, int(b_)))
            if holes:
                p = 2 * int(ci)
                g.holes[p] = (np.array([h[0] for h in holes], np.int64),
                              np.array([h[1] for h in holes], np.int64))
                mh = _mirror_holes(holes, int(rep_len[ci]))
                g.holes[p + 1] = (np.array([h[0] for h in mh], np.int64),
                                  np.array([h[1] for h in mh], np.int64))

    g.rebuild_adjacency()
    if return_map:
        return g, np.flatnonzero(keep).astype(np.int64)
    return g


def asm_condense_py(g0: AsmGraph, return_map: bool = False):
    g0.rebuild_adjacency()
    deg = g0.node_deg()
    lens_h = g0.edge_lens_with_holes()

    node_id = np.full(g0.n_v, -1, np.int64)
    n_v = 0
    for u in range(g0.n_v):
        u_rc = int(g0.node_rc[u])
        deg_fw, deg_rv = int(deg[u]), int(deg[u_rc])
        is_single_loop = False
        if deg_fw == 1 and deg_rv == 1:
            fw_e = int(g0.node_adj(u)[0])
            rv_e = int(g0.edge_rc[int(g0.node_adj(u_rc)[0])])
            is_single_loop = fw_e == rv_e
        if not is_single_loop and (
            (deg_fw == 1 and deg_rv == 1)
            or deg_fw + deg_rv == 0
            or _is_dead_end(g0, u, deg, lens_h)
        ):
            continue
        node_id[u] = n_v
        n_v += 1

    new_node_rc = np.zeros(n_v, np.int64)
    for u in range(g0.n_v):
        if node_id[u] != -1:
            new_node_rc[node_id[u]] = node_id[int(g0.node_rc[u])]

    # walk chains
    consumed_rc = set()  # (v_rc, e_rc) adjacency entries already used
    new_edges = []  # dicts
    adj_sets = {}

    for u in range(g0.n_v):
        x = node_id[u]
        if x == -1:
            continue
        for e0 in g0.node_adj(u):
            e = int(e0)
            if (u, e) in consumed_rc:
                continue
            seq_parts = [g0.get_seq(e)]
            holes = list(_edge_holes(g0, e, 0))
            count = int(g0.edge_count[e])
            offset = g0.edge_len(e)
            while True:
                v = int(g0.edge_target[e])
                if node_id[v] == -1:
                    assert deg[v] == 1, "middle node degree != 1"
                    e = int(g0.node_adj(v)[0])
                    seq_parts.append(g0.get_seq(e)[g0.ksize:])
                    holes.extend(_edge_holes(g0, e, offset - g0.ksize))
                    count += int(g0.edge_count[e])
                    offset += g0.edge_len(e) - g0.ksize
                else:
                    break
            v_rc = int(g0.node_rc[v])
            e_rc = int(g0.edge_rc[e])
            consumed_rc.add((v_rc, e_rc))

            seq = np.concatenate(seq_parts)
            p = len(new_edges)
            q = p + 1
            y_rc = node_id[v_rc]
            new_edges.append(dict(source=x, target=node_id[v], rc_id=q,
                                  count=count, seq=seq, holes=holes))
            rc_seq = (3 - seq)[::-1]
            rc_holes = _mirror_holes(holes, len(seq))
            new_edges.append(dict(source=y_rc, target=new_node_rc[x], rc_id=p,
                                  count=count, seq=rc_seq, holes=rc_holes))

    g = AsmGraph(ksize=g0.ksize)
    g.node_rc = new_node_rc
    n_e = len(new_edges)
    g.edge_source = np.array([e["source"] for e in new_edges], np.int64) if n_e else np.zeros(0, np.int64)
    g.edge_target = np.array([e["target"] for e in new_edges], np.int64) if n_e else np.zeros(0, np.int64)
    g.edge_rc = np.array([e["rc_id"] for e in new_edges], np.int64) if n_e else np.zeros(0, np.int64)
    g.edge_count = np.array([e["count"] for e in new_edges], np.int64) if n_e else np.zeros(0, np.int64)
    seqs = [e["seq"] for e in new_edges]
    lens = np.array([len(s) for s in seqs], np.int64)
    g.seq_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    g.seq_data = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    for i, e in enumerate(new_edges):
        if e["holes"]:
            ph = np.array([p for p, _ in e["holes"]], np.int64)
            lh = np.array([l for _, l in e["holes"]], np.int64)
            g.holes[i] = (ph, lh)
    g.rebuild_adjacency()
    if return_map:
        # new node id -> old node id (reference asm_condense_map,
        # src/basic_resolve.c:377-505)
        new_to_old = np.zeros(n_v, np.int64)
        for u in range(g0.n_v):
            if node_id[u] != -1:
                new_to_old[node_id[u]] = u
        return g, new_to_old
    return g


def _edge_holes(g: AsmGraph, e: int, offset: int):
    if e in g.holes:
        ph, lh = g.holes[e]
        for p, l in zip(ph, lh):
            yield (int(p) + offset, int(l))


def _mirror_holes(holes, seq_len: int):
    """Hole after position p (0-based) in seq -> hole after position
    seq_len - 2 - p in the rc (reference asm_clone_seq_reverse)."""
    return [(seq_len - 2 - p, l) for p, l in reversed(holes)]
