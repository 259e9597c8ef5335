"""Barcode-guided n-m bridge resolution — rebuild of src/barcode_resolve2.c.

A bridge edge e with n in-legs and m out-legs is resolved by pairing
legs whose barcode sets look connected:

  get_max_barcode_set (:193-202)  pick lvl0/1/2 set by contig length
                                  (>=200/500/3000 bp)
  check_barcode_positive (:208)   shared/min(|h1|,|h2|) >= 0.044
                                  (MIN_BARCODE_RATIO assembly_graph.h:132)
  check_barcode_superior (:223)   share(1,2) > 2*share(1,2a)
  check_barcode_greater  (:253)   share(1,2) > share(1,2a)
  callibrate_uni_cov (:162)       local unit coverage from legs within
                                  0.75-1.25x of the global estimate
  check_2_2_high_strict (:534)    2-in/2-out: mutual superiority + both
                                  pairings positive + compatible
                                  coverage ranges -> two join_edge3
  check_n_m_bridge (:819)         general n-m: repeatedly pair legs via
                                  bc_find_pair (best + uniquely superior)
                                  with compatible coverage; leftover
                                  1-1 joined if positive; bridge removed
  resolve_n_m_simple (:1389)      fixpoint driver + condense

Coverage-range plumbing (convert_cov_range / __check_coverage) follows
assembly_graph.h:168-215.

A copy of turingassembler_tpu/resolve/barcodes.py (host code): dict and
set iteration orders are part of the result, so the passes are copied
line for line, the worklist twins and their VEC_MIN_EDGES dispatch too.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..graph.condense import asm_condense
from ..graph.mutable import MutableGraph
from ..graph.structs import AsmGraph
from .basic import _convert_cov_range

CONTIG_USE_BARCODE = 200   # assembly_graph.h:111
CONTIG_LEVEL_0 = 500
CONTIG_LEVEL_1 = 3000
MIN_BARCODE_RATIO = 0.044  # assembly_graph.h:132
MIN_CONTIG_READPAIR = 500  # assembly_graph.h:125
MIN_CONTIG_BARCODE = 5000  # assembly_graph.h:121
MIN_LONG_CONTIG = 1000     # assembly_graph.h:123
MAX_MOLECULE_LEN = 30000   # assembly_graph.h:127
MAX_EDGE_COUNT = 10000     # barcode_resolve2.c:29
EPS = 1e-6


def _check_coverage(f1, f2, r1, r2):
    """__check_coverage (assembly_graph.h:174-176)."""
    intersect = r1[0] <= r2[1] and r2[0] <= r1[1]
    return intersect and abs(f1 - f2) < 0.3


class BarcodeResolver:
    def __init__(self, g: MutableGraph):
        self.g = g

    # -- barcode set helpers ------------------------------------------------
    def _bc_set(self, e: int, length: int) -> Optional[Dict[int, int]]:
        if length < CONTIG_USE_BARCODE:
            return None
        ed = self.g.edges[e]
        if ed.barcodes is None:
            return None
        if length < CONTIG_LEVEL_0:
            return ed.barcodes[0]
        if length < CONTIG_LEVEL_1:
            return ed.barcodes[1]
        return ed.barcodes[2]

    @staticmethod
    def _shared_count(h1: Dict[int, int], h2: Dict[int, int]) -> int:
        """|keys(h1) & keys(h2)| — vectorized via sorted uint64 arrays
        for big sets (the ratio tests run at every n-m node over
        thousand-entry barcode sets on real libraries; the python
        membership loop was the inner cost of resolve_n_m_simple).
        Small sets keep the dict loop (faster below
        the numpy constant)."""
        if len(h1) > len(h2):
            h1, h2 = h2, h1
        if len(h1) < 64:
            return sum(1 for k in h1 if k in h2)
        a1 = np.fromiter(h1.keys(), np.uint64, len(h1))
        a2 = np.fromiter(h2.keys(), np.uint64, len(h2))
        a2.sort()
        idx = np.searchsorted(a2, a1)
        idx[idx >= len(a2)] = len(a2) - 1
        return int((a2[idx] == a1).sum())

    def positive(self, e1: int, e2: int) -> int:
        length = min(self.g.edges[e1].seq_len, self.g.edges[e2].seq_len)
        h1 = self._bc_set(e1, length)
        h2 = self._bc_set(e2, length)
        if h1 is None or h2 is None or not h1 or not h2:
            return -1
        shared = self._shared_count(h1, h2)
        ratio = shared / min(len(h1), len(h2))
        return int(ratio + EPS > MIN_BARCODE_RATIO)

    def _shares(self, e1: int, e2: int, e2a: int):
        h1 = self._bc_set(e1, self.g.edges[e1].seq_len)
        len2 = min(self.g.edges[e2].seq_len, self.g.edges[e2a].seq_len)
        h2 = self._bc_set(e2, len2)
        h2a = self._bc_set(e2a, len2)
        if h1 is None or h2 is None or h2a is None:
            return None
        s12 = self._shared_count(h1, h2)
        s12a = self._shared_count(h1, h2a)
        return s12, s12a

    def superior(self, e1: int, e2: int, e2a: int) -> int:
        s = self._shares(e1, e2, e2a)
        if s is None:
            return -1
        return int(s[0] > s[1] * 2)

    def greater(self, e1: int, e2: int, e2a: int) -> int:
        s = self._shares(e1, e2, e2a)
        if s is None:
            return -1
        return int(s[0] > s[1])

    # -- coverage helpers ---------------------------------------------------
    def _calibrate(self, legs: List[int], uni_cov: float) -> float:
        s, c = 0.0, 0
        for e in legs:
            cov = self.g.edge_cov(e)
            if 0.75 < cov / uni_cov < 1.25:
                s += cov
                c += 1
        return s / c if c else uni_cov

    def check_long_loop(self, e: int, uni_cov: float) -> int:
        """Unroll or break a 1-in/1-out loop pair before 2-2 handling
        (reference check_long_loop, src/barcode_resolve2.c:1119-1215)."""
        g = self.g
        u = g.edges[e].source
        v = g.edges[e].target
        e_rc = g.edges[e].rc_id
        u_rc, v_rc = g.node_rc[u], g.node_rc[v]
        if (g.deg(u) != 1 or g.deg(v_rc) != 1 or
                g.deg(u_rc) > 2 or g.deg(v) > 2):
            return 0
        e2 = e_return = -1
        for ee in g.node_adj[v]:
            if g.edges[ee].target == u:
                e_return = ee
            else:
                e2 = ee
        if e_return == -1 or e2 == -1:
            return 0
        e1 = e_return_rc = -1
        for ee in g.node_adj[u_rc]:
            if g.edges[ee].target == v_rc:
                e_return_rc = ee
            else:
                e1 = ee
        if e_return_rc != g.edges[e_return].rc_id:
            return 0
        f_e = g.edge_cov(e) / uni_cov
        f_ret = g.edge_cov(e_return) / uni_cov
        r_e = _convert_cov_range(f_e)
        r_ret = _convert_cov_range(f_ret)
        rep = min(r_e[1] - 1, r_ret[1])
        if rep <= 0:
            if g.edges[e_return].seq_len < 100 or f_e < f_ret:
                g.remove_edge_pair(e_return)
                return 1
            rep = 1
        g.unroll_loop_forward(e, e_return, rep)
        g.unroll_loop_forward(e_rc, e_return_rc, rep)
        g.remove_edge_pair(e_return)

        def pos_or_short(a, b):
            if (g.edges[a].seq_len >= CONTIG_USE_BARCODE and
                    g.edges[b].seq_len >= CONTIG_USE_BARCODE):
                return self.positive(a, b) == 1
            return True

        flag1 = e1 != -1 and pos_or_short(e1, e)
        flag2 = e2 != -1 and pos_or_short(e2, e_rc)
        flag3 = (e1 != -1 and e2 != -1 and
                 g.edges[e1].seq_len >= CONTIG_USE_BARCODE and
                 g.edges[e2].seq_len >= CONTIG_USE_BARCODE and
                 self.positive(e1, e2) == 1)
        if (flag1 and flag2) or (flag3 and (flag1 or flag2 or
                                            g.edges[e].seq_len < 100)):
            g.join_edge3(g.edges[e1].rc_id, e, e2, g.edges[e].count)
            g.remove_edge_pair(e)
            return 1
        if not flag1:
            g.isolate_edge(e)
        if not flag2:
            g.isolate_edge(e2)
        return 0

    # -- 2-2 bridge ---------------------------------------------------------
    def check_2_2_high_strict(self, e: int, uni_cov: float) -> int:
        g = self.g
        e_rc = g.edges[e].rc_id
        v = g.edges[e].target
        u = g.edges[e].source
        v_rc, u_rc = g.node_rc[v], g.node_rc[u]
        if (g.deg(u) != 1 or g.deg(v_rc) != 1 or
                g.deg(u_rc) != 2 or g.deg(v) != 2):
            return 0
        legs = [g.node_adj[u_rc][0], g.node_adj[u_rc][1],
                g.node_adj[v][0], g.node_adj[v][1]]
        uni = self._calibrate(legs, uni_cov)
        fcov = [g.edge_cov(x) / uni for x in legs]
        rcov = [_convert_cov_range(f) for f in fcov]

        for (a, b), (c, d) in (((0, 2), (1, 3)), ((0, 3), (1, 2))):
            if self.superior(legs[a], legs[b], legs[d]) != 1:
                continue
            if (self.superior(legs[c], legs[d], legs[b]) == 0 or
                    self.superior(legs[b], legs[a], legs[c]) == 0 or
                    self.superior(legs[d], legs[c], legs[a]) == 0):
                return 0
            if (self.positive(legs[a], legs[b]) == 0 or
                    self.positive(legs[c], legs[d]) == 0):
                return 0
            if (not _check_coverage(fcov[a], fcov[b], rcov[a], rcov[b]) or
                    not _check_coverage(fcov[c], fcov[d], rcov[c], rcov[d])):
                return 0
            half = g.edges[e].count // 2
            g.join_edge3(g.edges[legs[a]].rc_id, e, legs[b], half)
            g.join_edge3(g.edges[legs[c]].rc_id, e, legs[d], half)
            g.remove_edge_pair(e)
            return 2
        return 0

    def _legs_2_2(self, e: int):
        """Topology gate + the 4 legs of a 2-2 bridge (shared by the
        three strictness tiers, reference barcode_resolve2.c:534-553)."""
        g = self.g
        v = g.edges[e].target
        u = g.edges[e].source
        v_rc, u_rc = g.node_rc[v], g.node_rc[u]
        if (g.deg(u) != 1 or g.deg(v_rc) != 1 or
                g.deg(u_rc) != 2 or g.deg(v) != 2):
            return None
        return [g.node_adj[u_rc][0], g.node_adj[u_rc][1],
                g.node_adj[v][0], g.node_adj[v][1]]

    def _join_2_2(self, e: int, legs, a: int, b: int, c: int, d: int) -> int:
        g = self.g
        half = g.edges[e].count // 2
        g.join_edge3(g.edges[legs[a]].rc_id, e, legs[b], half)
        g.join_edge3(g.edges[legs[c]].rc_id, e, legs[d], half)
        g.remove_edge_pair(e)
        return 2

    def check_2_2_med_strict(self, e: int, uni_cov: float) -> int:
        """2-2 bridge, medium strictness (reference
        check_2_2_med_strict_bridge, src/barcode_resolve2.c:627-725):
        at least ONE of the four superiority conditions of a pairing
        holds, no `greater` evidence for the cross pairing, both chosen
        pairs positive, compatible coverage."""
        g = self.g
        legs = self._legs_2_2(e)
        if legs is None:
            return 0
        uni = self._calibrate(legs, uni_cov)
        fcov = [g.edge_cov(x) / uni for x in legs]
        rcov = [_convert_cov_range(f) for f in fcov]
        for (a, b), (c, d) in (((0, 2), (1, 3)), ((0, 3), (1, 2))):
            if not (self.superior(legs[a], legs[b], legs[d]) == 1 or
                    self.superior(legs[c], legs[d], legs[b]) == 1 or
                    self.superior(legs[b], legs[a], legs[c]) == 1 or
                    self.superior(legs[d], legs[c], legs[a]) == 1):
                continue
            if (self.greater(legs[a], legs[d], legs[b]) == 1 or
                    self.greater(legs[c], legs[b], legs[d]) == 1 or
                    self.greater(legs[b], legs[c], legs[a]) == 1 or
                    self.greater(legs[d], legs[a], legs[c]) == 1):
                return 0
            if (self.positive(legs[a], legs[b]) == 0 or
                    self.positive(legs[c], legs[d]) == 0):
                return 0
            if (not _check_coverage(fcov[a], fcov[b], rcov[a], rcov[b]) or
                    not _check_coverage(fcov[c], fcov[d], rcov[c], rcov[d])):
                return 0
            return self._join_2_2(e, legs, a, b, c, d)
        return 0

    def check_2_2_low_strict(self, e: int, uni_cov: float) -> int:
        """2-2 bridge, low strictness (reference
        check_2_2_low_strict_bridge, src/barcode_resolve2.c:727-818):
        both chosen pairs positive, neither cross pair positive,
        compatible coverage."""
        g = self.g
        legs = self._legs_2_2(e)
        if legs is None:
            return 0
        uni = self._calibrate(legs, uni_cov)
        fcov = [g.edge_cov(x) / uni for x in legs]
        rcov = [_convert_cov_range(f) for f in fcov]
        for (a, b), (c, d) in (((0, 2), (1, 3)), ((0, 3), (1, 2))):
            if not (self.positive(legs[a], legs[b]) == 1 or
                    self.positive(legs[c], legs[d]) == 1):
                continue
            if (self.positive(legs[a], legs[d]) == 1 or
                    self.positive(legs[c], legs[b]) == 1):
                return 0
            if (self.positive(legs[a], legs[b]) == 0 or
                    self.positive(legs[c], legs[d]) == 0):
                return 0
            if (not _check_coverage(fcov[a], fcov[b], rcov[a], rcov[b]) or
                    not _check_coverage(fcov[c], fcov[d], rcov[c], rcov[d])):
                return 0
            return self._join_2_2(e, legs, a, b, c, d)
        return 0

    # -- n-m bridge ---------------------------------------------------------
    def _find_pair(self, se: int, adj: List[int]) -> int:
        ret_e = sec_e = -1
        for e in adj:
            if e == se or e == self.g.edges[se].rc_id:
                continue
            if self.positive(se, e) == 1:
                if ret_e == -1 or self.greater(se, e, ret_e) == 1:
                    sec_e = ret_e
                    ret_e = e
                elif sec_e == -1 or self.greater(se, e, sec_e) == 1:
                    sec_e = e
        if ret_e == -1:
            return -1
        if sec_e != -1 and self.superior(se, ret_e, sec_e) != 1:
            return -2
        return ret_e

    def check_n_m_bridge(self, e: int, uni_cov: float) -> int:
        g = self.g
        e_rc = g.edges[e].rc_id
        v = g.edges[e].target
        u = g.edges[e].source
        v_rc, u_rc = g.node_rc[v], g.node_rc[u]
        if (g.deg(u) != 1 or g.deg(v_rc) != 1 or
                (g.deg(u_rc) < 2 and g.deg(v) < 2)):
            return 0
        legs1 = [x for x in g.node_adj[u_rc]
                 if g.edges[x].seq_len >= CONTIG_USE_BARCODE]
        legs2 = [x for x in g.node_adj[v]
                 if g.edges[x].seq_len >= CONTIG_USE_BARCODE]
        uni = self._calibrate(legs1 + legs2, uni_cov)
        e_cov = g.edge_cov(e) / uni
        sub_count = 0
        ret = 0
        while True:
            resolved = False
            for e1 in list(legs1):
                f1 = g.edge_cov(e1) / uni
                r1 = _convert_cov_range(f1)
                e2 = self._find_pair(e1, legs2)
                if e2 < 0:
                    continue
                f2 = g.edge_cov(e2) / uni
                r2 = _convert_cov_range(f2)
                if not _check_coverage(f1, f2, r1, r2):
                    continue
                et1 = self._find_pair(e2, legs1)
                if et1 != -1 and et1 != e1:
                    continue
                add = int(g.edges[e].count * (f1 + f2) / 2.0 / max(e_cov, EPS))
                g.join_edge3(g.edges[e1].rc_id, e, e2, add)
                legs1.remove(e1)
                legs2.remove(e2)
                sub_count += add
                resolved = True
                break
            if not resolved:
                break
            ret += 1
        if sub_count <= g.edges[e].count:
            g.edges[e].count -= sub_count
            g.edges[e_rc].count -= sub_count
        else:
            g.edges[e].count = g.edges[e_rc].count = 0
        if g.deg(u_rc) == 1 and g.deg(v) == 1:
            e1 = g.node_adj[u_rc][0]
            e2 = g.node_adj[v][0]
            f1 = g.edge_cov(e1) / uni
            f2 = g.edge_cov(e2) / uni
            r1, r2 = _convert_cov_range(f1), _convert_cov_range(f2)
            ec = g.edge_cov(e) / uni
            er = _convert_cov_range(ec)
            if (g.edges[e1].seq_len >= MIN_CONTIG_READPAIR and
                    g.edges[e2].seq_len >= MIN_CONTIG_READPAIR and
                    self.positive(e1, e2) == 1 and
                    _check_coverage(f1, f2, r1, r2) and
                    _check_coverage(f1, ec, r1, er) and
                    _check_coverage(f2, ec, r2, er)):
                g.join_edge3(g.edges[e1].rc_id, e, e2, g.edges[e].count)
                ret += 1
            g.remove_edge_pair(e)
        elif g.deg(u_rc) + g.deg(v) == 1:
            g.remove_edge_pair(e)
        return ret


    def check_n_m_node(self, u: int, uni_cov: float) -> int:
        """Resolve an n-m NODE (no bridge edge in the middle) by pairing
        in-legs with out-legs on barcode support (reference
        check_n_m_node, src/barcode_resolve2.c:943-1056).  Leftover 1-1
        legs are joined when positive + coverage-compatible (with the
        barcode check waived for short legs), else the in-leg is
        isolated onto a fresh node."""
        g = self.g
        u_rc = g.node_rc[u]
        if u == u_rc or g.deg(u) == 0 or g.deg(u_rc) == 0:
            return 0
        legs1 = [x for x in g.node_adj[u_rc]
                 if g.edges[x].seq_len >= CONTIG_USE_BARCODE]
        legs2 = [x for x in g.node_adj[u]
                 if g.edges[x].seq_len >= CONTIG_USE_BARCODE]
        uni = self._calibrate(legs1 + legs2, uni_cov)
        ret = 0
        while True:
            resolved = False
            for e1 in list(legs1):
                f1 = g.edge_cov(e1) / uni
                r1 = _convert_cov_range(f1)
                e2 = self._find_pair(e1, legs2)
                if e2 < 0:
                    continue
                f2 = g.edge_cov(e2) / uni
                r2 = _convert_cov_range(f2)
                if not _check_coverage(f1, f2, r1, r2):
                    continue
                et1 = self._find_pair(e2, legs1)
                if et1 != -1 and et1 != e1:
                    continue
                g.join_edge(g.edges[e1].rc_id, e2)
                legs1.remove(e1)
                legs2.remove(e2)
                resolved = True
                break
            if not resolved:
                break
            ret += 1
        if g.deg(u_rc) == 1 and g.deg(u) == 1:
            e1 = g.node_adj[u][0]
            e2 = g.node_adj[u_rc][0]
            f1 = g.edge_cov(e1) / uni
            f2 = g.edge_cov(e2) / uni
            r1, r2 = _convert_cov_range(f1), _convert_cov_range(f2)
            long_enough = (g.edges[e1].seq_len >= MIN_CONTIG_READPAIR and
                           g.edges[e2].seq_len >= MIN_CONTIG_READPAIR)
            cov_ok = _check_coverage(f1, f2, r1, r2)
            if long_enough:
                ok = self.positive(e1, e2) == 1 and cov_ok
            else:
                ok = cov_ok
            if ok:
                g.join_edge(g.edges[e1].rc_id, e2)
                ret += 1
            else:
                g.isolate_edge(e1)
        return ret

    # -- jungle regions (resolve_complex) -----------------------------------
    def find_region(self, se: int, min_contig_len: int,
                    max_edge_count: int, genome_cov: float):
        """BFS region of short/repetitive edges around the seed edge
        (reference find_region, src/barcode_resolve2.c:93-129): expand
        through an edge's target only while the edge is short or looks
        repetitive; always include the rc node of each visited node."""
        g = self.g
        set_e = {se}
        start = g.node_rc[g.edges[se].source]
        set_v = {start}
        q = [start]
        li = 0
        while li < len(q):
            u = q[li]
            li += 1
            for e in g.node_adj[u]:
                set_e.add(e)
                ln = g.edges[e].seq_len
                rhi = _convert_cov_range(g.edge_cov(e) / genome_cov)[1]
                if ln < min_contig_len or (ln < MIN_CONTIG_BARCODE and rhi > 1):
                    t = g.edges[e].target
                    if t not in set_v:
                        if len(q) + 1 >= max_edge_count * 2:
                            return set_v, set_e
                        set_v.add(t)
                        q.append(t)
            if g.deg(u):
                ur = g.node_rc[u]
                if ur not in set_v:
                    if len(q) + 1 >= max_edge_count * 2:
                        return set_v, set_e
                    set_v.add(ur)
                    q.append(ur)
        return set_v, set_e

    def detect_leg(self, set_e, min_contig_len: int = MIN_LONG_CONTIG,
                   max_molecule_len: int = MAX_MOLECULE_LEN):
        """Legs = hang edges (rc outside the region) plus very long
        in-region edges; mid-length in-region edges are 'self' markers
        (reference detect_leg, src/barcode_resolve2.c:131-160)."""
        g = self.g
        set_leg, set_self = set(), set()
        for e in set_e:
            if g.edges[e].rc_id not in set_e:
                set_leg.add(e)
        for e in set_e:
            if e in set_leg:
                continue
            ln = g.edges[e].seq_len
            if ln >= max_molecule_len:
                set_leg.add(e)
                set_leg.add(g.edges[e].rc_id)
            elif ln >= min_contig_len:
                set_self.add(e)
        return set_leg, set_self

    def _path_exists(self, set_e, s: int, t: int) -> bool:
        """Reachability s->t using only region edges (reference
        get_dist_simple, src/barcode_resolve2.c)."""
        if s == t:
            return True
        g = self.g
        vis = {s}
        stack = [s]
        while stack:
            u = stack.pop()
            for e in g.node_adj[u]:
                if e not in set_e:
                    continue
                v = g.edges[e].target
                if v == t:
                    return True
                if v not in vis:
                    vis.add(v)
                    stack.append(v)
        return False

    def _find_pair_check_path(self, set_e, se: int, set_leg) -> int:
        """Best positive partner leg reachable through the region
        (reference bc_find_pair_check_path, barcode_resolve2.c:428-460)."""
        g = self.g
        ret_e = sec_e = -1
        s = g.node_rc[g.edges[se].source]
        for e in set_leg:
            if e == se or e == g.edges[se].rc_id:
                continue
            if self.positive(se, e) == 1 and \
                    self._path_exists(set_e, s, g.edges[e].source):
                if ret_e == -1 or self.greater(se, e, ret_e) == 1:
                    sec_e = ret_e
                    ret_e = e
                elif sec_e == -1 or self.greater(se, e, sec_e) == 1:
                    sec_e = e
        if ret_e == -1:
            return -1
        if sec_e != -1 and self.superior(se, ret_e, sec_e) != 1:
            return -2
        return ret_e

    def join_small_jungle(self, set_e, set_leg, uni_cov: float) -> int:
        """Pair legs across a small jungle by barcode support and join
        each pair over a 50-N gap (reference join_n_m_small_jungle,
        src/barcode_resolve2.c:1058-1118)."""
        g = self.g
        uni = self._calibrate(list(set_leg), uni_cov)
        ret = 0
        while True:
            resolve = 0
            for e1 in list(set_leg):
                if e1 not in set_leg:
                    continue
                f1 = g.edge_cov(e1) / uni
                r1 = _convert_cov_range(f1)
                e2 = self._find_pair_check_path(set_e, e1, set_leg)
                if e2 < 0:
                    continue
                f2 = g.edge_cov(e2) / uni
                r2 = _convert_cov_range(f2)
                if not _check_coverage(f1, f2, r1, r2):
                    continue
                et1 = self._find_pair_check_path(set_e, e2, set_leg)
                if et1 != -1 and et1 != e1:
                    continue
                g.join_edge_with_gap(g.edges[e1].rc_id, e2, 50)
                set_leg.discard(e1)
                set_leg.discard(e2)
                resolve += 1
            ret += resolve
            if not resolve:
                break
        return ret


def _mean_cov(g: MutableGraph) -> float:
    num = den = 0.0
    for e in range(g.n_e):
        ed = g.edges[e]
        if ed.source == -1:
            continue
        L = max(ed.seq_len - g.ksize, 1)
        num += g.edge_cov(e) * L
        den += L
    return num / den if den else 1.0


def _resolve_2_2_tier(mg: MutableGraph, res: BarcodeResolver,
                      check) -> int:
    """One strictness tier to its fixpoint, long-loop pass interleaved
    (reference resolve_2_2_bridge_{high,med,low}_strict,
    src/barcode_resolve2.c:1241-1310)."""
    uni = _mean_cov(mg)
    cnt = 0
    while True:
        cnt_local = 0
        for e in range(mg.n_e):
            if mg.edges[e].source == -1:
                continue
            ret = res.check_long_loop(e, uni)
            if ret == 0:
                cnt_local += check(e, uni)
            else:
                cnt_local += 1
        cnt += cnt_local
        if cnt_local == 0:
            return cnt


def resolve_n_m_simple(g: AsmGraph) -> AsmGraph:
    """Fixpoint over the three 2-2 strictness tiers (high -> med ->
    low), then condense (reference resolve_n_m_simple
    barcode_resolve2.c:1389-1406).

    Above the driver's vectorization threshold the worklist twin runs
    instead (resolve_n_m_simple_fast below — same call sequence behind
    an exact candidate gate); this full-rescan form is the oracle,
    equivalence-tested in tests/test_torch_barcodes.py."""
    from .driver import VEC_MIN_EDGES
    if g.n_e >= VEC_MIN_EDGES:
        return resolve_n_m_simple_fast(g)
    mg = MutableGraph.from_asm(g)
    res = BarcodeResolver(mg)
    while True:
        cnt = 0
        cnt += _resolve_2_2_tier(mg, res, res.check_2_2_high_strict)
        cnt += _resolve_2_2_tier(mg, res, res.check_2_2_med_strict)
        cnt += _resolve_2_2_tier(mg, res, res.check_2_2_low_strict)
        if cnt == 0:
            break
    return asm_condense(mg.to_asm())


def resolve_n_m_bridges(g: AsmGraph) -> AsmGraph:
    """General n-m bridge + n-m node passes + condense (reference
    collapse_n_m_bridge / collapse_n_m_node,
    src/barcode_resolve2.c:1312-1349).  Worklist twin dispatch as in
    resolve_n_m_simple."""
    from .driver import VEC_MIN_EDGES
    if g.n_e >= VEC_MIN_EDGES:
        return resolve_n_m_bridges_fast(g)
    mg = MutableGraph.from_asm(g)
    res = BarcodeResolver(mg)
    uni = _mean_cov(mg)
    for e in range(mg.n_e):
        if mg.edges[e].source == -1:
            continue
        res.check_n_m_bridge(e, uni)
    while True:
        cnt = 0
        for u in range(mg.n_v):
            cnt += res.check_n_m_node(u, uni)
        if cnt == 0:
            break
    return asm_condense(mg.to_asm())


def resolve_complex(g: AsmGraph) -> AsmGraph:
    """Jungle pass: bounded BFS regions around long seed contigs, leg
    detection, barcode-paired joins over 50-N gaps, condense (reference
    resolve_complex, src/barcode_resolve2.c:1419-1456 — the build_4_5
    stage, process.c:238-246)."""
    mg = MutableGraph.from_asm(g)
    res = BarcodeResolver(mg)
    uni = _mean_cov(mg)
    visited = set()
    for e in range(mg.n_e):
        if mg.edges[e].source == -1 or e in visited:
            continue
        if mg.edges[e].seq_len < MIN_CONTIG_BARCODE:
            continue
        set_v, set_e = res.find_region(e, MIN_CONTIG_BARCODE,
                                       MAX_EDGE_COUNT, uni)
        if len(set_e) < MAX_EDGE_COUNT:
            visited |= set_e
            set_leg, set_self = res.detect_leg(set_e)
            if len(set_self) == 0 and len(set_leg) >= 2:
                res.join_small_jungle(set_e, set_leg, uni)
    return asm_condense(mg.to_asm())

# ---------------------------------------------------------------------------
# worklist drivers: the fixpoint loops above rescan every
# edge (or node) per round; at metagenome scale (1e5-1e6 edges) that full
# python scan IS the wall even though almost every edge fails the cheap
# topology gate.  These drivers visit only edges/nodes that can possibly
# act, and re-visit exactly the neighborhood each mutation can influence
# (via MutableGraph.touch_log) — provably the same call sequence outcome
# as the full rescans, because a check on an untouched non-candidate is
# deterministic and side-effect-free.
# ---------------------------------------------------------------------------

def _gate_2_2(mg: MutableGraph, e: int) -> bool:
    """Union of the cheap topology gates of check_long_loop and the
    three check_2_2 tiers: any edge failing this returns 0 from BOTH
    without mutating (reference deg gates, barcode_resolve2.c:534-553
    and :1119-1133)."""
    ed = mg.edges[e]
    if ed.source == -1:
        return False
    u, v = ed.source, ed.target
    return (mg.deg(u) == 1 and mg.deg(mg.node_rc[v]) == 1
            and mg.deg(mg.node_rc[u]) <= 2 and mg.deg(v) <= 2)


def _dirty_edges(mg: MutableGraph, nodes) -> set:
    """Edges whose check outcome a mutation touching `nodes` can change:
    every edge incident (as source/target, either strand) to a touched
    node or its rc — the checks read only the distance-1 neighborhood of
    an edge's endpoints (legs' length/coverage/barcodes)."""
    out = set()
    for w in nodes:
        if not (0 <= w < mg.n_v):
            continue
        for x in (w, mg.node_rc[w]):
            for e in mg.node_adj[x]:
                out.add(e)
                out.add(mg.edges[e].rc_id)
    return out


def _resolve_2_2_tier_fast(mg: MutableGraph, res: BarcodeResolver,
                           check, cand: set) -> int:
    """Worklist twin of _resolve_2_2_tier: same per-edge call pair
    (check_long_loop then `check`) in the same ascending-id round order,
    but each round visits only gated candidates; mutations re-enqueue
    their dirty neighborhood (later ids continue this round, earlier or
    brand-new ids wait for the next round — exactly when the full rescan
    would reach them).  `cand` is the maintained candidate superset,
    shared across tiers."""
    import heapq

    uni = _mean_cov(mg)
    cnt = 0
    pending = sorted(e for e in cand if _gate_2_2(mg, e))
    while True:
        cnt_local = 0
        n_round = mg.n_e
        heap = list(pending)
        heapq.heapify(heap)
        seen = set()
        nxt = set()
        while heap:
            e = heapq.heappop(heap)
            if e in seen:
                continue
            seen.add(e)
            if not _gate_2_2(mg, e):
                cand.discard(e)
                continue
            mg.touch_log = set()
            ret = res.check_long_loop(e, uni)
            if ret == 0:
                c = check(e, uni)
            else:
                c = 1
            touched = mg.touch_log
            mg.touch_log = None
            cnt_local += c
            if touched:
                for d in _dirty_edges(mg, touched):
                    cand.add(d)
                    if d >= n_round or d <= e or d in seen:
                        nxt.add(d)
                    else:
                        heapq.heappush(heap, d)
                # the acted-on edge itself re-enters the next round (the
                # full rescan would revisit it)
                nxt.add(e)
        cnt += cnt_local
        if cnt_local == 0:
            return cnt
        pending = sorted(d for d in nxt if _gate_2_2(mg, d))
        for d in list(nxt):
            if not _gate_2_2(mg, d):
                cand.discard(d)


def resolve_n_m_simple_fast(g: AsmGraph) -> AsmGraph:
    """Worklist twin of resolve_n_m_simple — oracle-equal (the oracle's
    full per-round rescans only ever act on edges passing _gate_2_2, and
    untouched edges repeat their previous outcome)."""
    mg = MutableGraph.from_asm(g)
    res = BarcodeResolver(mg)
    cand = {e for e in range(mg.n_e) if _gate_2_2(mg, e)}
    while True:
        cnt = 0
        cnt += _resolve_2_2_tier_fast(mg, res, res.check_2_2_high_strict, cand)
        cnt += _resolve_2_2_tier_fast(mg, res, res.check_2_2_med_strict, cand)
        cnt += _resolve_2_2_tier_fast(mg, res, res.check_2_2_low_strict, cand)
        if cnt == 0:
            break
    return asm_condense(mg.to_asm())


def _gate_n_m_bridge(mg: MutableGraph, e: int) -> bool:
    """check_n_m_bridge's entry gate (barcode_resolve2.c:819-836)."""
    ed = mg.edges[e]
    if ed.source == -1:
        return False
    u, v = ed.source, ed.target
    return (mg.deg(u) == 1 and mg.deg(mg.node_rc[v]) == 1
            and (mg.deg(mg.node_rc[u]) >= 2 or mg.deg(v) >= 2))


def _gate_n_m_node(mg: MutableGraph, u: int) -> bool:
    """check_n_m_node acts only when both orientations have live edges
    and either (a) both sides own a >=CONTIG_USE_BARCODE leg (the pairing
    loop can fire) or (b) the node is 1-1 (the leftover join/isolate
    branch fires unconditionally)."""
    u_rc = mg.node_rc[u]
    if u == u_rc or mg.deg(u) == 0 or mg.deg(u_rc) == 0:
        return False
    if mg.deg(u) == 1 and mg.deg(u_rc) == 1:
        return True
    long1 = any(mg.edges[x].seq_len >= CONTIG_USE_BARCODE
                for x in mg.node_adj[u_rc])
    long2 = any(mg.edges[x].seq_len >= CONTIG_USE_BARCODE
                for x in mg.node_adj[u])
    return long1 and long2


def resolve_n_m_bridges_fast(g: AsmGraph) -> AsmGraph:
    """Worklist twin of resolve_n_m_bridges: the single bridge scan
    visits each edge id at most once in ascending order (mutations can
    promote later ids into candidacy — they are folded into the scan;
    earlier ids are never revisited, as in the oracle's one-shot
    range(n_e) loop), then the node fixpoint runs dirty-node rounds."""
    import heapq

    mg = MutableGraph.from_asm(g)
    res = BarcodeResolver(mg)
    uni = _mean_cov(mg)

    n0 = mg.n_e
    heap = [e for e in range(n0) if _gate_n_m_bridge(mg, e)]
    heapq.heapify(heap)
    seen = set()
    while heap:
        e = heapq.heappop(heap)
        if e in seen:
            continue
        seen.add(e)
        if mg.edges[e].source == -1 or not _gate_n_m_bridge(mg, e):
            continue
        mg.touch_log = set()
        res.check_n_m_bridge(e, uni)
        touched = mg.touch_log
        mg.touch_log = None
        if touched:
            for d in _dirty_edges(mg, touched):
                if d > e and d < n0 and d not in seen:
                    heapq.heappush(heap, d)

    # node fixpoint: rounds over dirty gated nodes
    pending = sorted(u for u in range(mg.n_v) if _gate_n_m_node(mg, u))
    while True:
        cnt_local = 0
        n_round = mg.n_v
        heap = list(pending)
        heapq.heapify(heap)
        seen = set()
        nxt = set()
        while heap:
            u = heapq.heappop(heap)
            if u in seen:
                continue
            seen.add(u)
            if not _gate_n_m_node(mg, u):
                continue
            mg.touch_log = set()
            c = res.check_n_m_node(u, uni)
            touched = mg.touch_log
            mg.touch_log = None
            cnt_local += c
            if touched:
                dn = set()
                for w in touched:
                    if 0 <= w < mg.n_v:
                        dn.add(w)
                        dn.add(mg.node_rc[w])
                # a node check reads its legs (distance-1): a mutation
                # at node w can change checks at w, rc(w), and the far
                # endpoints of edges incident to either
                for w in list(dn):
                    for e in mg.node_adj[w]:
                        t = mg.edges[e].target
                        dn.add(t)
                        dn.add(mg.node_rc[t])
                for d in dn:
                    if d >= n_round or d <= u or d in seen:
                        nxt.add(d)
                    else:
                        heapq.heappush(heap, d)
                nxt.add(u)
        if cnt_local == 0:
            break
        pending = sorted(d for d in nxt if d < mg.n_v)
    return asm_condense(mg.to_asm())
