"""Mutable graph for the simplification ("resolve") stages.

The reference freely splices edges in place (asm_join_edge / clone /
unroll, src/assembly_graph.c:219-710).  Post-level-0 graphs are small
(thousands of edges), so these passes run host-side on a python/numpy
mutable structure; the flat AsmGraph (structs.py) remains the interchange
format and is re-materialized by condense.

Edge sequences are uint8 code arrays; holes are [(p, l)] lists with the
reference's convention: hole i starts right after seq position p_holes[i]
(src/assembly_graph.h:60-66).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .structs import AsmGraph


class MEdge:
    __slots__ = ("source", "target", "rc_id", "count", "seq", "holes",
                 "barcodes", "barcodes_scaf", "barcodes_cov")

    def __init__(self, source, target, rc_id, count, seq, holes=None):
        self.source = source
        self.target = target
        self.rc_id = rc_id
        self.count = count
        self.seq = seq                    # np.uint8 codes
        self.holes = holes or []          # [(p, l)]
        self.barcodes = None              # [lvl0, lvl1, lvl2] dicts
        self.barcodes_scaf = None
        self.barcodes_cov = None

    @property
    def seq_len(self) -> int:
        return len(self.seq)

    def full_len(self) -> int:
        return len(self.seq) + sum(l for _, l in self.holes)


class MutableGraph:
    def __init__(self, ksize: int):
        self.ksize = ksize
        self.node_rc: List[int] = []
        self.node_adj: List[List[int]] = []
        self.edges: List[MEdge] = []
        self.aux_flag = 0
        # optional mutation journal: when a caller assigns a set here,
        # every mutating method records the endpoint nodes of every edge
        # it touches (pre- and post-state).  The worklist resolve loops
        # (resolve/barcodes.py fast paths) use it to re-check exactly the
        # neighborhood a mutation can influence instead of rescanning
        # every edge per fixpoint round.
        self.touch_log: Optional[set] = None

    def _touch_e(self, e: int) -> None:
        if self.touch_log is not None and 0 <= e < len(self.edges):
            ed = self.edges[e]
            if ed.source != -1:
                self.touch_log.add(ed.source)
            if ed.target != -1:
                self.touch_log.add(ed.target)

    # ------------------------------------------------------------------
    @classmethod
    def from_asm(cls, g: AsmGraph) -> "MutableGraph":
        mg = cls(g.ksize)
        mg.aux_flag = g.aux_flag
        mg.node_rc = [int(x) for x in g.node_rc]
        mg.node_adj = [[int(e) for e in g.node_adj(u)] for u in range(g.n_v)]
        for e in range(g.n_e):
            me = MEdge(int(g.edge_source[e]), int(g.edge_target[e]),
                       int(g.edge_rc[e]), int(g.edge_count[e]),
                       g.get_seq(e).copy(),
                       [(int(p), int(l)) for p, l in zip(*g.holes[e])] if e in g.holes else [])
            if g.barcodes is not None:
                me.barcodes = [dict(t) for t in g.barcodes[e]]
            if g.barcodes_scaf is not None:
                me.barcodes_scaf = dict(g.barcodes_scaf[e])
            if g.barcodes_cov is not None:
                me.barcodes_cov = dict(g.barcodes_cov[e])
            mg.edges.append(me)
        return mg

    def to_asm(self) -> AsmGraph:
        g = AsmGraph(ksize=self.ksize)
        g.aux_flag = self.aux_flag
        n_v, n_e = len(self.node_rc), len(self.edges)
        g.node_rc = np.asarray(self.node_rc, np.int64) if n_v else np.zeros(0, np.int64)
        g.edge_source = np.array([e.source for e in self.edges], np.int64) if n_e else np.zeros(0, np.int64)
        g.edge_target = np.array([e.target for e in self.edges], np.int64) if n_e else np.zeros(0, np.int64)
        g.edge_rc = np.array([e.rc_id for e in self.edges], np.int64) if n_e else np.zeros(0, np.int64)
        g.edge_count = np.array([e.count for e in self.edges], np.int64) if n_e else np.zeros(0, np.int64)
        seqs = [e.seq if e.source != -1 else np.zeros(0, np.uint8) for e in self.edges]
        lens = np.array([len(s) for s in seqs], np.int64)
        g.seq_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        g.seq_data = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
        for i, e in enumerate(self.edges):
            if e.holes and e.source != -1:
                g.holes[i] = (np.array([p for p, _ in e.holes], np.int64),
                              np.array([l for _, l in e.holes], np.int64))
        if any(e.barcodes is not None for e in self.edges):
            g.barcodes = [e.barcodes or [{}, {}, {}] for e in self.edges]
            g.barcodes_scaf = [e.barcodes_scaf or {} for e in self.edges]
            g.barcodes_cov = [e.barcodes_cov or {} for e in self.edges]
        g.rebuild_adjacency()
        return g

    # ------------------------------------------------------------------
    @property
    def n_v(self) -> int:
        return len(self.node_rc)

    @property
    def n_e(self) -> int:
        return len(self.edges)

    def deg(self, u: int) -> int:
        return len(self.node_adj[u])

    def edge_cov(self, e: int) -> float:
        """__get_edge_cov (reference src/assembly_graph.h:190-191)."""
        ed = self.edges[e]
        denom = ed.seq_len - (len(ed.holes) + 1) * self.ksize
        return ed.count / denom if denom > 0 else float(ed.count)

    def create_node(self) -> int:
        """Append a node pair (u, u_rc); return u (reference
        asm_create_node src/assembly_graph.c:219-229)."""
        u = len(self.node_rc)
        self.node_rc += [u + 1, u]
        self.node_adj += [[], []]
        return u

    def remove_edge(self, e: int) -> None:
        """Tombstone e, dropping it from its source's adjacency
        (reference asm_remove_edge src/assembly_graph.c:692-704)."""
        ed = self.edges[e]
        if ed.source == -1:
            return
        self._touch_e(e)
        adj = self.node_adj[ed.source]
        if e in adj:
            adj.remove(e)
        ed.source = ed.target = -1
        ed.seq = np.zeros(0, np.uint8)
        ed.holes = []

    def remove_edge_pair(self, e: int) -> None:
        rc = self.edges[e].rc_id
        self.remove_edge(e)
        self.remove_edge(rc)

    # -- sequence surgery ------------------------------------------------
    def append_seq(self, dst: int, src: int, overlap: int) -> None:
        """dst.seq += src.seq[overlap:], shifting src holes (reference
        asm_append_seq src/assembly_graph.c:466-500)."""
        d, s = self.edges[dst], self.edges[src]
        off = d.seq_len - overlap
        d.holes = d.holes + [(p + off, l) for p, l in s.holes]
        d.seq = np.concatenate([d.seq, s.seq[overlap:]])

    def append_seq_with_gap(self, dst: int, src: int, gap: int) -> None:
        """reference asm_append_seq_with_gap src/assembly_graph.c:300-330."""
        d, s = self.edges[dst], self.edges[src]
        holes = d.holes + [(d.seq_len - 1, gap)]
        holes += [(p + d.seq_len, l) for p, l in s.holes]
        d.holes = holes
        d.seq = np.concatenate([d.seq, s.seq])

    def clone_edge_pair(self, src: int) -> int:
        """Append clones of src and rc(src) as a new rc pair; returns new
        id (reference asm_create_clone_edge src/assembly_graph.c:286-298)."""
        s = self.edges[src]
        s_rc = self.edges[s.rc_id]
        self._touch_e(src)
        p = len(self.edges)
        q = p + 1
        self.edges.append(MEdge(s.source, s.target, q, s.count, s.seq.copy(), list(s.holes)))
        self.edges.append(MEdge(s_rc.source, s_rc.target, p, s_rc.count, s_rc.seq.copy(), list(s_rc.holes)))
        self.node_adj[s.source].append(p)
        self.node_adj[s_rc.source].append(q)
        return p

    def join_edge(self, e1: int, e2: int) -> None:
        """Merge e1->e2 over k-overlap; survivors are e1 and rc(e2)
        (reference asm_join_edge src/assembly_graph.c:527-553)."""
        e_rc1 = self.edges[e1].rc_id
        e_rc2 = self.edges[e2].rc_id
        self._touch_e(e1)
        self._touch_e(e2)
        self.append_seq(e1, e2, self.ksize)
        self.edges[e1].target = self.edges[e2].target
        self.edges[e1].count += self.edges[e2].count
        self.append_seq(e_rc2, e_rc1, self.ksize)
        self.edges[e_rc2].target = self.edges[e_rc1].target
        self.edges[e_rc2].count += self.edges[e_rc1].count
        self.edges[e1].rc_id = e_rc2
        self.edges[e_rc2].rc_id = e1
        self.remove_edge(e2)
        self.remove_edge(e_rc1)

    def join_edge_with_gap(self, e1: int, e2: int, gap: int) -> None:
        """reference asm_join_edge_with_gap src/assembly_graph.c:502-525."""
        e_rc1 = self.edges[e1].rc_id
        e_rc2 = self.edges[e2].rc_id
        self._touch_e(e1)
        self._touch_e(e2)
        self.append_seq_with_gap(e1, e2, gap)
        self.edges[e1].target = self.edges[e2].target
        self.edges[e1].count += self.edges[e2].count
        self.append_seq_with_gap(e_rc2, e_rc1, gap)
        self.edges[e_rc2].target = self.edges[e_rc1].target
        self.edges[e_rc2].count += self.edges[e_rc1].count
        self.edges[e1].rc_id = e_rc2
        self.edges[e_rc2].rc_id = e1
        self.remove_edge(e2)
        self.remove_edge(e_rc1)

    def join_edge3(self, e1: int, e2: int, e3: int, e2_count: int) -> None:
        """Join e1 + e2 + e3 with k-overlaps; e2 (the repeat) contributes
        e2_count to both strands (reference asm_join_edge3,
        src/assembly_graph.c:600-630).  Survivors: e1 and rc(e3)."""
        e_rc1 = self.edges[e1].rc_id
        e_rc2 = self.edges[e2].rc_id
        e_rc3 = self.edges[e3].rc_id
        self._touch_e(e1)
        self._touch_e(e2)
        self._touch_e(e3)
        self.append_seq(e1, e2, self.ksize)
        self.append_seq(e1, e3, self.ksize)
        self.edges[e1].target = self.edges[e3].target
        self.edges[e1].count += self.edges[e3].count + e2_count
        self.append_seq(e_rc3, e_rc2, self.ksize)
        self.append_seq(e_rc3, e_rc1, self.ksize)
        self.edges[e_rc3].target = self.edges[e_rc1].target
        self.edges[e_rc3].count += self.edges[e_rc1].count + e2_count
        self.edges[e1].rc_id = e_rc3
        self.edges[e_rc3].rc_id = e1
        self.remove_edge(e3)
        self.remove_edge(e_rc1)

    def isolate_edge(self, e: int) -> None:
        """Detach edge e from its source onto a fresh node (reference
        isolate_edge, src/barcode_resolve2.c:936-945)."""
        self._touch_e(e)
        src = self.edges[e].source
        if e in self.node_adj[src]:
            self.node_adj[src].remove(e)
        n = self.create_node()
        self.edges[e].source = n
        self.node_adj[n] = [e]
        self.edges[self.edges[e].rc_id].target = self.node_rc[n]
        if self.touch_log is not None:
            self.touch_log.add(n)

    def join_edge_with_fill(self, e1: int, e2: int, fill: np.ndarray,
                            trim_e1: int = 0, trim_e2: int = 0) -> None:
        """Join e1 and e2 with an explicit fill sequence between them,
        trimming trim_e1 bases from e1's tail and trim_e2 from e2's head
        (reference asm_join_edge_with_fill src/assembly_graph.c:381-400;
        used when a local-assembly path supplies the joining sequence)."""
        e_rc1 = self.edges[e1].rc_id
        e_rc2 = self.edges[e2].rc_id
        self._touch_e(e1)
        self._touch_e(e2)
        d1, d2 = self.edges[e1], self.edges[e2]
        r1, r2 = self.edges[e_rc1], self.edges[e_rc2]
        fill = np.asarray(fill, np.uint8)
        d1.seq = np.concatenate([
            d1.seq[: d1.seq_len - trim_e1], fill, d2.seq[trim_e2:]])
        d1.target = d2.target
        d1.count += d2.count
        rc_fill = (3 - fill)[::-1]
        r2.seq = np.concatenate([
            r2.seq[: r2.seq_len - trim_e2], rc_fill, r1.seq[trim_e1:]])
        r2.target = r1.target
        r2.count += r1.count
        d1.rc_id = e_rc2
        r2.rc_id = e1
        self.remove_edge(e2)
        self.remove_edge(e_rc1)

    def unroll_loop_forward(self, e1: int, e2: int, rep: int) -> None:
        """Append (e2 + original-e1) rep times to e1, capped at 2000 bp;
        add e2's count once (reference asm_unroll_loop_forward
        src/assembly_graph.c:555-574)."""
        self._touch_e(e1)
        self._touch_e(e2)
        orig_seq = self.edges[e1].seq.copy()
        orig_holes = list(self.edges[e1].holes)
        clone = MEdge(-2, -2, -2, 0, orig_seq, orig_holes)
        tmp_id = len(self.edges)
        self.edges.append(clone)
        for _ in range(rep):
            self.append_seq(e1, e2, self.ksize)
            self.append_seq(e1, tmp_id, self.ksize)
            if self.edges[e1].seq_len >= 2000:
                break
        self.edges[e1].count += self.edges[e2].count
        self.edges.pop()
