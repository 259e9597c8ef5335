"""Flat struct-of-arrays assembly graph (a copy of
turingassembler_tpu/graph/structs.py: the port imports nothing of the
JAX package, and its level-0 build returns this host-side numpy form).

Reference model (src/assembly_graph.h:52-95): nodes carry an rc link and
an out-edge list; edges carry 2-bit packed sequence, k-mer count, N-gap
"holes", source/target/rc ids.  Edges and nodes always come in
reverse-complement pairs; removing an edge tombstones `source = -1`
(src/assembly_graph.c:692).

Here the same model is struct-of-arrays over numpy so that predicates
(tip detection, coverage ratios, ...) vectorize, and so the arrays can be
shipped to the device untouched.  Sequences live in one flat uint8 base
pool (codes 0..3) with per-edge [offset, offset+len) spans; holes are a
sparse per-edge dict (rare until scaffolding).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class AsmGraph:
    ksize: int
    # nodes
    node_rc: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    adj_off: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    adj_list: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # edges
    edge_source: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    edge_target: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    edge_rc: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    edge_count: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    seq_off: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    seq_data: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    # N-gap holes: edge id -> (p_holes, l_holes) arrays
    holes: Dict[int, Tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    # aux (filled by barcode stages); edge id -> structures
    aux_flag: int = 0
    barcodes: Optional[list] = None        # per-edge [lvl0, lvl1, lvl2] barcode sets
    barcodes_scaf: Optional[list] = None
    barcodes_cov: Optional[list] = None
    candidates: Dict[Tuple[int, int], Tuple[int, int]] = field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def n_v(self) -> int:
        return len(self.node_rc)

    @property
    def n_e(self) -> int:
        return len(self.edge_source)

    def edge_len(self, e=None) -> np.ndarray:
        if e is None:
            return self.seq_off[1:] - self.seq_off[:-1]
        e = np.asarray(e)
        return self.seq_off[e + 1] - self.seq_off[e]

    def edge_lens_with_holes(self) -> np.ndarray:
        """Sequence length including N-gap hole lengths (reference
        get_edge_len semantics: seq_len + sum l_holes)."""
        lens = self.edge_len().copy()
        for e, (_, lh) in self.holes.items():
            lens[e] += int(lh.sum())
        return lens

    def get_seq(self, e: int) -> np.ndarray:
        return self.seq_data[self.seq_off[e] : self.seq_off[e + 1]]

    def get_seq_str(self, e: int) -> str:
        """Sequence with N-holes expanded, as an ACGTN string."""
        seq = self.get_seq(e)
        if e not in self.holes:
            return ACGT[seq].tobytes().decode()
        ph, lh = self.holes[e]
        parts = []
        prev = 0
        for p, l in zip(ph, lh):
            parts.append(ACGT[seq[prev : p + 1]].tobytes().decode())
            parts.append("N" * int(l))
            prev = p + 1
        parts.append(ACGT[seq[prev:]].tobytes().decode())
        return "".join(parts)

    def node_deg(self) -> np.ndarray:
        return self.adj_off[1:] - self.adj_off[:-1]

    def node_adj(self, u: int) -> np.ndarray:
        return self.adj_list[self.adj_off[u] : self.adj_off[u + 1]]

    def edge_cov(self, e=None) -> np.ndarray:
        """Coverage = count / (seq_len - (n_holes+1)*ksize) (reference
        __get_edge_cov macro, src/assembly_graph.h:190-191)."""
        lens = self.edge_len().astype(np.float64)
        cnt = self.edge_count.astype(np.float64)
        nh = np.zeros_like(lens)
        for ee, (ph, _) in self.holes.items():
            nh[ee] = len(ph)
        denom = np.maximum(lens - (nh + 1) * self.ksize, 1.0)
        cov = cnt / denom
        return cov if e is None else cov[e]

    def alive_mask(self) -> np.ndarray:
        return self.edge_source >= 0

    # ------------------------------------------------------------------
    def clone(self) -> "AsmGraph":
        g = AsmGraph(ksize=self.ksize)
        for f in ("node_rc", "adj_off", "adj_list", "edge_source", "edge_target",
                  "edge_rc", "edge_count", "seq_off", "seq_data"):
            setattr(g, f, getattr(self, f).copy())
        g.holes = {e: (p.copy(), l.copy()) for e, (p, l) in self.holes.items()}
        g.aux_flag = self.aux_flag
        # aux barcode tables ride along (aux_flag already does): a clone
        # that silently drops them makes every barcode pass a no-op
        if self.barcodes is not None:
            g.barcodes = [[dict(t) for t in sets] for sets in self.barcodes]
        if self.barcodes_scaf is not None:
            g.barcodes_scaf = [dict(t) for t in self.barcodes_scaf]
        if self.barcodes_cov is not None:
            g.barcodes_cov = [dict(t) for t in self.barcodes_cov]
        return g

    def rebuild_adjacency(self) -> None:
        """Recompute node adjacency (CSR) from live edge sources."""
        alive = self.alive_mask()
        src = self.edge_source[alive]
        eids = np.flatnonzero(alive)
        order = np.argsort(src, kind="stable")
        src_s, eids_s = src[order], eids[order]
        deg = np.bincount(src_s, minlength=self.n_v).astype(np.int64)
        self.adj_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
        self.adj_list = eids_s.astype(np.int64)

    def remove_edge(self, e: int) -> None:
        """Tombstone edge e and its RC (reference asm_remove_edge,
        src/assembly_graph.c:692: source=-1; adjacency rebuilt later)."""
        self.edge_source[e] = -1
        rc = self.edge_rc[e]
        if rc >= 0:
            self.edge_source[rc] = -1

    def mean_coverage(self) -> float:
        """Length-weighted mean unit coverage over live edges (reference
        get_genome_coverage, src/assembly_graph.c)."""
        alive = self.alive_mask()
        lens = self.edge_len()[alive].astype(np.float64) - self.ksize
        lens = np.maximum(lens, 1.0)
        cov = self.edge_cov()[alive]
        keep = lens > 0
        if keep.sum() == 0:
            return 0.0
        return float((cov * lens).sum() / lens.sum())


def from_edge_list(ksize: int, edges: List[dict], n_v: int, node_rc: np.ndarray) -> AsmGraph:
    """Build an AsmGraph from a python list of edge dicts
    {source, target, rc_id, count, seq(np.uint8 codes), holes?}."""
    g = AsmGraph(ksize=ksize)
    g.node_rc = np.asarray(node_rc, np.int64)
    n_e = len(edges)
    g.edge_source = np.array([e["source"] for e in edges], np.int64) if n_e else np.zeros(0, np.int64)
    g.edge_target = np.array([e["target"] for e in edges], np.int64) if n_e else np.zeros(0, np.int64)
    g.edge_rc = np.array([e["rc_id"] for e in edges], np.int64) if n_e else np.zeros(0, np.int64)
    g.edge_count = np.array([e["count"] for e in edges], np.int64) if n_e else np.zeros(0, np.int64)
    seqs = [np.asarray(e["seq"], np.uint8) for e in edges]
    lens = np.array([len(s) for s in seqs], np.int64)
    g.seq_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    g.seq_data = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    for i, e in enumerate(edges):
        if e.get("holes"):
            ph, lh = e["holes"]
            g.holes[i] = (np.asarray(ph, np.int64), np.asarray(lh, np.int64))
    g.rebuild_adjacency()
    return g
