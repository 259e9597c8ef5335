"""SPAdes .fastg graph loader — rebuild of src/fastg.c (load path :210);
a copy of turingassembler_tpu/io/fastg.py (host code).

FASTG records look like
  >EDGE_3_length_100_cov_28.1:EDGE_5_length_80_cov_30.2',EDGE_7_...;
  ACGT...
where the primed form denotes the reverse-complement orientation and
the colon list gives successor edges.  We materialize every edge plus
its rc partner, restore adjacency via shared endpoint nodes, and emit a
standard AsmGraph.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from ..graph.structs import AsmGraph
from .fastq import NT4

_HDR = re.compile(r"EDGE_(\d+)_length_(\d+)_cov_([\d.]+)(')?")


def parse_fastg(path: str):
    """Yield (edge_id, is_rc, length, cov, successors[(id, is_rc)], seq)."""
    name = None
    succ: List[Tuple[int, bool]] = []
    this = None
    chunks: List[str] = []
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if this is not None:
                    yield (*this, succ, "".join(chunks))
                body = line[1:].rstrip(";")
                if ":" in body:
                    head, rest = body.split(":", 1)
                    succ = []
                    for tok in rest.split(","):
                        m = _HDR.search(tok)
                        if m:
                            succ.append((int(m.group(1)), bool(m.group(4))))
                else:
                    head, succ = body, []
                m = _HDR.search(head)
                if not m:
                    raise ValueError(f"bad fastg header: {line}")
                this = (int(m.group(1)), bool(m.group(4)),
                        int(m.group(2)), float(m.group(3)))
                chunks = []
            else:
                chunks.append(line)
    if this is not None:
        yield (*this, succ, "".join(chunks))


def load_fastg(path: str, ksize: int) -> AsmGraph:
    fw_seq: Dict[int, str] = {}
    cov: Dict[int, float] = {}
    succs: Dict[Tuple[int, bool], List[Tuple[int, bool]]] = {}
    for eid, is_rc, length, c, succ, seq in parse_fastg(path):
        if not is_rc:
            fw_seq[eid] = seq
            cov[eid] = c
        succs[(eid, is_rc)] = succ

    ids = sorted(fw_seq)
    idx = {eid: i for i, eid in enumerate(ids)}
    n = len(ids)
    g = AsmGraph(ksize=ksize)
    # 2 edges + 4 nodes per record; adjacency merged below by unioning
    # endpoints: edge (i, o) ends at node that is the start of each succ
    # — SPAdes fastg edges overlap by k, so shared endpoints are implied
    # by the successor lists.  We create per-directed-edge endpoints and
    # merge them with union-find.
    parent = list(range(4 * n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    def src_node(i, o):   # provisional endpoint ids
        return 4 * i + (0 if not o else 3)

    def tgt_node(i, o):
        return 4 * i + (1 if not o else 2)

    # fw edge i: src 4i, tgt 4i+1; rc edge i: src 4i+2... keep rc pairing:
    # rc(src(fw)) == tgt(rc), rc(tgt(fw)) == src(rc)
    for (eid, is_rc), succ in succs.items():
        i = idx.get(eid)
        if i is None:
            continue
        for seid, s_rc in succ:
            j = idx.get(seid)
            if j is None:
                continue
            union(tgt_node(i, is_rc), src_node(j, s_rc))
            # mirror for rc orientation
            union(tgt_node(j, not s_rc), src_node(i, not is_rc))

    roots = sorted({find(x) for x in range(4 * n)})
    rid = {r: i for i, r in enumerate(roots)}

    def node_of(x):
        return rid[find(x)]

    n_v = len(roots)
    node_rc = np.full(n_v, -1, np.int64)
    for i in range(n):
        a, b = node_of(src_node(i, False)), node_of(tgt_node(i, True))
        node_rc[a], node_rc[b] = b, a
        a, b = node_of(tgt_node(i, False)), node_of(src_node(i, True))
        node_rc[a], node_rc[b] = b, a

    seqs = []
    g.edge_source = np.zeros(2 * n, np.int64)
    g.edge_target = np.zeros(2 * n, np.int64)
    g.edge_rc = np.zeros(2 * n, np.int64)
    g.edge_count = np.zeros(2 * n, np.int64)
    for i, eid in enumerate(ids):
        codes = NT4[np.frombuffer(fw_seq[eid].encode(), np.uint8)]
        seqs.append(codes)
        seqs.append((3 - np.minimum(codes, 3))[::-1].astype(np.uint8))
        fwid, rcid = 2 * i, 2 * i + 1
        g.edge_source[fwid] = node_of(src_node(i, False))
        g.edge_target[fwid] = node_of(tgt_node(i, False))
        g.edge_source[rcid] = node_of(src_node(i, True))
        g.edge_target[rcid] = node_of(tgt_node(i, True))
        g.edge_rc[fwid], g.edge_rc[rcid] = rcid, fwid
        cnt = int(cov[eid] * max(len(codes) - ksize, 1))
        g.edge_count[fwid] = g.edge_count[rcid] = cnt
    g.node_rc = node_rc
    lens = np.array([len(s) for s in seqs], np.int64)
    g.seq_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    g.seq_data = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    g.rebuild_adjacency()
    return g
