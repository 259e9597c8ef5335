"""Build an AsmGraph from bare contig sequences (a copy of
turingassembler_tpu/graph/from_contigs.py; host code).

Rebuild of load_asm_graph_fasta (reference src/assembly_graph.c:1406):
each FASTA record becomes an rc edge pair with fresh endpoint nodes and
no adjacency links — the shape the barcode/scaffold stages consume after
read-pair extension (build_barcode_process_fasta, process.c:787).
Counts default to seq length (cov 1) and are replaced by the k=31
coverage recount stage.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from ..io.fastq import NT4
from .structs import AsmGraph


def graph_from_contigs(seqs: Iterable[bytes | str | np.ndarray],
                       ksize: int,
                       counts: Optional[List[int]] = None) -> AsmGraph:
    g = AsmGraph(ksize=ksize)
    codes: List[np.ndarray] = []
    for s in seqs:
        if isinstance(s, str):
            s = s.encode()
        if isinstance(s, (bytes, bytearray)):
            s = NT4[np.frombuffer(bytes(s), np.uint8)]
        codes.append(np.asarray(s, np.uint8))
    n = len(codes)
    seq_list: List[np.ndarray] = []
    node_rc = np.zeros(4 * n, np.int64)
    edge_source = np.zeros(2 * n, np.int64)
    edge_target = np.zeros(2 * n, np.int64)
    edge_rc = np.zeros(2 * n, np.int64)
    edge_count = np.zeros(2 * n, np.int64)
    for i, seq in enumerate(codes):
        fw, rc = 2 * i, 2 * i + 1
        # nodes: a=4i, b=4i+1, rc(a)=4i+2, rc(b)=4i+3
        a, b, a_rc, b_rc = 4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3
        node_rc[a], node_rc[a_rc] = a_rc, a
        node_rc[b], node_rc[b_rc] = b_rc, b
        edge_source[fw], edge_target[fw] = a, b
        edge_source[rc], edge_target[rc] = b_rc, a_rc
        edge_rc[fw], edge_rc[rc] = rc, fw
        # holes: N bases (code 4) clamp to code-level holes? store Ns as
        # arbitrary base with a hole record
        cnt = counts[i] if counts else max(len(seq) - ksize, 1)
        edge_count[fw] = edge_count[rc] = cnt
        clean, holes = _split_holes(seq)
        seq_list.append((clean, holes))
    g.node_rc = node_rc
    g.edge_source, g.edge_target = edge_source, edge_target
    g.edge_rc, g.edge_count = edge_rc, edge_count
    flat: List[np.ndarray] = []
    lens = []
    for i, (clean, holes) in enumerate(seq_list):
        rc_clean = (3 - clean)[::-1]
        flat.append(clean)
        flat.append(rc_clean)
        lens += [len(clean), len(clean)]
        if holes:
            ph = np.array([p for p, _ in holes], np.int64)
            lh = np.array([l for _, l in holes], np.int64)
            g.holes[2 * i] = (ph, lh)
            L = len(clean)
            g.holes[2 * i + 1] = (np.array([L - 2 - p for p, _ in reversed(holes)], np.int64),
                                  np.array([l for _, l in reversed(holes)], np.int64))
    g.seq_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    g.seq_data = np.concatenate(flat) if flat else np.zeros(0, np.uint8)
    g.rebuild_adjacency()
    return g


def _split_holes(seq: np.ndarray) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Strip runs of N (code >= 4) into hole records: hole starts right
    after clean position p (reference hole convention)."""
    isn = seq >= 4
    if not isn.any():
        return seq, []
    clean = []
    holes = []
    i = 0
    pos = 0
    while i < len(seq):
        if isn[i]:
            j = i
            while j < len(seq) and isn[j]:
                j += 1
            if pos > 0:
                holes.append((pos - 1, j - i))
            i = j
        else:
            clean.append(seq[i])
            pos += 1
            i += 1
    return np.asarray(clean, np.uint8), holes
