"""FASTA / GFA graph writers matching the reference's output conventions.

write_fasta: one record per rc edge pair, header
  >SEQ_<e>_<e_rc>_length_<len>_cov_<cov:.3f>
80 columns, skipping edges in small connected components
(reference src/assembly_graph.c:791-832; CC size filter MIN_CONNECT_SIZE,
length filter MIN_NOTICE_LEN).  write_fasta_all: every live edge, both
strands, no filter (`bin2text`).

write_gfa: S-lines named <e>_<e_rc>_cov_<cov:.3f> with Bandage KC tag,
L-lines via target-node adjacency with <k>M overlaps (reference :860-932;
note: the reference's L-line fprintf scrambles its argument order —
cov2/next_pe_rc swapped against the format string — we emit well-formed
GFA instead).
"""

from __future__ import annotations

import numpy as np

from ..graph.structs import ACGT, AsmGraph

MIN_CONNECT_SIZE = 500   # reference src/assembly_graph.h:99
MIN_NOTICE_LEN = 100     # reference src/assembly_graph.h:98
MIN_COMPONENT = 250      # reference src/assembly_graph.h:135


def edge_connected_components(g: AsmGraph):
    """Per-edge CC id + CC size (sum of (len-k) per rc pair, + k per
    dead end), reference asm_edge_cc src/assembly_graph.c:712-769."""
    n_e = g.n_e
    cc_id = np.full(n_e, -1, np.int64)
    sizes = []
    lens = g.edge_len()
    deg = g.node_deg()
    for s in range(n_e):
        if g.edge_source[s] == -1 or cc_id[s] != -1:
            continue
        cid = len(sizes)
        cc_id[s] = cc_id[g.edge_rc[s]] = cid
        stack = [s]
        size2 = 0
        while stack:
            e = stack.pop()
            e_rc = int(g.edge_rc[e])
            size2 += 2 * (int(lens[e]) - g.ksize)
            for ee in (e, e_rc):
                u = int(g.edge_target[ee])
                if deg[u] == 0:
                    size2 += g.ksize
                for ne in g.node_adj(u):
                    ne = int(ne)
                    if cc_id[ne] == -1:
                        cc_id[ne] = cc_id[g.edge_rc[ne]] = cid
                        stack.append(ne)
        sizes.append(size2 // 2)
    return cc_id, np.asarray(sizes, np.int64)


def _emit_seq(fp, seq_str: str, width: int = 80) -> None:
    for i in range(0, len(seq_str), width):
        fp.write(seq_str[i : i + width])
        fp.write("\n")


def write_fasta(g: AsmGraph, path: str) -> None:
    cc_id, cc_size = edge_connected_components(g)
    cov = g.edge_cov()
    lens_h = g.edge_lens_with_holes()
    with open(path, "w") as fp:
        for e in range(g.n_e):
            if g.edge_source[e] == -1:
                continue
            e_rc = int(g.edge_rc[e])
            if e > e_rc:
                continue
            if cc_size[cc_id[e]] < MIN_CONNECT_SIZE or g.edge_len(e) < MIN_NOTICE_LEN:
                continue
            fp.write(f">SEQ_{e}_{e_rc}_length_{int(lens_h[e])}_cov_{cov[e]:.3f}\n")
            _emit_seq(fp, g.get_seq_str(e))


def write_fasta_all(g: AsmGraph, path: str, min_len: int = 0) -> None:
    """Unfiltered variant (reference write_stupid_fasta :832): every live
    edge, both strands, no component filter."""
    cov = g.edge_cov()
    lens_h = g.edge_lens_with_holes()
    with open(path, "w") as fp:
        for e in range(g.n_e):
            if g.edge_source[e] == -1 or g.edge_len(e) < min_len:
                continue
            e_rc = int(g.edge_rc[e])
            fp.write(f">SEQ_{e}_{e_rc}_length_{int(lens_h[e])}_cov_{cov[e]:.3f}\n")
            _emit_seq(fp, g.get_seq_str(e))


def write_gfa(g: AsmGraph, path: str) -> None:
    cc_id, cc_size = edge_connected_components(g)
    cov = g.edge_cov()
    lens_h = g.edge_lens_with_holes()

    def name(e):
        e_rc = int(g.edge_rc[e])
        pe, pe_rc = (e, e_rc) if e <= e_rc else (e_rc, e)
        return f"{pe}_{pe_rc}_cov_{cov[pe]:.3f}", ("+" if e <= e_rc else "-")

    with open(path, "w") as fp:
        for e in range(g.n_e):
            if g.edge_source[e] == -1:
                continue
            e_rc = int(g.edge_rc[e])
            if e > e_rc or cc_size[cc_id[e]] < MIN_COMPONENT:
                continue
            kc = int(cov[e] * lens_h[e])
            fp.write(f"S\t{name(e)[0]}\t{ACGT[g.get_seq(e)].tobytes().decode()}\tKC:i:{kc}\n")
        for e in range(g.n_e):
            if g.edge_source[e] == -1 or cc_size[cc_id[e]] < MIN_COMPONENT:
                continue
            n1, o1 = name(e)
            u = int(g.edge_target[e])
            for ne in g.node_adj(u):
                n2, o2 = name(int(ne))
                fp.write(f"L\t{n1}\t{o1}\t{n2}\t{o2}\t{g.ksize}M\n")
        fp.write(f"# ksize={g.ksize}\n")


def read_fasta(path: str):
    """Yield (name, seq string) from a FASTA file (plain, reference kseq
    equivalent for host-side loading)."""
    name, chunks = None, []
    with open(path) as fp:
        for line in fp:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name, chunks = line[1:].split()[0], []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)
