"""Barcode-graph molecule analysis — rebuild of src/barcode_graph.c +
src/cluster_molecules.c, the metagenomics/debug path (port of
turingassembler_tpu/scaffold/molecules.py: host code copied, the
unverified map of hit_all_barcodes runs on `device`).

Flow (reference get_list_contig barcode_graph.c:635-707):
  1. per-barcode edge hit counts via the minimizer mapper
     (mm_hit_all_barcodes, minimizers.c:780-943) and edge-pair read-pair
     counts;
  2. shared-barcode pair counts (count_edge_link_shared_bc,
     count_barcodes.c:478-520);
  3. candidate pairs filtered by length >= 500 (MIN_EDGE_LEN), coverage
     <= 1.5x global, share/(len_u+len_v) >= 0.005
     (MIN_SHARED_BARCODE_RATIO, lengths clamped at MOLECULE_DENSITY=5000);
  4. pairs must be supported by read pairs or a graph path within
     4 kb / 30 edges (filter_shortest_path_and_readpair,
     barcode_graph.c:367);
  5. a simple digraph over surviving edges (links need >= 100 shared
     barcodes, MIN_BARCODE_EDGE_COUNT) is reduced to its DAG part;
     longest paths are extracted (cluster_molecules.c:303-500) and
     emitted as molecule contigs, stitched through graph shortest paths;
  6. untouched edges above 0.25x coverage are carried over
     (create_barcode_molecules :352-420).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..config import Config
from ..graph.structs import ACGT, AsmGraph
from ..logging_utils import get_logger
from ..mapper.minimizers import EdgeMinimizerIndex, map_reads
from ..resolve.readpairs import shortest_path_edges

MIN_EDGE_LEN = 500             # cluster_molecules.h:4
MAX_RADIUS = 4000              # :5
MAX_PATH_LEN = 30              # :6
MIN_BARCODE_EDGE_COUNT = 100   # :9
MIN_COVERAGE_TO_BE_IGNORE = 0.25  # :10
MIN_SHARED_BARCODE_RATIO = 0.005  # barcode_graph.c:19
MOLECULE_DENSITY = 5000        # barcode_graph.c:20


def hit_all_barcodes(cfg: Config, g: AsmGraph, rpath,
                     index: Optional[EdgeMinimizerIndex] = None, *,
                     device="cuda"):
    """(bx_table, rp_table): per-barcode edge hits and edge-pair
    read-pair counts (reference mm_hit_all_barcodes)."""
    from ..barcode.builder import _iter_sorted_pairs
    if index is None:
        index = EdgeMinimizerIndex.build(g, device=device)
    bx_table: Dict[int, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
    rp_table: Dict[Tuple[int, int], int] = defaultdict(int)
    BX_NONE = np.uint64(0xFFFFFFFFFFFFFFFF)
    for b1, l1, b2, l2, bcs in _iter_sorted_pairs(rpath):
        e1, _, _ = map_reads(index, b1, l1, device=device)
        e2, _, _ = map_reads(index, b2, l2, device=device)
        # (barcode, edge) hit counts via numpy group-by
        both_bc = np.concatenate([bcs, bcs])
        both_e = np.concatenate([e1, e2]).astype(np.int64)
        ok = (both_e >= 0) & (both_bc != BX_NONE)
        bb, ee = both_bc[ok], both_e[ok]
        if len(bb):
            order = np.lexsort((ee, bb))
            bb, ee = bb[order], ee[order]
            starts = np.ones(len(bb), bool)
            starts[1:] = (bb[1:] != bb[:-1]) | (ee[1:] != ee[:-1])
            idx = np.flatnonzero(starts)
            cnt = np.diff(np.append(idx, len(bb)))
            for bc_, e_, c_ in zip(bb[idx].tolist(), ee[idx].tolist(),
                                   cnt.tolist()):
                bx_table[bc_][e_] += c_
        # (edge1, edge2) read-pair counts
        pr = (e1 >= 0) & (e2 >= 0) & (e1 != e2) & \
            (g.edge_rc[np.clip(e1, 0, g.n_e - 1)] != e2)
        if pr.any():
            keys = e1[pr].astype(np.int64) * np.int64(1 << 32) + e2[pr]
            uk, uc = np.unique(keys, return_counts=True)
            for k_, c_ in zip(uk.tolist(), uc.tolist()):
                rp_table[(k_ >> 32, k_ & 0xFFFFFFFF)] += int(c_)
    return bx_table, rp_table


def count_edge_link_shared_bc(bx_table) -> Dict[Tuple[int, int], int]:
    """Shared-barcode counts per edge pair (reference
    count_edge_link_shared_bc, src/minimizers/count_barcodes.c:478-520).
    All pairs within each barcode's edge set, enumerated in numpy."""
    rows_bc, rows_e = [], []
    for bc, hits in bx_table.items():
        es = sorted(hits)
        rows_bc.append(np.full(len(es), len(rows_bc), np.int64))
        rows_e.append(np.asarray(es, np.int64))
    out: Dict[Tuple[int, int], int] = defaultdict(int)
    if not rows_bc:
        return out
    grp = np.concatenate(rows_bc)
    edge = np.concatenate(rows_e)
    sizes = np.bincount(grp)
    # within-group all-pairs (j < k): left index repeats each element
    # (size - 1 - position) times; right runs over the remainder
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    pos = np.arange(len(edge)) - starts[grp]
    rep = (sizes[grp] - 1 - pos).astype(np.int64)
    left = np.repeat(np.arange(len(edge)), rep)
    # right offsets: 1..rep within each left element
    roff = np.arange(len(left)) - np.repeat(
        np.concatenate([[0], np.cumsum(rep)[:-1]]).astype(np.int64), rep)
    right = left + 1 + roff
    keys = edge[left] * np.int64(1 << 32) + edge[right]
    uk, uc = np.unique(keys, return_counts=True)
    for k_, c_ in zip(uk.tolist(), uc.tolist()):
        out[(k_ >> 32, k_ & 0xFFFFFFFF)] = int(c_)
    return out


# barcode-graph filter thresholds (reference src/barcode_graph.c:13-18)
MIN_READ_PAIR_COUNT = 1
VERY_SHORT_EDGE_LEN = 250
LONG_PATH = 10
MIN_PAIR_SUPPORT_PAIR_END = 1
MIN_PAIR_SUPPORT_PAIR_END_SOFT = 0


class BarcodeGraph:
    """Directed candidate links over contig ids with rc-pair and
    8-orientation group deletion (reference struct barcode_graph +
    del_pair/del_eight_edge, src/barcode_graph.c:27-95)."""

    def __init__(self, g: AsmGraph):
        self.g = g
        self.links: Dict[Tuple[int, int], int] = {}   # (a,b) -> group id
        self.groups: Dict[int, List[Tuple[int, int]]] = defaultdict(list)

    def add_group(self, u: int, v: int) -> None:
        rc = self.g.edge_rc
        u_rc, v_rc = int(rc[u]), int(rc[v])
        gid = len(self.groups)
        # append order mirrors get_list_contig (barcode_graph.c:683-693)
        for a, b in ((u, v), (v_rc, u_rc), (u, v_rc), (v, u_rc),
                     (u_rc, v), (v_rc, u), (u_rc, v_rc), (v, u)):
            if (a, b) not in self.links:
                self.links[(a, b)] = gid
                self.groups[gid].append((a, b))

    def live(self) -> List[Tuple[int, int]]:
        return list(self.links)

    def del_pair(self, a: int, b: int) -> None:
        """Delete (a,b) and its rc companion (del_pair_edge)."""
        rc = self.g.edge_rc
        for key in ((a, b), (int(rc[b]), int(rc[a]))):
            self.links.pop(key, None)

    def del_group(self, a: int, b: int) -> None:
        """Delete the whole 8-orientation candidate (del_eight_edge)."""
        gid = self.links.get((a, b))
        if gid is None:
            return
        for key in self.groups[gid]:
            self.links.pop(key, None)

    def out_adj(self) -> Dict[int, List[int]]:
        adj: Dict[int, List[int]] = defaultdict(list)
        for a, b in self.links:
            adj[a].append(b)
        return adj

    def in_adj(self) -> Dict[int, List[int]]:
        adj: Dict[int, List[int]] = defaultdict(list)
        for a, b in self.links:
            adj[b].append(a)
        return adj


def _spath(g, stored, a, b):
    key = (a, b)
    if key not in stored:
        stored[key] = shortest_path_edges(g, a, b, max_bp=MAX_RADIUS,
                                          max_edges=MAX_PATH_LEN)
    return stored[key]


def _check_read_pair(g: AsmGraph, rp_table, path: List[int]) -> bool:
    """Path endpoints must share read pairs with interior edges
    (reference check_read_pair, src/barcode_graph.c:181-240)."""
    thres = (MIN_PAIR_SUPPORT_PAIR_END if len(path) >= LONG_PATH
             else MIN_PAIR_SUPPORT_PAIR_END_SOFT)
    lens = g.edge_len()
    rc = g.edge_rc
    n = 0
    for i in range(1, len(path)):
        if lens[path[i]] < VERY_SHORT_EDGE_LEN or \
                lens[path[0]] < VERY_SHORT_EDGE_LEN:
            continue
        if rp_table.get((path[0], int(rc[path[i]])), 0) > MIN_READ_PAIR_COUNT:
            n += 1
    for i in range(len(path) - 1):
        if lens[path[i]] < VERY_SHORT_EDGE_LEN or \
                lens[path[-1]] < VERY_SHORT_EDGE_LEN:
            continue
        if rp_table.get((path[i], int(rc[path[-1]])), 0) > MIN_READ_PAIR_COUNT:
            n += 1
    return n > thres


def filter_shortest_path_and_readpair(g, bg: BarcodeGraph, stored,
                                      rp_table) -> None:
    """reference src/barcode_graph.c:367-404: each directed link needs a
    bounded graph path whose interior is read-pair-supported."""
    for a, b in bg.live():
        if (a, b) not in bg.links:
            continue
        path = _spath(g, stored, a, b)
        if path is None:
            bg.del_pair(a, b)
            continue
        if not _check_read_pair(g, rp_table, path):
            bg.del_pair(a, b)


def filter_go_both_reverse_complement(g, bg: BarcodeGraph) -> None:
    """A node linking to both an edge and its rc is ambiguous: drop the
    whole candidate (reference src/barcode_graph.c:405-447)."""
    rc = g.edge_rc
    for forward in (True, False):
        adj = bg.out_adj() if forward else bg.in_adj()
        for node, nbrs in sorted(adj.items()):
            for j in range(len(nbrs)):
                for l in range(j + 1, len(nbrs)):
                    if int(rc[nbrs[j]]) == nbrs[l]:
                        if forward:
                            bg.del_group(node, nbrs[j])
                        else:
                            bg.del_group(nbrs[j], node)


def filter_go_reverse_complement(g, bg: BarcodeGraph) -> None:
    """Drop links node -> rc(node) (reference :344-356)."""
    rc = g.edge_rc
    for a, b in bg.live():
        if int(rc[a]) == b:
            bg.del_pair(a, b)


def filter_by_deg(bg: BarcodeGraph, thres: int) -> None:
    """Nodes with more than thres out-(then in-)links lose them all
    (reference src/barcode_graph.c:127-160)."""
    for node, nbrs in sorted(bg.out_adj().items()):
        if len(nbrs) > thres:
            for b in nbrs:
                bg.del_pair(node, b)
    for node, nbrs in sorted(bg.in_adj().items()):
        if len(nbrs) > thres:
            for a in nbrs:
                bg.del_pair(a, node)


def remove_tips_barcode_graph(g, bg: BarcodeGraph, stored) -> None:
    """Transitive reduction: a link is dropped when its endpoint already
    lies on the graph shortest path to a sibling link (reference
    src/barcode_graph.c:260-343)."""
    max_deg_out = 10
    for forward in (True, False):
        adj = bg.out_adj() if forward else bg.in_adj()
        for node, nbrs in sorted(adj.items()):
            if len(nbrs) > max_deg_out:
                continue
            flag = [False] * len(nbrs)
            for i, ni in enumerate(nbrs):
                if flag[i]:
                    continue
                path = _spath(g, stored, node, ni) if forward \
                    else _spath(g, stored, ni, node)
                if path is None:
                    continue
                for pe in path:
                    for l, nl in enumerate(nbrs):
                        if pe == nl and l != i:
                            flag[l] = True
            for l, nl in enumerate(nbrs):
                if flag[l]:
                    bg.del_pair(node, nl) if forward else bg.del_pair(nl, node)


def filter_bulge(bg: BarcodeGraph) -> None:
    """2-out nodes whose targets are themselves linked keep only the
    nearer one (reference filter_bulge, src/barcode_graph.c:97-125)."""
    for node, nbrs in sorted(bg.out_adj().items()):
        if len(nbrs) != 2:
            continue
        n0, n1 = nbrs
        if (n0, n1) in bg.links:
            bg.del_pair(node, n1)
        elif (n1, n0) in bg.links:
            bg.del_pair(node, n0)


def filter_list_edge(g: AsmGraph, bg: BarcodeGraph,
                     rp_table) -> List[Tuple[int, int]]:
    """The reference's full filter pipeline (filter_list_edge,
    src/barcode_graph.c:449-482)."""
    stored: Dict[Tuple[int, int], Optional[List[int]]] = {}
    filter_shortest_path_and_readpair(g, bg, stored, rp_table)
    filter_go_both_reverse_complement(g, bg)
    filter_go_reverse_complement(g, bg)
    filter_by_deg(bg, 4)
    remove_tips_barcode_graph(g, bg, stored)
    filter_by_deg(bg, 4)        # filter_complex_barcode_graph
    filter_bulge(bg)
    filter_by_deg(bg, 1)
    return bg.live()


def candidate_pairs(g: AsmGraph, all_count, rp_table) -> List[Tuple[int, int]]:
    """Barcode-count prefilter (reference get_list_contig,
    src/barcode_graph.c:635-707) followed by the barcode-graph filter
    pipeline."""
    lens = g.edge_len()
    cov = g.edge_cov()
    gcov = g.mean_coverage()
    bg = BarcodeGraph(g)
    for (u, v), val in sorted(all_count.items()):
        if u == v or int(g.edge_rc[u]) == u:
            continue
        if cov[u] > 1.5 * gcov or cov[v] > 1.5 * gcov:
            continue
        if lens[u] < MIN_EDGE_LEN or lens[v] < MIN_EDGE_LEN:
            continue
        lu = min(int(lens[u]), MOLECULE_DENSITY)
        lv = min(int(lens[v]), MOLECULE_DENSITY)
        if val / (lu + lv) < MIN_SHARED_BARCODE_RATIO:
            continue
        bg.add_group(u, v)
    return filter_list_edge(g, bg, rp_table)


def extract_molecules(g: AsmGraph, pairs: List[Tuple[int, int]],
                      all_count) -> List[List[int]]:
    """DAG reduction + longest paths over the barcode digraph
    (cluster_molecules.c:303-500)."""
    link: Dict[int, List[int]] = defaultdict(list)
    nodes: Set[int] = set()
    for a, b in pairs:
        key = (min(a, b), max(a, b))
        rc_key = (min(int(g.edge_rc[b]), int(g.edge_rc[a])),
                  max(int(g.edge_rc[b]), int(g.edge_rc[a])))
        val = max(all_count.get(key, 0), all_count.get(rc_key, 0))
        if val < MIN_BARCODE_EDGE_COUNT:
            continue
        link[a].append(b)
        nodes.add(a)
        nodes.add(b)

    # drop nodes on cycles (find_DAG / check_loop_dfs)
    on_loop: Set[int] = set()
    visited: Set[int] = set()

    def dfs_loop(v, stack):
        if v in stack:
            on_loop.add(v)
            return
        if v in visited:
            return
        visited.add(v)
        stack.add(v)
        for u in link.get(v, ()):
            dfs_loop(u, stack)
        stack.discard(v)

    for v in list(nodes):
        dfs_loop(v, set())

    # longest path per node (memoized DAG DP)
    path_len: Dict[int, int] = {}
    nxt: Dict[int, int] = {}

    def longest(v) -> int:
        if v in path_len:
            return path_len[v]
        best, bn = 0, -1
        for u in link.get(v, ()):
            if u in on_loop:
                continue
            l = longest(u)
            if l > best:
                best, bn = l, u
        path_len[v] = best + 1
        nxt[v] = bn
        return best + 1

    has_pred = {b for bs in link.values() for b in bs}
    roots = [v for v in nodes if v not in has_pred and v not in on_loop]
    roots.sort(key=lambda v: -longest(v))
    used: Set[int] = set()
    molecules = []
    for r in roots:
        if r in used:
            continue
        path = []
        v = r
        while v != -1 and v not in used:
            path.append(v)
            used.add(v)
            used.add(int(g.edge_rc[v]))
            v = nxt.get(v, -1)
        if len(path) >= 2:
            molecules.append(path)
    return molecules


MOL_MIN_EDGE_LEN = 500     # init_line_graph, split_molecules.c:27
MOL_MAX_HOPS = 2           # MAX_PATH_LEN, split_molecules.c:4


def _edges_in_radius(g: AsmGraph, e: int, max_hops: int = MOL_MAX_HOPS):
    """Edges reachable from e within max_hops graph hops (reference
    get_edges_in_radius BFS, split_molecules.c:104-135)."""
    from collections import deque
    seen = {e: 0}
    q = deque([e])
    while q:
        cur = q.popleft()
        d = seen[cur]
        if d >= max_hops:
            continue
        tg = int(g.edge_target[cur])
        for nxt in g.node_adj(tg):
            nxt = int(nxt)
            if nxt not in seen:
                seen[nxt] = d + 1
                q.append(nxt)
    return set(seen)


def order_molecule_edges(g: AsmGraph, hit_edges) -> List[List[int]]:
    """Order one barcode's hit edges into molecules: line graph over
    long hit edges (+rcs) linked by <=2-hop graph reachability, then
    unambiguous chains (reference order_edges + construct_line_graph,
    src/split_molecules.c:49-185)."""
    lens = g.edge_len()
    verts: Set[int] = set()
    for e in hit_edges:
        if g.edge_source[e] < 0 or lens[e] < MOL_MIN_EDGE_LEN:
            continue
        verts.add(int(e))
        verts.add(int(g.edge_rc[e]))
    children: Dict[int, List[int]] = defaultdict(list)
    parents: Dict[int, List[int]] = defaultdict(list)
    for e in sorted(verts):
        near = _edges_in_radius(g, e)
        for ne in sorted(verts):
            if ne != e and ne in near:
                children[e].append(ne)
                parents[ne].append(e)
    chains = []
    for e in sorted(verts):
        if len(parents[e]) != 0:
            continue
        chain = []
        v = e
        while len(children[v]) == 1:
            chain.append(v)
            v = children[v][0]
            if len(parents[v]) != 1:
                break
        if len(children[v]) == 0 and len(parents[v]) == 1:
            chain.append(v)
            if len(chain) > 1:
                chains.append(chain)
    return chains


def molecule_contigs(cfg: Config, g: AsmGraph, rpath,
                     out_dir: Optional[str] = None, *,
                     device="cuda") -> str:
    """Full molecule pipeline; writes molecules.fasta (paths stitched
    through graph shortest paths + untouched edges)."""
    out_dir = out_dir or cfg.out_dir
    os.makedirs(out_dir, exist_ok=True)
    bx_table, rp_table = hit_all_barcodes(cfg, g, rpath, device=device)
    all_count = count_edge_link_shared_bc(bx_table)
    pairs = candidate_pairs(g, all_count, rp_table)
    molecules = extract_molecules(g, pairs, all_count)
    from ..resolve.readpairs import _stitch_path_seq
    gcov = g.mean_coverage()
    cov = g.edge_cov()
    touched = np.zeros(g.n_e, bool)
    out = os.path.join(out_dir, "molecules.fasta")
    n = 0
    with open(out, "w") as fp:
        for path in molecules:
            seq = _stitch_path_seq(g, path)
            for e in path:
                touched[e] = touched[int(g.edge_rc[e])] = True
            fp.write(f">MOL_{n}\n{seq}\n")
            n += 1
        for e in range(g.n_e):
            rc = int(g.edge_rc[e]) if g.edge_rc[e] >= 0 else e
            if e > rc or g.edge_source[e] < 0:
                continue
            if touched[e] and cov[e] <= MIN_COVERAGE_TO_BE_IGNORE * gcov:
                continue
            fp.write(f">MOL_{n}\n{ACGT[g.get_seq(e)].tobytes().decode()}\n")
            n += 1
    get_logger().info("molecules: %d paths, %d total records",
                      len(molecules), n)
    return out
