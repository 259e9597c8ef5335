"""Greedy read-pair contig extension — rebuild of src/read_pairs_resolve.c
(a copy of turingassembler_tpu/resolve/readpairs.py; host code).

Flow (reference get_long_contigs_by_readpairs :298-393):
  - per-edge candidate lists from read-pair mapping counts
    (get_read_pairs_count :16-57; counts come from the minimizer mapper
    here instead of BWA);
  - edges sorted by length; from each unused edge with
    0.5 <= cov/unit_cov <= 1.3, greedily chain the best candidate while
    best > 1.3*(second+10), candidate cov >= 0.5*unit_cov, len >= 100,
    stopping at repeats (cov > 1.3*unit_cov) and the 5 kb cap
    (extend_by_read_pairs :171-210); extend both directions, consuming
    edge counts so multiplicity is respected;
  - consecutive path edges are stitched through the graph's shortest
    path when <= 555 bp (MAX_READ_PAIR_DISTANCE, read_pairs_resolve.h:14,
    via get_shortest_path cluster_molecules.c:1165), else joined with
    50 N;
  - output graph_k_<k>_extend.fasta; leftover edges >100 bp appended.
"""

from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..graph.structs import ACGT, AsmGraph
from ..logging_utils import add_stage_wall, get_logger

MAX_READ_PAIR_DISTANCE = 555   # read_pairs_resolve.h:14
REPEAT_COV_RATIO = 1.3         # :15
MAX_LEN_RESOLVE_READPAIR = 5000  # :16
MIN_NOTICE_LEN = 100


def build_rp_cand(g: AsmGraph, rp_counts: Dict[Tuple[int, int], int]):
    """Symmetrized per-edge candidate lists (reference
    get_read_pairs_count).  rp_counts keys are (edge(r1), edge(r2))."""
    agg: Dict[Tuple[int, int], int] = {}
    for (v, u_rc), count in rp_counts.items():
        u = int(g.edge_rc[u_rc])
        v_rc = int(g.edge_rc[v])
        if u == int(g.edge_rc[v_rc]):
            continue
        agg[(v, u)] = agg.get((v, u), 0) + count
        agg[(u_rc, v_rc)] = agg.get((u_rc, v_rc), 0) + count
    cand: Dict[int, List[Tuple[int, int]]] = {}
    for (v, u), val in agg.items():
        cand.setdefault(v, []).append((u, val))
    return cand


def _get_next_cand(g, counts, lens, unit_cov, cand, last):
    best, best_score, second = -1, 0, 0
    for u, score in cand.get(last, ()):
        if int(g.edge_rc[u]) == last:
            continue
        if score > second:
            second = score
            if second > best_score:
                best_score, second = second, best_score
                best = u
    if best_score > (second + 10) * 1.3:
        cov = counts[best] / max(lens[best] - g.ksize, 1)
        if cov >= 0.5 * unit_cov and lens[best] >= 100:
            return best
    return -1


def _extend(g, counts, lens, s, unit_cov, cand, last_len):
    path = [s]
    c = min(int(unit_cov * (lens[s] - g.ksize + 1)), counts[s])
    counts[s] -= c
    counts[int(g.edge_rc[s])] -= c
    total = last_len
    while True:
        v = _get_next_cand(g, counts, lens, unit_cov, cand, path[-1])
        if v == -1:
            return path, total
        if lens[v] > MAX_LEN_RESOLVE_READPAIR and total > MAX_LEN_RESOLVE_READPAIR:
            return path, total
        cov_v = counts[v] / max(lens[v] - g.ksize, 1)
        cov_s = counts[s] / max(lens[s] - g.ksize, 1)
        if cov_v > REPEAT_COV_RATIO * unit_cov or cov_s > REPEAT_COV_RATIO * unit_cov:
            return path, total
        counts[v] = 0
        counts[int(g.edge_rc[v])] = 0
        path.append(v)
        total += lens[v]


def shortest_path_edges(g: AsmGraph, e1: int, e2: int,
                        max_bp: int = MAX_READ_PAIR_DISTANCE,
                        max_edges: int = 30) -> Optional[List[int]]:
    """Shortest edge path e1 -> e2 by intermediate bp (reference
    get_shortest_path cluster_molecules.c:1165-1287, MAX_PATH_LEN=30)."""
    # Dijkstra over edges; cost = sum of (len - k) of intermediate edges
    start = (0, 0, e1, [e1])
    heap = [start]
    seen = {}
    while heap:
        cost, ne, e, path = heapq.heappop(heap)
        if e == e2 and len(path) > 1:
            return path
        if ne >= max_edges:
            continue
        if seen.get(e, 1 << 30) < cost:
            continue
        tg = int(g.edge_target[e])
        for nxt in g.node_adj(tg):
            nxt = int(nxt)
            add = 0 if nxt == e2 else int(g.edge_len(nxt)) - g.ksize
            nc = cost + add
            if nc > max_bp:
                continue
            if seen.get(nxt, 1 << 30) <= nc:
                continue
            seen[nxt] = nc
            heapq.heappush(heap, (nc, ne + 1, nxt, path + [nxt]))
    return None


def _stitch_path_seq(g: AsmGraph, path: List[int]) -> str:
    """Join path contigs; gaps bridged by graph shortest path when short,
    else 50 N (reference concate_path_seq_fill_shortest_path :262-290)."""
    parts = [ACGT[g.get_seq(path[0])].tobytes().decode()]
    for i in range(1, len(path)):
        sp = shortest_path_edges(g, path[i - 1], path[i])
        if sp is not None:
            for mid in sp[1:-1]:
                parts.append(ACGT[g.get_seq(mid)].tobytes().decode())
        else:
            parts.append("N" * 50)
        parts.append(ACGT[g.get_seq(path[i])].tobytes().decode())
    return "".join(parts)


def get_long_contigs_by_readpairs(g: AsmGraph,
                                  rp_counts: Dict[Tuple[int, int], int],
                                  out_path: str) -> str:
    t0 = time.perf_counter()
    cand = build_rp_cand(g, rp_counts)
    lens = g.edge_len().copy()
    counts = g.edge_count.copy().astype(np.int64)
    unit_cov = g.mean_coverage()
    order = np.argsort(lens)
    visited = np.zeros(g.n_e, bool)
    n_seq = 0
    with open(out_path, "w") as f:
        for e in order[::-1]:
            e = int(e)
            if g.edge_source[e] < 0:
                continue
            cov = counts[e] / max(lens[e] - g.ksize, 1)
            if cov < 0.5 * unit_cov or lens[e] < 100 or cov > 1.3 * unit_cov:
                continue
            path_fw, last_len = _extend(g, counts, lens, e, unit_cov, cand,
                                        int(lens[e]))
            path_rv, _ = _extend(g, counts, lens, int(g.edge_rc[e]), unit_cov,
                                 cand, last_len)
            path = [int(g.edge_rc[x]) for x in reversed(path_rv)] + path_fw[1:]
            for x in path:
                visited[x] = visited[int(g.edge_rc[x])] = True
            seq = _stitch_path_seq(g, path)
            f.write(f">SEQ_{n_seq}\n{seq}\n")
            n_seq += 1
        for e in range(g.n_e):
            e_rc = int(g.edge_rc[e]) if g.edge_rc[e] >= 0 else e
            if e > e_rc or lens[e] <= MIN_NOTICE_LEN or g.edge_source[e] < 0:
                continue
            cov = counts[e] / max(lens[e] - g.ksize, 1)
            if not visited[e] or cov >= 0.2 * unit_cov:
                f.write(f">SEQ_{n_seq}\n"
                        f"{ACGT[g.get_seq(e)].tobytes().decode()}\n")
                n_seq += 1
    get_logger().info("read-pair extension: wrote %d sequences to %s",
                      n_seq, out_path)
    add_stage_wall("extend", time.perf_counter() - t0)
    return out_path
