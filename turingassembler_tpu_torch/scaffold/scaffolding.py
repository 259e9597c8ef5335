"""Shared-barcode scaffolding — rebuild of src/scaffolding/ (a copy of
turingassembler_tpu/scaffold/scaffolding.py; host code).

Algorithm (reference scaffolding() src/scaffolding/scaffolding.c:699-731):
  1. init params (global_params.c:21-37: thres_length=4000,
     thres_short_len=100, n_candidate=11, distance=10000, number_n=100);
     drop edges with cov < 0.15 x genome coverage (remove_lov_high_cov,
     MIN_EDGE_COV_SCAFFOLD scaffolding.h:8) unless -metagenomics;
  2. inverted barcode table: barcode -> long contigs whose barcodes_scaf
     contains it (build_big_table :177-262);
  3. per long contig: count shared barcodes between rc(e).barcodes_scaf
     and every other long contig via the table; score =
     share / min(|scaf(rc e)|, |scaf(des)|), 0 if either < 75 barcodes
     (get_bc_score buck.c:33-44) or coverage differs > 3x (too_different
     :61); keep top-11, cut at zero or > 2x score drop
     (find_local_nearby_contig :110-175);
  4. greedy bidirectional path growth from each unused long contig:
     next = argmax of direct score + rc-score/2 + decayed look-back
     within 10 kb (get_score :400-442, find_best_edge :459-496,
     find_path :547-590); contigs reusable up to round(cov/genome_cov)
     times, capped 3 (init_mark :592-606); adaptive threshold =
     running-mean/5;
  5. leftover short contigs (>=100 bp) become singleton paths;
  6. refine: flip middle contigs when the rc orientation scores higher
     on the (left, mid, right) triple (refine_path :515-545);
  7. write scaffolds.fasta (contigs joined by 100 N, print_contig
     output.c:44-78, holes clamped to 1000 N) and
     local_assembly_scaffold_path.txt (print_scaffold_contig
     scaffold.c:110-136); if no multi-contig path, copy to
     scaffold.full.fasta and stop.

The shared-barcode tally is the sparse (barcode x contig) incidence
product; at bacterial scale the contig count is tiny, so this runs
host-side with dicts.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..graph.structs import ACGT, AsmGraph
from ..logging_utils import get_logger

THRES_LENGTH = 4000          # global_thres_length
THRES_SHORT_LEN = 100        # global_thres_short_len
N_CANDIDATE = 11             # global_n_candidate
DISTANCE = 10000             # global_distance
NUMBER_N = 100               # global_number_n
MIN_SHARE_BARCODE = 75       # buck.c MIN_SHARE_BARCODE
MIN_EDGE_COV_SCAFFOLD = 0.15  # scaffolding.h:8


def _too_different(a: float, b: float) -> bool:
    return a < b / 3 or a > 3 * b


class ScaffoldPath:
    def __init__(self, start: int):
        self.left: List[int] = []   # prepended (stored outward)
        self.right: List[int] = [start]

    def contigs(self) -> List[int]:
        return list(reversed(self.left)) + self.right

    def __len__(self):
        return len(self.left) + len(self.right)

    def last_n(self, is_left: int, pos: int) -> int:
        """pos-th contig counted inward from the growing end (reference
        get_last_n, scaffold.c): left end when is_left else right end."""
        seq = self.contigs()
        if pos >= len(seq):
            return -1
        return seq[pos] if is_left else seq[len(seq) - 1 - pos]


def _scaf_keys(g: AsmGraph, e: int) -> np.ndarray:
    d = g.barcodes_scaf[e]
    return np.fromiter(d.keys(), np.int64, len(d))


def _candidate_edges_ref(g: AsmGraph, usable, lens, cov, is_long_arr
                         ) -> Dict[int, List[Tuple[int, float]]]:
    """Reference-shaped candidate scoring (inverted big table + per-src
    dict tally; src/scaffolding/scaffolding.c:110-262).  Kept as the
    oracle for the vectorized join below — per-barcode nested Python
    loops are quadratic-ish in metagenome-scale graphs.

    Ties in score break by ascending contig id (the reference qsort is
    unstable, so its tie order is unspecified; a deterministic
    refinement keeps both implementations comparable)."""
    big: Dict[int, List[int]] = {}
    for e in np.flatnonzero(is_long_arr):
        for bc in g.barcodes_scaf[e]:
            big.setdefault(bc, []).append(int(e))
    adj_out: Dict[int, List[Tuple[int, float]]] = {}
    for e in np.flatnonzero(is_long_arr):
        e = int(e)
        rc = int(g.edge_rc[e])
        count: Dict[int, int] = {}
        for bc in g.barcodes_scaf[rc]:
            for c in big.get(bc, ()):
                count[c] = count.get(c, 0) + 1
        cands = []
        cnt0 = len(g.barcodes_scaf[rc])
        for des, share in count.items():
            if not usable[des] or lens[des] < THRES_SHORT_LEN:
                continue
            if (des == e and lens[des] < 50000) or des == rc:
                continue
            if _too_different(cov[e], cov[des]):
                continue
            cnt1 = len(g.barcodes_scaf[des])
            if cnt0 < MIN_SHARE_BARCODE or cnt1 < MIN_SHARE_BARCODE:
                continue
            sc = share / min(cnt0, cnt1)
            if sc > 0:
                cands.append((des, sc))
        cands.sort(key=lambda x: (-x[1], x[0]))
        cands = cands[:N_CANDIDATE]
        kept = []
        for i, (des, sc) in enumerate(cands):
            if sc == 0 or (i > 0 and sc < 0.5 * cands[i - 1][1]):
                break
            kept.append((des, sc))
        adj_out[e] = kept
    return adj_out


def _candidate_edges_fast(g: AsmGraph, usable, lens, cov, is_long_arr
                          ) -> Dict[int, List[Tuple[int, float]]]:
    """Vectorized shared-barcode candidate scoring: one sorted
    (barcode, contig) join + run-length count replaces the big-table
    nested loops (oracle `_candidate_edges_ref`; equivalence in
    tests/test_torch_scaffold.py).  The share tally is the sparse
    (barcode x contig) incidence product the reference computes one
    dict probe at a time (src/scaffolding/scaffolding.c:110-175)."""
    long_ids = np.flatnonzero(is_long_arr).astype(np.int64)
    adj_out: Dict[int, List[Tuple[int, float]]] = {
        int(e): [] for e in long_ids}
    if len(long_ids) == 0:
        return adj_out
    n_e = g.n_e
    sizes = np.array([len(g.barcodes_scaf[e]) for e in range(n_e)],
                     np.int64)

    # B side: (bc, des) for every long des (the big table, flattened)
    b_bc = [ _scaf_keys(g, int(e)) for e in long_ids ]
    B_des = np.repeat(long_ids, [len(a) for a in b_bc])
    B_bc = (np.concatenate(b_bc) if b_bc
            else np.zeros(0, np.int64))
    oB = np.argsort(B_bc, kind="stable")   # stable: des ascends per bc
    B_bc, B_des = B_bc[oB], B_des[oB]
    ub, ustart = np.unique(B_bc, return_index=True)
    ucount = np.diff(np.append(ustart, len(B_bc)))

    # A side: (bc, src) from scaf[rc(src)]; srcs with cnt0 < 75 can
    # never score (per-src constant), prefilter them out of the join
    rc_of = g.edge_rc.astype(np.int64)
    src_ok = long_ids[sizes[rc_of[long_ids]] >= MIN_SHARE_BARCODE]
    a_bc = [ _scaf_keys(g, int(rc_of[e])) for e in src_ok ]
    A_src = np.repeat(src_ok, [len(a) for a in a_bc])
    A_bc = (np.concatenate(a_bc) if a_bc
            else np.zeros(0, np.int64))

    # join on barcode: every (src, des) pair sharing bc contributes 1
    j = np.searchsorted(ub, A_bc)
    ok = (j < len(ub))
    ok[ok] = ub[j[ok]] == A_bc[ok]
    j, A_srcm = j[ok], A_src[ok]
    m = ucount[j]
    pair_src = np.repeat(A_srcm, m)
    off = np.repeat(ustart[j], m)
    tot = int(m.sum())
    starts = np.zeros(len(m) + 1, np.int64)
    np.cumsum(m, out=starts[1:])
    within = np.arange(tot, dtype=np.int64) - np.repeat(starts[:-1], m)
    pair_des = B_des[off + within]

    key = pair_src * n_e + pair_des
    uk, share = np.unique(key, return_counts=True)
    src = uk // n_e
    des = uk % n_e

    # per-pair filters (identical predicates to the reference loop)
    cnt0 = sizes[rc_of[src]]
    cnt1 = sizes[des]
    keep = (usable[des] & (lens[des] >= THRES_SHORT_LEN)
            & ~((des == src) & (lens[des] < 50000))
            & (des != rc_of[src])
            & ~((cov[src] < cov[des] / 3) | (cov[src] > 3 * cov[des]))
            & (cnt1 >= MIN_SHARE_BARCODE))
    src, des, share = src[keep], des[keep], share[keep]
    sc = share / np.minimum(cnt0[keep], cnt1[keep])
    pos = sc > 0
    src, des, sc = src[pos], des[pos], sc[pos]

    if len(src) == 0:
        return adj_out
    # per-src: sort by (-score, des), top-11, 2x-drop cliff
    order = np.lexsort((des, -sc, src))
    src, des, sc = src[order], des[order], sc[order]
    starts_g = np.flatnonzero(
        np.concatenate([[True], src[1:] != src[:-1]]))
    ends_g = np.append(starts_g[1:], len(src))
    for s0, s1 in zip(starts_g, ends_g):
        e = int(src[s0])
        kept: List[Tuple[int, float]] = []
        hi = min(s1, s0 + N_CANDIDATE)
        for i in range(s0, hi):
            v = float(sc[i])
            if i > s0 and v < 0.5 * float(sc[i - 1]):
                break
            kept.append((int(des[i]), v))
        adj_out[e] = kept
    return adj_out


def scaffolding(cfg: Config, g: AsmGraph, out_dir: Optional[str] = None) -> str:
    out_dir = out_dir or cfg.out_dir
    os.makedirs(out_dir, exist_ok=True)
    assert g.barcodes_scaf is not None, "graph lacks barcode aux info"
    log = get_logger()

    lens = g.edge_len().copy()
    cov = g.edge_cov()
    genome_cov = g.mean_coverage()
    alive = g.alive_mask()

    excluded = np.zeros(g.n_e, bool)
    if not cfg.metagenomics and genome_cov > 0:
        excluded = alive & (cov / genome_cov < MIN_EDGE_COV_SCAFFOLD)
        log.info("scaffold: excluded %d low-cov edges", int(excluded.sum()))
    usable = alive & ~excluded

    def is_long(e):
        return usable[e] and lens[e] >= THRES_LENGTH

    def is_short(e):
        return usable[e] and THRES_SHORT_LEN <= lens[e] < THRES_LENGTH

    # ---- candidate edges (shared-barcode scores) ----
    is_long_arr = usable & (lens >= THRES_LENGTH)
    adj_out = _candidate_edges_fast(g, usable, lens, cov, is_long_arr)
    # score[(src, des)] -> bc_score
    edge_score: Dict[Tuple[int, int], float] = {}
    for e, kept in adj_out.items():
        for des, sc in kept:
            edge_score[(e, des)] = sc

    def score_of(a: int, b: int) -> float:
        return edge_score.get((a, b), 0.0)

    # ---- greedy path growth ----
    mark = np.zeros(g.n_e, np.int32)
    if not cfg.metagenomics and genome_cov > 0:
        for e in range(g.n_e):
            if usable[e]:
                mark[e] = min(int(round(max(cov[e] / genome_cov, 1.0))), 3)
    else:
        mark[usable] = 1

    def get_score(path: ScaffoldPath, des: int, is_left: int) -> float:
        last = path.last_n(is_left, 0)
        if is_left:
            last = int(g.edge_rc[last])
        sc = score_of(last, des) + score_of(last, int(g.edge_rc[des])) / 2
        second = 0.0
        i = 0
        distance = int(lens[last])
        while True:
            i += 1
            src = path.last_n(is_left, i)
            if src == -1:
                break
            if is_left:
                src = int(g.edge_rc[src])
            second += score_of(src, des)
            distance += int(lens[src])
            if distance > DISTANCE:
                break
        if i != 0:
            sc += second / (i * 3)
        return sc

    def find_best(path: ScaffoldPath, start: int, is_left: int, thres: float):
        best, best_sc = -1, 0.0
        for des, _ in adj_out.get(start, ()):
            if des == start or not mark[des]:
                continue
            sc = get_score(path, des, is_left)
            if sc > best_sc:
                best_sc, best = sc, des
        if best_sc <= thres:
            return -1, 0.0
        return best, best_sc

    paths: List[ScaffoldPath] = []
    thres_total = 0.0
    count_steps = 0
    if cfg.metagenomics:
        thres_total, count_steps = 0.0, 0
    for start in range(g.n_e):
        if not (mark[start] and is_long(start)):
            continue
        path = ScaffoldPath(start)
        mark[start] -= 1
        mark[int(g.edge_rc[start])] -= 1
        i_r, i_l = start, int(g.edge_rc[start])
        while True:
            thres = (thres_total / (5 * count_steps)) if count_steps else 0.0
            bl, sl = find_best(path, i_l, 1, thres)
            br, sr = find_best(path, i_r, 0, thres)
            if bl == -1 and br == -1:
                break
            if br == -1 or (bl != -1 and sl > sr):
                path.left.append(int(g.edge_rc[bl]))
                i_l = bl
                chosen, sc = bl, sl
            else:
                path.right.append(br)
                i_r = br
                chosen, sc = br, sr
            mark[chosen] -= 1
            mark[int(g.edge_rc[chosen])] -= 1
            thres_total += sc
            count_steps += 1
        paths.append(path)

    for e in range(g.n_e):
        if is_short(e) and mark[e] > 0:
            mark[e] -= 1
            mark[int(g.edge_rc[e])] -= 1
            paths.append(ScaffoldPath(e))

    # ---- refine: orientation flips on triples ----
    for path in paths:
        cl = path.contigs()
        for j in range(1, len(cl) - 1):
            l_, m, r = cl[j - 1], cl[j], cl[j + 1]
            normal = score_of(l_, m) + score_of(m, r)
            m_rc = int(g.edge_rc[m])
            rev = score_of(l_, m_rc) + score_of(m_rc, r)
            if rev > normal:
                cl[j] = m_rc
        path.left = []
        path.right = cl

    # ---- output ----
    scaf_fa = os.path.join(out_dir, "scaffolds.fasta")
    with open(scaf_fa, "w") as fp:
        for i, path in enumerate(paths):
            seq = _join_contigs(g, path.contigs())
            fp.write(f">SEQ_{i}_length_{len(seq)}_count_1\n")
            for j in range(0, len(seq), 80):
                fp.write(seq[j : j + 80] + "\n")

    path_file = os.path.join(out_dir, "local_assembly_scaffold_path.txt")
    multi = [p for p in paths if len(p) > 1]
    with open(path_file, "w") as fp:
        fp.write(f"{len(multi)}\n")
        for p in multi:
            cl = p.contigs()
            fp.write(f"{len(cl)}\n")
            fp.write(" ".join(str(c) for c in cl) + " \n")
    log.info("scaffold: %d paths (%d multi-contig)", len(paths), len(multi))

    if not multi:
        import shutil
        shutil.copyfile(scaf_fa, os.path.join(out_dir, "scaffold.full.fasta"))
        log.warning("no multi-contig scaffold path; copied scaffolds.fasta")
    return path_file


def _join_contigs(g: AsmGraph, contigs: List[int]) -> str:
    """Join with 100 N, clamping existing holes to 1000 N (reference
    dump_edge_seq_reduce_N output.c:13-20)."""
    parts = []
    for e in contigs:
        s = _seq_with_clamped_holes(g, e)
        parts.append(s)
    return ("N" * NUMBER_N).join(parts)


def _seq_with_clamped_holes(g: AsmGraph, e: int) -> str:
    seq = g.get_seq(e)
    if e not in g.holes:
        return ACGT[seq].tobytes().decode()
    ph, lh = g.holes[e]
    parts = []
    prev = 0
    for p, l in zip(ph, lh):
        parts.append(ACGT[seq[prev : p + 1]].tobytes().decode())
        parts.append("N" * int(min(l, 1000)))
        prev = p + 1
    parts.append(ACGT[seq[prev:]].tobytes().decode())
    return "".join(parts)
