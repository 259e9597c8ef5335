"""Gap bridging stage — rebuild of src/build_bridge.c (port of
turingassembler_tpu/localasm/bridge.py, single process).

Bridge outcomes (upstream build_bridge.h:18-21 + try_bridging :376-425):
  LOCAL_NOT_FOUND  either flank unmapped -> join with 100 N
                   (join_bridge_dump :718-736)
  TRIVIAL          both flanks on one local edge -> splice through it
                   (join_trivial_bridge :586-624)
  MULTIPLE_PATH    path found -> stitch path sequence with k-overlaps
                   (join_bridge_by_path :634-664)
  PATH_NOT_FOUND   flanks mapped, no path -> synced flanks + 100 N
                   (join_bridge_no_path :692-716)

Path choice: candidate path center sequences are scored by mapping the
local reads to them (upstream writes a FASTA and BWA-maps;
get_path_scores :519-568); here the minimizer mapper votes on `device`
and the DP verifies (the NW kernel on "cuda"), and score = hits - errors
per path, best = max of (score - min_score) + (max_err - err).  The JAX
package pins this scoring to its host CPU; the port runs it on `device`.

Stage entry (build_bridge :842-946): parse local_assembly_scaffold_path.txt,
dedup consecutive pairs, build/caches per-pair local graphs, bridge each
adjacent pair, emit scaffold.full.fasta = bridged paths (overlap-deduped
via the suffix-trim trick of print_bridges :916-934) + unused contigs
>= 500 bp.  Gaps fan out over a thread pool of cfg.n_threads; the output
is the sequential order's, byte for byte.  The device calls of the
workers (the local graphs' bubble check, the path scoring) go to the
same device; ops/nw_align.py counts their launches under a lock.
"""

from __future__ import annotations

import os
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..barcode.sort_read import ReadPath, load_barcode_index
from ..config import Config
from ..device import resolve_device
from ..graph.structs import ACGT, AsmGraph
from ..io import asmg
from ..io.fastq import NT4
from ..logging_utils import get_logger
from ..mapper.minimizers import EdgeMinimizerIndex, map_reads, rescore_hits
from . import local as L

# per-phase wall accounting for the bridge stage; build_bridge logs the
# totals.  Gaps run concurrently, so phase values are summed THREAD-
# seconds (they exceed the stage wall under parallelism); the lock keeps
# the read-modify-write increments from losing deltas.  BRIDGE_COUNTS
# holds the stage's counts: the outcomes ("dump", "trivial", "path",
# "no_path"), and the path scorings and their candidate paths
# ("score_paths.calls", "score_paths.paths").
BRIDGE_PROF: Counter = Counter()
BRIDGE_COUNTS: Counter = Counter()
_PROF_LOCK = threading.Lock()


class _prof:
    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        self.t0 = time.time()

    def __exit__(self, *exc):
        dt = time.time() - self.t0
        with _PROF_LOCK:
            BRIDGE_PROF[self.key] += dt


BRIDGE_LOCAL_NOT_FOUND = 0
BRIDGE_TRIVIAL_BRIDGE = 1
BRIDGE_MULTIPLE_PATH = 2
BRIDGE_PATH_NOT_FOUND = 3
DUMP_N_LEN = 100             # build_bridge.h DUMP_N_LEN
MIN_OUTPUT_CONTIG_LEN = 500  # build_bridge.h
MIN_PROCESS_COV = 500        # build_bridge.c:15
_MISSING = object()          # reads_mem has no entry (its values may be None)


def _s(codes: np.ndarray) -> str:
    return ACGT[np.minimum(codes, 3)].tobytes().decode()


def _dump_n() -> str:
    return "N" * DUMP_N_LEN


def sync_global_local(gseq: str, lseq: str, gpos: L.SubseqPos, lpos: L.SubseqPos,
                      mode: str) -> str:
    """upstream sync_global_local_edge (build_bridge.c:130-175)."""
    if mode == "keep_global":
        return gseq[: gpos.start] + lseq[lpos.start :]
    if mode == "keep_local":
        return lseq[: lpos.end] + gseq[gpos.end :]
    if mode == "max_global":
        tail = gseq[gpos.end :] if len(gseq) - gpos.end > len(lseq) - lpos.end \
            else lseq[lpos.end :]
        return gseq[: gpos.start] + lseq[lpos.start : lpos.end] + tail
    # max_local
    head = gseq[: gpos.start] if gpos.start > lpos.start else lseq[: lpos.start]
    return head + lseq[lpos.start : lpos.end] + gseq[gpos.end :]


def join_bridge_dump(g: AsmGraph, e1: int, e2: int) -> str:
    return _s(g.get_seq(e1)) + _dump_n() + _s(g.get_seq(e2))


def join_trivial_bridge(g: AsmGraph, lg: AsmGraph, emap1: L.EdgeMap,
                        emap2: L.EdgeMap) -> str:
    e1s = _s(g.get_seq(emap1.gl_e))
    e2s = _s(g.get_seq(emap2.gl_e))
    ls = _s(lg.get_seq(emap1.lc_e))
    gpos1, gpos2 = emap1.gpos, emap2.gpos
    lpos1, lpos2 = emap1.lpos, emap2.lpos
    l2start, g2start = lpos2.start, gpos2.start
    if l2start < lpos1.end:
        diff = lpos1.end - l2start
        l2start = lpos1.end
        g2start += diff
    return e1s[: gpos1.end] + ls[lpos1.end : l2start] + e2s[g2start :]


def join_bridge_by_path(g: AsmGraph, lg: AsmGraph, path: List[int],
                        emap1: L.EdgeMap, emap2: L.EdgeMap) -> str:
    head = sync_global_local(_s(g.get_seq(emap1.gl_e)), _s(lg.get_seq(path[0])),
                             emap1.gpos, emap1.lpos, "keep_global")
    tail = sync_global_local(_s(g.get_seq(emap2.gl_e)), _s(lg.get_seq(path[-1])),
                             emap2.gpos, emap2.lpos, "keep_local")
    parts = [head]
    for e in path[1:-1]:
        parts.append(_s(lg.get_seq(e))[lg.ksize :])
    parts.append(tail[lg.ksize :])
    return "".join(parts)


def join_bridge_no_path(g: AsmGraph, lg: AsmGraph, emap1: L.EdgeMap,
                        emap2: L.EdgeMap) -> str:
    first = sync_global_local(_s(g.get_seq(emap1.gl_e)), _s(lg.get_seq(emap1.lc_e)),
                              emap1.gpos, emap1.lpos, "max_global")
    second = sync_global_local(_s(g.get_seq(emap2.gl_e)), _s(lg.get_seq(emap2.lc_e)),
                               emap2.gpos, emap2.lpos, "max_local")
    return first + _dump_n() + second


def path_center_seq(lg: AsmGraph, path: List[int]) -> str:
    parts = [_s(lg.get_seq(path[0]))]
    for e in path[1:]:
        parts.append(_s(lg.get_seq(e))[lg.ksize :])
    return "".join(parts)


MAX_READ_FRAG_LEN = 350    # upstream assembly_graph.h:117
FULL_LEN_SLACK = 30        # DP-score stand-in for "aligned == read len"


def path_read_hits(lg: AsmGraph, paths: List[List[int]], reads: np.ndarray,
                   lengths: np.ndarray, device="cuda"):
    """Map the reads to the candidate paths, each path indexed as two
    records (fw, rc), and verify every voted hit with the DP (BWA
    scoring, fit mode) against a per-lane full-length threshold (len -
    FULL_LEN_SLACK), all on `device`.  Returns (edges, starts, accept,
    scores, record lengths): per read its record (-1 unmapped), start,
    whether the DP accepted it and its score, and the records' lengths."""
    seqs = []
    for p in paths:
        s = NT4[np.frombuffer(path_center_seq(lg, p).encode(), np.uint8)]
        seqs.append(s)
        seqs.append((3 - s)[::-1])        # rc record
    cand = AsmGraph(ksize=lg.ksize)
    lens = np.array([len(s) for s in seqs], np.int64)
    cand.seq_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    cand.seq_data = (np.concatenate(seqs) if seqs
                     else np.zeros(0, np.uint8)).astype(np.uint8)
    cand.edge_source = np.zeros(len(seqs), np.int64)
    cand.edge_target = np.zeros(len(seqs), np.int64)
    rc = np.arange(len(seqs), dtype=np.int64)
    rc[0::2] += 1
    rc[1::2] -= 1
    cand.edge_rc = rc
    cand.edge_count = np.ones(len(seqs), np.int64)
    cand.node_rc = np.zeros(1, np.int64)
    idx = EdgeMinimizerIndex.build(cand, device=device)
    edges, _, starts = map_reads(idx, reads, lengths, device=device)
    # the per-lane full-length threshold keeps the gapless fast path
    # inside rescore_hits exact for THIS predicate (a fast-path lane
    # reports a lower bound that already clears it)
    accept, sc = rescore_hits(cand.seq_data, cand.seq_off, edges, starts,
                              reads, lengths,
                              min_score=lengths.astype(np.int64)
                              - FULL_LEN_SLACK, device=device)
    return edges, starts, accept, sc, lens


def score_paths(lg: AsmGraph, paths: List[List[int]], reads: np.ndarray,
                lengths: np.ndarray, n1: int, device="cuda") -> int:
    """Pick the best path by mapping the local read PAIRS to candidate
    sequences — upstream writes the candidates as FASTA, BWA-maps every
    pair, and counts per path (path_mapper,
    src/barcode_builder.c:571-649):
      score += 1  same path, opposite strands, |pos1-pos2| < 350
      err   += 1  same path, same strand within the fragment length
      err   += 1  a full-length-mapped mate with no proper partner
    then best = argmax (score - min_score) + (max_err - err), starting
    from path 0 at 0 (get_best_path, src/build_bridge.c:492-505).

    Strand = which record a mate hit (path_read_hits); only
    near-full-length alignments (score >= len - FULL_LEN_SLACK, the
    analogue of `aligned < l -> skip`) count.  reads rows [0, n1) are
    R1, [n1, 2*n1) the R2 mates."""
    n_paths = len(paths)
    if n_paths == 0:
        return -1
    edges, starts, _, sc, lens = path_read_hits(lg, paths, reads, lengths,
                                                device=device)
    full = (edges >= 0) & (sc >= lengths - FULL_LEN_SLACK)
    path_id = np.where(full, edges // 2, -1)
    strand = edges % 2
    # forward-coordinate position: rc-record hits mirror
    plen = lens[np.clip(edges, 0, len(lens) - 1)]
    pos_fw = np.where(strand == 0, starts,
                      plen - (starts + lengths)).astype(np.int64)

    score = np.zeros(n_paths, np.int64)
    err = np.zeros(n_paths, np.int64)
    p1, p2 = path_id[:n1], path_id[n1 : 2 * n1]
    s1, s2 = strand[:n1], strand[n1 : 2 * n1]
    f1, f2 = pos_fw[:n1], pos_fw[n1 : 2 * n1]
    both = (p1 >= 0) & (p2 >= 0) & (p1 == p2)
    near = np.abs(f1 - f2) < MAX_READ_FRAG_LEN
    proper = both & near & (s1 != s2)
    same_strand = both & near & (s1 == s2)
    np.add.at(score, p1[proper], 1)
    np.add.at(err, p1[same_strand], 1)
    unpaired1 = (p1 >= 0) & ~proper
    unpaired2 = (p2 >= 0) & ~proper
    np.add.at(err, p1[unpaired1], 1)
    np.add.at(err, p2[unpaired2], 1)

    min_score = score.min()
    max_err = err.max()
    combined = (score - min_score) + (max_err - err)
    best, best_val = 0, 0
    for i in range(n_paths):
        if combined[i] > best_val:
            best, best_val = i, int(combined[i])
    return best


def try_bridging(cfg: Config, g: AsmGraph, lg: AsmGraph, scaffolds: List[int],
                 emap1: L.EdgeMap, emap2: L.EdgeMap,
                 local_reads, device="cuda") -> Tuple[int, str]:
    if emap1.lc_e == -1 or emap2.lc_e == -1:
        return BRIDGE_LOCAL_NOT_FOUND, join_bridge_dump(g, emap1.gl_e, emap2.gl_e)
    if emap1.lc_e == emap2.lc_e:
        return BRIDGE_TRIVIAL_BRIDGE, join_trivial_bridge(g, lg, emap1, emap2)
    # filters
    with _prof("filters"):
        lg, emap1, emap2 = L.unrelated_filter(g, lg, emap1, emap2, scaffolds)
        if emap1.lc_e == -1 or emap2.lc_e == -1:
            return BRIDGE_LOCAL_NOT_FOUND, join_bridge_dump(g, emap1.gl_e,
                                                            emap2.gl_e)
        if emap1.lc_e == emap2.lc_e:
            return BRIDGE_TRIVIAL_BRIDGE, join_trivial_bridge(g, lg, emap1,
                                                              emap2)
        lg, emap1, emap2 = L.connection_filter(g, lg, emap1, emap2)
        lg, emap1, emap2 = L.coverage_filter(g, lg, emap1, emap2)
    if emap1.lc_e == -1 or emap2.lc_e == -1:
        return BRIDGE_LOCAL_NOT_FOUND, join_bridge_dump(g, emap1.gl_e, emap2.gl_e)
    if emap1.lc_e == emap2.lc_e:
        return BRIDGE_TRIVIAL_BRIDGE, join_trivial_bridge(g, lg, emap1, emap2)

    check_k = lg.ksize + cfg.bridge.ksize_check_delta  # KSIZE_CHECK
    kset = set()
    if local_reads is not None:
        bases, lengths, _ = local_reads
        with _prof("kmer_set"):
            kset = L.read_kmer_set(bases, lengths, check_k)
    with _prof("path_search"):
        paths = L.get_all_paths_kmer_check(lg, emap1, emap2, check_k, kset)
    if not paths:
        return BRIDGE_PATH_NOT_FOUND, join_bridge_no_path(g, lg, emap1, emap2)
    if len(paths) == 1 or local_reads is None:
        best = 0
    else:
        with _prof("score_paths"):
            best = score_paths(lg, paths, *local_reads, device=device)
        with _PROF_LOCK:
            BRIDGE_COUNTS["score_paths.calls"] += 1
            BRIDGE_COUNTS["score_paths.paths"] += len(paths)
    return BRIDGE_MULTIPLE_PATH, join_bridge_by_path(g, lg, paths[best],
                                                     emap1, emap2)


# ---------------------------------------------------------------------------
# the stage entry
# ---------------------------------------------------------------------------

def parse_scaffold_paths(path_file: str) -> List[List[int]]:
    with open(path_file) as fp:
        tokens = fp.read().split()
    it = iter(tokens)
    n = int(next(it))
    out = []
    for _ in range(n):
        ln = int(next(it))
        out.append([int(next(it)) for _ in range(ln)])
    return out


def build_bridge(cfg: Config, g: AsmGraph, rpath: ReadPath,
                 scaffold_path_file: str, out_dir: Optional[str] = None,
                 device="cuda") -> str:
    """Bridge every gap of the scaffold paths by local assembly and
    write scaffold.full.fasta into out_dir (default cfg.out_dir);
    returns its path.  The local graphs' bubble check and the path
    scoring run on `device`; the rest is host code."""
    resolve_device(device)
    log = get_logger()
    out_dir = out_dir or cfg.out_dir
    os.makedirs(out_dir, exist_ok=True)
    paths = parse_scaffold_paths(scaffold_path_file)
    bc_index = load_barcode_index(rpath.idx_path)
    cov = g.edge_cov()

    mark = np.zeros(g.n_e, bool)
    for p in paths:
        for e in p:
            mark[e] = mark[int(g.edge_rc[e])] = True

    BRIDGE_PROF.clear()
    BRIDGE_COUNTS.clear()
    L.clear_global_window_cache()
    L.graph_token(g)        # drawn here, before any worker thread asks
    with _prof("prebuild"):
        lg_mem, reads_mem = _prebuild_local_graphs(cfg, g, rpath, bc_index,
                                                   paths, cov, out_dir,
                                                   device)

    # per-gap bridging fans out over the thread pool (upstream
    # build_bridge_iterator xT, src/build_bridge.c:842-946,952-1017);
    # gaps are independent, so computing them concurrently and writing
    # in path order is byte-identical to the sequential loop
    jobs = []                            # (pi, j, e1, e2, dump_only)
    for pi, p in enumerate(paths):
        for j in range(1, len(p)):
            e1, e2 = p[j - 1], p[j]
            dump = cov[e1] > MIN_PROCESS_COV or cov[e2] > MIN_PROCESS_COV
            jobs.append((pi, j, e1, e2, dump))

    def _work(job):
        pi, j, e1, e2, dump = job
        if dump:
            return BRIDGE_LOCAL_NOT_FOUND, join_bridge_dump(g, e1, e2)
        return _bridge_pair(cfg, g, rpath, bc_index, paths[pi], e1, e2,
                            out_dir, lg_mem, reads_mem, device)

    if len(jobs) > 1 and cfg.n_threads > 1:
        with ThreadPoolExecutor(max_workers=cfg.n_threads) as ex:
            results = list(ex.map(_work, jobs))
    else:
        results = [_work(jb) for jb in jobs]

    out_fa = os.path.join(out_dir, "scaffold.full.fasta")
    n_types = [0, 0, 0, 0]
    by_gap = {}
    for (pi, j, _, _, _), (res, seq) in zip(jobs, results):
        n_types[res] += 1
        by_gap[(pi, j)] = seq
    with open(out_fa, "w") as f:
        for pi, p in enumerate(paths):
            bridged = [by_gap[(pi, j)] for j in range(1, len(p))]
            f.write(f">contig_{pi}\n")
            f.write(_merge_bridges(g, p, bridged))
            f.write("\n")
        for i in range(g.n_e):
            if g.edge_len(i) < MIN_OUTPUT_CONTIG_LEN or g.edge_source[i] < 0:
                continue
            if not mark[i]:
                rc = int(g.edge_rc[i])
                f.write(f">{i}_{rc}\n{_s(g.get_seq(i))}\n")
                mark[rc] = True
    BRIDGE_COUNTS.update(dict(zip(("dump", "trivial", "path", "no_path"),
                                  n_types)))
    log.info("bridging done: dump=%d trivial=%d path=%d no-path=%d",
             n_types[0], n_types[1], n_types[2], n_types[3])
    if BRIDGE_PROF:
        log.info("bridge phase walls: %s",
                 " ".join(f"{k}={v:.1f}s" for k, v in
                          sorted(BRIDGE_PROF.items(), key=lambda x: -x[1])))
    return out_fa


def _local_cache_path(cfg, g, e1, e2, out_dir):
    return os.path.join(out_dir, f"local_assembly_{int(g.edge_rc[e1])}_{e2}",
                        f"graph_k_{cfg.lk}_local_lvl_1.bin")


def _save_graph_atomic(lg: AsmGraph, path: str) -> None:
    """Write to a file of this thread's own and rename it into place, so
    two workers building the same gap never leave a torn cache file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    asmg.save_graph(lg, tmp)
    os.replace(tmp, path)


def prebuild_local_graphs_striped(cfg, g: AsmGraph, rpath: ReadPath,
                                  scaffold_path_file: str, out_dir: str,
                                  stripe, device="cuda") -> int:
    """One rank's share of the per-gap local assemblies (multi-process
    assembly3): gaps are independent and cached in the shared out_dir,
    so rank r building gaps r mod n of the sorted cache paths leaves rank
    0's bridging loop with cache hits only, and the same output as if it
    had built every gap itself (upstream's thread pool,
    src/build_bridge.c:898-903, scaled out to processes).  Returns the
    number of gaps this rank built."""
    resolve_device(device)
    paths = parse_scaffold_paths(scaffold_path_file)
    bc_index = load_barcode_index(rpath.idx_path)
    cov = g.edge_cov()
    L.clear_global_window_cache()
    L.graph_token(g)        # drawn here, before any worker thread asks
    lg_mem, _ = _prebuild_local_graphs(cfg, g, rpath, bc_index, paths, cov,
                                       out_dir, device, stripe=stripe)
    return len(lg_mem)


def _prebuild_local_graphs(cfg, g, rpath, bc_index, paths, cov, out_dir,
                           device="cuda", stripe=None):
    """Task-parallel per-gap local assemblies (upstream thread-pool
    loop build_bridge_iterator xT, src/build_bridge.c:898-903,952).
    Each gap is independent; cfg.n_threads (-t) bounds the pool.  The
    bridging loop afterwards hits the per-pair caches, so outputs are
    identical to the sequential order.

    Returns (lg_mem, reads_mem): the built graphs and fetched read sets
    keyed by cache path, so the bridging loop neither re-reads the
    graph from disk nor re-fetches the same barcode read sets."""
    lg_mem: Dict[str, AsmGraph] = {}
    reads_mem: Dict[str, tuple] = {}
    jobs = {}
    for p in paths:
        for j in range(1, len(p)):
            e1, e2 = p[j - 1], p[j]
            if cov[e1] > MIN_PROCESS_COV or cov[e2] > MIN_PROCESS_COV:
                continue
            cache = _local_cache_path(cfg, g, e1, e2, out_dir)
            if cache not in jobs and not os.path.exists(cache):
                jobs[cache] = (e1, e2)
    if stripe is not None:
        pid, n = stripe
        jobs = {c: j for i, (c, j) in enumerate(sorted(jobs.items()))
                if i % n == pid}
    if not jobs:
        return lg_mem, reads_mem

    # batched counting: every gap's canonical (k+1)-mers go through ONE
    # sort pass keyed by a gap-id column (count_kedges_multi) instead of
    # a small count per gap; the graph build / resolve per gap then fans
    # out over the thread pool
    items = sorted(jobs.items())
    read_sets = []
    for cache, (e1, e2) in items:
        got = L.local_reads_for_pair(g, rpath, bc_index, e1, e2)
        reads_mem[cache] = got
        read_sets.append(None if got is None else (got[0], got[1]))
    tables = L.count_kedges_multi(read_sets, cfg.lk)

    def build_one(i):
        cache, (e1, e2) = items[i]
        if read_sets[i] is None:
            return
        lg = L.build_local_graph(cfg, g, rpath, bc_index, e1, e2,
                                 precounted=tables[i], device=device)
        if lg is not None:
            _save_graph_atomic(lg, cache)
            lg_mem[cache] = lg

    with ThreadPoolExecutor(max_workers=max(cfg.n_threads, 1)) as ex:
        list(ex.map(build_one, range(len(items))))
    return lg_mem, reads_mem


def _bridge_pair(cfg, g, rpath, bc_index, scaffolds, e1, e2, out_dir,
                 lg_mem=None, reads_mem=None, device="cuda"):
    cache = _local_cache_path(cfg, g, e1, e2, out_dir)
    # pop, not get: try_bridging's filters tombstone lg in place, so a
    # duplicate (e1, e2) job must reload a fresh copy from disk exactly
    # as the sequential loop did
    lg = lg_mem.pop(cache, None) if lg_mem else None
    with _prof("load_or_build_graph"):
        if lg is None and os.path.exists(cache):
            lg = asmg.load_graph(cache)
        elif lg is None:
            lg = L.build_local_graph(cfg, g, rpath, bc_index, e1, e2,
                                     device=device)
            if lg is not None:
                _save_graph_atomic(lg, cache)
    if lg is None or lg.n_e == 0:
        return BRIDGE_LOCAL_NOT_FOUND, join_bridge_dump(g, e1, e2)
    with _prof("flank_map"):
        emap1 = L.get_local_edge_head(g, lg, e1)
        emap2 = L.get_local_edge_tail(g, lg, e2)
    # one atomic pop: each entry has exactly one consumer (a duplicate
    # gap's second job finds it gone and fetches again), and retaining
    # every gap's read matrices would grow peak RSS with total gaps
    local_reads = reads_mem.pop(cache, _MISSING) if reads_mem is not None \
        else _MISSING
    if local_reads is _MISSING:
        with _prof("fetch_reads"):
            local_reads = L.local_reads_for_pair(g, rpath, bc_index, e1, e2)
    return try_bridging(cfg, g, lg, scaffolds, emap1, emap2, local_reads,
                        device)


def _merge_bridges(g: AsmGraph, path: List[int], bridged: List[str]) -> str:
    """Concatenate per-gap bridge sequences, trimming the shared contig
    between consecutive bridges (upstream print_bridges
    build_bridge.c:916-934: suffix-match the next contig against the
    bridge to find the replace point)."""
    out = []
    last_replace = 0
    for j in range(1, len(path)):
        seq = _s(g.get_seq(path[j]))
        b = bridged[j - 1]
        p_org, p_bridge = len(seq), len(b)
        while p_org > 0 and p_bridge > 0 and seq[p_org - 1] == b[p_bridge - 1]:
            p_org -= 1
            p_bridge -= 1
        if j + 1 < len(path):
            b = b[:p_bridge]
        out.append(b[last_replace:])
        last_replace = p_org
    return "".join(out)
