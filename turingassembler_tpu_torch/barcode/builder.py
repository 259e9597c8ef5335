"""Per-edge barcode aux info — rebuild of src/barcode_builder.c
(port of turingassembler_tpu/barcode/builder.py: the host tallies are
copies, the two mappers call the port's map_reads on `device`, or over
the shards of this process's GPUs (_library_mesh); with `stripe=(r, n)`
only every n-th archive batch from the r-th is mapped, the share of rank
r of a multi-process run).

The reference BWA-maps every read pair against a FASTA of all edges and
attaches the pair's barcode to the hit edge's barcode sets by mapped
position (read_mapper, barcode_builder.c:737-912):

  lvl0 / lvl1 / lvl2   pos <= 500 / 3000 / 10000
                       (CONTIG_LEVEL_0/1/2, assembly_graph.h:112-114)
  barcodes_cov         3000 < pos <= 10000
  barcodes_scaf        pos < min(5000, len/2) and the mapping is unique
  read-pair counts     (edge(r1), edge(r2)) tallies for candidates

Here the mapper is the batched minimizer voter (mapper/minimizers.py);
each edge and its rc are separate index targets, so a read near the tail
of e maps near the head of rc(e) — the same head-window effect the
reference gets from indexing both strand records.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import Config
from ..graph.structs import AsmGraph
from ..io.fastq import NT4
from ..io.native_loader import read_fastq_batches_native
from ..logging_utils import add_stage_wall, get_logger, timed_iter
from ..mapper.minimizers import EdgeMinimizerIndex, map_reads
from .sort_read import ReadPath

CONTIG_LEVEL_0 = 500      # reference assembly_graph.h:112
CONTIG_LEVEL_1 = 3000     # :113
CONTIG_LEVEL_2 = 10000    # :114
MIN_CONTIG_BARCODE = 5000  # :121
MAX_READ_FRAG_LEN = 350   # :117
RP_FULL_LEN_SLACK = 30    # DP-score stand-in for rp_count_mapper's
                          # aligned == read_len gate (barcode_builder.c:677)


def _iter_sorted_pairs(rpath: ReadPath, batch_size: int = 131072,
                       pad_to: int = 256, *, stripe=None):
    """Stream (bases1, len1, bases2, len2, barcodes) batches from the
    sorted archive through the host FASTQ reader; batch widths bucket to
    the library's read length (pipeline.batch_width).  The batch size
    decides the order in which the callers' dicts are filled, so it is
    part of the result.  With
    `stripe=(r, n)` only batches r, r + n, r + 2n, ... are yielded (the
    others are parsed and skipped)."""
    from ..pipeline import batch_width
    g1 = read_fastq_batches_native(rpath.R1_path, batch_size, pad_to,
                                   with_headers=True)
    g2 = read_fastq_batches_native(rpath.R2_path, batch_size, pad_to)
    for bi, (ba1, l1, hdrs) in enumerate(g1):
        ba2, l2, _ = next(g2)
        if stripe is not None and bi % stripe[1] != stripe[0]:
            continue   # another rank's batch (multi-process assembly3)
        comments = [h[h.find(b" ") + 1 :] if b" " in h else b""
                    for h in hdrs]
        yield (np.ascontiguousarray(ba1[:, : batch_width(l1)]), l1,
               np.ascontiguousarray(ba2[:, : batch_width(l2)]), l2,
               decode_barcode_comments(comments))


def decode_barcode_comments(comments) -> np.ndarray:
    """Vectorized 'BX:Z:<seq>' comment decode -> uint64 barcodes
    (BX_NONE for untagged reads).  The base-5 Horner decode runs as
    ~20 column ops over a padded byte matrix instead of a per-record
    python loop (matters at full-library scale: construct_aux_info
    streams every read)."""
    BX_NONE = np.uint64(0xFFFFFFFFFFFFFFFF)
    n = len(comments)
    bcs = np.full(n, BX_NONE, np.uint64)
    if n == 0:
        return bcs
    bseqs = []
    idxs = []
    for i, cm in enumerate(comments):
        if cm.startswith(b"BX:Z:"):
            sp = cm.find(b" ", 5)
            bseqs.append(cm[5:sp if sp >= 0 else len(cm)])
            idxs.append(i)
    if not bseqs:
        return bcs
    width = max(len(s) for s in bseqs)
    mat = np.array(bseqs, dtype=f"S{width}").view(np.uint8).reshape(len(bseqs), width)
    codes = NT4[mat].astype(np.uint64)
    vals = np.zeros(len(bseqs), np.uint64)
    for j in range(width):
        live = mat[:, j] != 0  # 'S' dtype null-pads short entries
        vals = np.where(live, vals * np.uint64(5) + codes[:, j], vals)
    bcs[np.asarray(idxs, np.int64)] = vals
    return bcs


def init_barcode_structs(g: AsmGraph) -> None:
    g.barcodes = [[{}, {}, {}] for _ in range(g.n_e)]
    g.barcodes_scaf = [{} for _ in range(g.n_e)]
    g.barcodes_cov = [{} for _ in range(g.n_e)]
    g.aux_flag |= 0x1  # ASM_HAVE_BARCODE


def _attach(g: AsmGraph, lens, e: int, pos: int, bc: int) -> None:
    if pos <= CONTIG_LEVEL_0:
        for lvl in (0, 1, 2):
            d = g.barcodes[e][lvl]
            d[bc] = d.get(bc, 0) + 1
    elif pos <= CONTIG_LEVEL_1:
        for lvl in (1, 2):
            d = g.barcodes[e][lvl]
            d[bc] = d.get(bc, 0) + 1
    elif pos <= CONTIG_LEVEL_2:
        d = g.barcodes[e][2]
        d[bc] = d.get(bc, 0) + 1
    if CONTIG_LEVEL_1 < pos <= CONTIG_LEVEL_2:
        d = g.barcodes_cov[e]
        d[bc] = d.get(bc, 0) + 1
    if pos < min(MIN_CONTIG_BARCODE, int(lens[e]) // 2):
        d = g.barcodes_scaf[e]
        d[bc] = d.get(bc, 0) + 1


# attach stores, in table order: barcodes lvl0/1/2, cov, scaf
N_ATTACH_STORES = 5


def attach_table(lens, edges: np.ndarray, pos: np.ndarray,
                 bcs: np.ndarray):
    """Pure (store, edge, barcode) -> count aggregation of one batch of
    mapped hits — the distributable half of barcode attachment: tables
    from different read shards merge by key-sum (merge_attach_tables;
    reference threaded aux-info, src/barcode_builder.c:408-436).

    Returns (store (M,) int8, edge (M,) int64, bc (M,) uint64,
    cnt (M,) int64), lexsorted by (store, edge, bc)."""
    mapped = edges >= 0
    valid = mapped & (bcs != np.uint64(0xFFFFFFFFFFFFFFFF))
    e = edges[valid].astype(np.int64)
    p = pos[valid].astype(np.int64)
    b = bcs[valid].astype(np.uint64)
    empty = (np.zeros(0, np.int8), np.zeros(0, np.int64),
             np.zeros(0, np.uint64), np.zeros(0, np.int64))
    if len(e) == 0:
        return empty
    half_len = np.minimum(MIN_CONTIG_BARCODE, lens[e] // 2)
    masks = [p <= CONTIG_LEVEL_0, p <= CONTIG_LEVEL_1, p <= CONTIG_LEVEL_2,
             (p > CONTIG_LEVEL_1) & (p <= CONTIG_LEVEL_2), p < half_len]
    ss, es, bs = [], [], []
    for s, mask in enumerate(masks):
        n = int(mask.sum())
        if n:
            ss.append(np.full(n, s, np.int8))
            es.append(e[mask])
            bs.append(b[mask])
    if not ss:
        return empty
    s = np.concatenate(ss)
    ee = np.concatenate(es)
    bb = np.concatenate(bs)
    order = np.lexsort((bb, ee, s))
    s, ee, bb = s[order], ee[order], bb[order]
    starts = np.ones(len(ee), bool)
    starts[1:] = (s[1:] != s[:-1]) | (ee[1:] != ee[:-1]) | (bb[1:] != bb[:-1])
    idx = np.flatnonzero(starts)
    cnt = np.diff(np.append(idx, len(ee))).astype(np.int64)
    return s[idx], ee[idx], bb[idx], cnt


def merge_attach_tables(tables):
    """Key-sum merge of attach tables from different read shards."""
    s = np.concatenate([t[0] for t in tables])
    e = np.concatenate([t[1] for t in tables])
    b = np.concatenate([t[2] for t in tables])
    c = np.concatenate([t[3] for t in tables])
    if len(s) == 0:
        return s, e, b, c
    order = np.lexsort((b, e, s))
    s, e, b, c = s[order], e[order], b[order], c[order]
    starts = np.ones(len(s), bool)
    starts[1:] = (s[1:] != s[:-1]) | (e[1:] != e[:-1]) | (b[1:] != b[:-1])
    idx = np.flatnonzero(starts)
    sums = np.add.reduceat(c, idx)
    return s[idx], e[idx], b[idx], sums.astype(np.int64)


def apply_attach_table(g: AsmGraph, table) -> None:
    """Fold an attach table into the per-edge barcode dicts."""
    s, ee, bb, cnt = table
    stores = [(g.barcodes, 0), (g.barcodes, 1), (g.barcodes, 2),
              (g.barcodes_cov, None), (g.barcodes_scaf, None)]
    # group by (store, edge)
    gstarts = np.ones(len(s), bool)
    gstarts[1:] = (s[1:] != s[:-1]) | (ee[1:] != ee[:-1])
    gidx = np.append(np.flatnonzero(gstarts), len(s))
    for j in range(len(gidx) - 1):
        lo, hi = gidx[j], gidx[j + 1]
        store, lvl = stores[int(s[lo])]
        d = store[int(ee[lo])][lvl] if lvl is not None else store[int(ee[lo])]
        for bc_, c_ in zip(bb[lo:hi].tolist(), cnt[lo:hi].tolist()):
            d[bc_] = d.get(bc_, 0) + int(c_)


def _bulk_attach(g: AsmGraph, lens, edges: np.ndarray, pos: np.ndarray,
                 bcs: np.ndarray) -> None:
    """Vectorized barcode attachment: aggregate (store, edge, bc) hits
    with one lexsort, then bulk-update the per-edge dicts.  Same
    semantics as the per-read _attach but ~50x less python overhead."""
    table = attach_table(lens, edges, pos, bcs)
    if len(table[0]):
        apply_attach_table(g, table)


def _mirror_hits(g: AsmGraph, lens: np.ndarray, e: np.ndarray,
                 p: np.ndarray, ql: np.ndarray):
    """Second strand record of every hit: (rc(e), len - pos - aligned).

    The reference indexes every edge AND its rc as separate FASTA
    records (write_fasta_seq, src/barcode_resolve2.c:1476-1488), so a
    uniquely-placed read yields exactly 2 best alignments — one per
    strand record — and read_mapper attaches/combines BOTH
    (src/barcode_builder.c:787-891, the ar.n == 2 gate).  The minimizer
    voter returns only the forward-matching record; this derives the
    mirror.  aligned is approximated by the on-edge overlap from the
    clamped public pos (off by the head-overhang for reads hanging past
    the edge start — bounded by one read length, below the 500/3000/
    10000 level granularity)."""
    m = e >= 0
    ec = np.clip(e, 0, g.n_e - 1).astype(np.int64)
    le = lens[ec]
    pc = np.maximum(p, 0).astype(np.int64)
    al = np.minimum(ql.astype(np.int64), np.maximum(le - pc, 0))
    e2 = np.where(m, g.edge_rc[ec], -1).astype(np.int32)
    p2 = np.where(m, le - pc - al, -1).astype(np.int32)
    return e2, p2


def _candidate_pair_keys(g: AsmGraph, hits1, hits2):
    """Candidate (e1, e2) read-pair tallies (reference read_mapper
    stage 3, src/barcode_builder.c:814-830): ALL n1 x n2 strand-record
    combos — (vote, mirror) per mate — gated per combo on
    pos1 + pos2 < fragment length and distinct non-rc edges, counted in
    both directed orders.  The pos gate selects the orientation-
    consistent combo: a junction-spanning FR pair sits near its
    records' HEADS only in the frame where the upstream edge is
    mirrored, so misoriented (e.g. same-genome-strand) pairs land on
    DIFFERENT keys than properly-oriented ones instead of polluting
    them.  hits = (edge, pos, mirror_edge, mirror_pos).
    Returns iterable of (packed_key, count)."""
    e1, p1, e1m, p1m = hits1
    e2, p2, e2m, p2m = hits2
    keys = []
    for ea, pa in ((e1, p1), (e1m, p1m)):
        for eb, pb in ((e2, p2), (e2m, p2m)):
            ok = (ea >= 0) & (eb >= 0) & (ea != eb) & \
                 (g.edge_rc[np.clip(ea, 0, g.n_e - 1)] != eb) & \
                 (pa + pb < MAX_READ_FRAG_LEN)
            pe1 = ea[ok].astype(np.int64)
            pe2 = eb[ok].astype(np.int64)
            if len(pe1):
                keys.append(pe1 * (1 << 32) + pe2)
                keys.append(pe2 * (1 << 32) + pe1)
    if not keys:
        return []
    uk, uc = np.unique(np.concatenate(keys), return_counts=True)
    return zip(uk.tolist(), uc.tolist())


def _library_mesh(device="cuda"):
    """Mesh for the full-library map stages: one shard a visible GPU,
    read-data-parallel (upstream's mapper thread fan-out,
    barcode_builder.c:408-436), when `device` is a GPU that names no
    index and this single process sees more than one.  None otherwise:
    a named GPU (`cuda:1`) maps on that GPU alone, and a multi-process
    run stripes batches per rank instead (a mesh over its ranks would
    need lockstep batch streams)."""
    import torch
    from ..parallel.distributed import dist_info
    dev = torch.device(device)
    if dist_info()[1] > 1 or dev.type != "cuda" or dev.index is not None:
        return None
    n_gpu = torch.cuda.device_count()
    if n_gpu < 2:
        return None
    from ..parallel.mesh import make_mesh
    return make_mesh(n_gpu, [f"cuda:{i}" for i in range(n_gpu)])


def aux_tables_striped(cfg: Config, g: AsmGraph, rpath: ReadPath, stripe,
                       index: Optional[EdgeMinimizerIndex] = None, *,
                       device="cuda"):
    """One rank's aux-info contribution over its batch stripe:
    (attach_table, candidate dict), the distributable reduction of
    construct_aux_info (multi-process assembly3; merge with
    merge_attach_tables and a dict key-sum, apply with
    parallel.sharded_aux.apply_aux_tables)."""
    from ..parallel.sharded_aux import aux_tables_local
    if index is None:
        t0 = time.perf_counter()
        index = EdgeMinimizerIndex.build(g, device=device)
        add_stage_wall("aux.index", time.perf_counter() - t0)
    tables = []
    cands: Dict = {}
    t_map = 0.0
    for b1, l1, b2, l2, bcs in timed_iter(
            _iter_sorted_pairs(rpath, stripe=stripe), "aux.parse"):
        t0 = time.perf_counter()
        # rank-local mapping: the ranks' batch stripes differ, so no
        # cross-rank collective may be entered here
        t, c = aux_tables_local(g, index, b1, l1, b2, l2, bcs, mesh=None,
                                device=device)
        tables.append(t)
        for k_, v in c.items():
            cands[k_] = cands.get(k_, 0) + v
        t_map += time.perf_counter() - t0
    add_stage_wall("aux.map", t_map)
    if not tables:
        tables.append((np.zeros(0, np.int8), np.zeros(0, np.int64),
                       np.zeros(0, np.uint64), np.zeros(0, np.int64)))
    return merge_attach_tables(tables), cands


def construct_aux_info(cfg: Config, g: AsmGraph, rpath: ReadPath,
                       index: Optional[EdgeMinimizerIndex] = None,
                       build_readpairs: bool = True, stripe=None, *,
                       device="cuda") -> AsmGraph:
    """Map all sorted read pairs (or the batches of `stripe`); attach
    barcode sets + read-pair counts."""
    if index is None:
        t0 = time.perf_counter()
        index = EdgeMinimizerIndex.build(g, device=device)
        add_stage_wall("aux.index", time.perf_counter() - t0)
    init_barcode_structs(g)
    lens = g.edge_len()
    n_pairs = n_mapped = 0
    t_map = t_attach = 0.0
    mesh = _library_mesh(device)
    for b1, l1, b2, l2, bcs in timed_iter(
            _iter_sorted_pairs(rpath, stripe=stripe), "aux.parse"):
        t0 = time.perf_counter()
        # graph=g turns on DP verification of every voted hit
        # (reference asm_reg2aln rescore, barcode_builder.c:448-563)
        e1, _, p1 = map_reads(index, b1, l1, graph=g, with_hits=False,
                              mesh=mesh, device=device)
        e2, _, p2 = map_reads(index, b2, l2, graph=g, with_hits=False,
                              mesh=mesh, device=device)
        t1 = time.perf_counter()
        n_pairs += len(b1)
        n_mapped += int((e1 >= 0).sum() + (e2 >= 0).sum())
        # every hit attaches on BOTH strand records — the reference's
        # n1 == 2 best alignments both enter the attach loops
        # (read_mapper, barcode_builder.c:832-891)
        e1m, p1m = _mirror_hits(g, lens, e1, p1, l1)
        e2m, p2m = _mirror_hits(g, lens, e2, p2, l2)
        _bulk_attach(g, lens, e1, p1, bcs)
        _bulk_attach(g, lens, e1m, p1m, bcs)
        _bulk_attach(g, lens, e2, p2, bcs)
        _bulk_attach(g, lens, e2m, p2m, bcs)
        if build_readpairs:
            for k_, c_ in _candidate_pair_keys(
                    g, (e1, p1, e1m, p1m), (e2, p2, e2m, p2m)):
                key = (k_ >> 32, k_ & 0xFFFFFFFF)
                nr, np_ = g.candidates.get(key, (0, 0))
                g.candidates[key] = (nr, np_ + int(c_))
        t_map += t1 - t0
        t_attach += time.perf_counter() - t1
    add_stage_wall("aux.map", t_map)
    add_stage_wall("aux.attach", t_attach)
    get_logger().info("aux info: %d pairs, %d mapped reads, %d candidate pairs",
                      n_pairs, n_mapped, len(g.candidates))
    return g


def get_read_pair_counts(cfg: Config, g: AsmGraph, rpath: ReadPath,
                         index: Optional[EdgeMinimizerIndex] = None,
                         stripe=None, *,
                         device="cuda") -> Dict[Tuple[int, int], int]:
    """Edge-pair read-pair counts (reference get_all_read_pairs_count,
    src/barcode_builder.c:287; feeds read_pairs_resolve).  With
    `stripe=(r, n)` only that rank's batch stripe is tallied; the dicts
    key-sum merge across ranks."""
    if index is None:
        t0 = time.perf_counter()
        index = EdgeMinimizerIndex.build(g, device=device)
        add_stage_wall("rp_count.index", time.perf_counter() - t0)
    counts: Dict[Tuple[int, int], int] = {}
    t_map = t_tally = 0.0
    mesh = _library_mesh(device)
    for b1, l1, b2, l2, bcs in timed_iter(
            _iter_sorted_pairs(rpath, stripe=stripe), "rp_count.parse"):
        t0 = time.perf_counter()
        # rp_count_mapper keeps only FULL-LENGTH >=50-score alignments
        # (a.aligned < len -> skip, score floor: reference
        # barcode_builder.c:676-705); the per-lane DP threshold
        # read_len - slack is the same full-length stand-in the bridge
        # path scorer uses
        ms1 = np.maximum(l1.astype(np.int64) - RP_FULL_LEN_SLACK, 50)
        ms2 = np.maximum(l2.astype(np.int64) - RP_FULL_LEN_SLACK, 50)
        e1, _, _ = map_reads(index, b1, l1, graph=g, min_score=ms1,
                             with_hits=False, mesh=mesh, device=device)
        e2, _, _ = map_reads(index, b2, l2, graph=g, min_score=ms2,
                             with_hits=False, mesh=mesh, device=device)
        t1 = time.perf_counter()
        ok = (e1 >= 0) & (e2 >= 0)
        # BOTH directed orders: the reference's 2x2 strand-record combos
        # reduce to exactly [v1][v2] += 1 and [v2][v1] += 1 in the
        # forward-record (vote) frame — the strand gate
        # (p1.strand == p2.strand, barcode_builder.c:705-707) dedups the
        # combos, it does not reject pairs.  Orientation consistency is
        # structural here: each read has exactly ONE forward record, so
        # the edge ids already encode the strands.
        pe1 = e1[ok].astype(np.int64)
        pe2 = e2[ok].astype(np.int64)
        keys = np.concatenate([pe1 * (1 << 32) + pe2,
                               pe2 * (1 << 32) + pe1])
        uk, uc = np.unique(keys, return_counts=True)
        for k_, c_ in zip(uk.tolist(), uc.tolist()):
            key = (k_ >> 32, k_ & 0xFFFFFFFF)
            counts[key] = counts.get(key, 0) + int(c_)
        t_map += t1 - t0
        t_tally += time.perf_counter() - t1
    add_stage_wall("rp_count.map", t_map)
    add_stage_wall("rp_count.tally", t_tally)
    return counts
