"""Edge-coverage recount at k=31 — rebuild of src/coverage/kmer_count.c
(port of turingassembler_tpu/kmer/coverage.py: the table and the join
are host copies, the streaming count is the port's sort-based engine on
`device`).

Semantics mirrored: a table over the distinct *forward* 31-mers of all
edges (index_bin_edge :68-85 — no canonicalization; reads contribute
both their forward and reverse-complement k-mers, get_and_add_kmer
:87-110); each edge's new count is the sum over its k-mer occurrences of
min(count, 999) (MAX_KMER_COUNT, add_cnt_to_graph :113-137), then
symmetrized with max(e, rc).

Formulation: sorted unique k-mer table, a canonical count of the read
windows (kmer/megasort.py), one host searchsorted to join them, and a
segment sum per edge.
"""

from __future__ import annotations

import time

import numpy as np

from ..device import resolve_device
from ..graph.structs import AsmGraph
from ..logging_utils import add_stage_wall, stage_walls, timed_iter
from ..ops import limbs as lb
from .megasort import count_kedges_megasort

KMER_SIZE_COVERAGE = 31   # reference kmer_count.c:14
MAX_KMER_COUNT = 999      # :15


def build_edge_kmer_table(g: AsmGraph, k: int = KMER_SIZE_COVERAGE):
    """Returns (table (M, nl) sorted unique fw k-mers, edge_rows
    (R, 2) = (table_idx, edge_id) occurrence list)."""
    rows = []
    occ = []
    for e in range(g.n_e):
        if g.edge_source[e] < 0 or g.edge_len(e) < k + 1:
            continue
        seq = g.get_seq(e)
        n = len(seq) - k + 1
        if n <= 0:
            continue
        packed = lb.np_pack_bases(
            np.lib.stride_tricks.sliding_window_view(seq, k), k)
        rows.append(packed)
        occ.append(np.full(n, e, np.int64))
    if not rows:
        nl = lb.n_limbs(k)
        return np.zeros((0, nl), np.uint32), np.zeros((0, 2), np.int64)
    allk = np.concatenate(rows)
    alle = np.concatenate(occ)
    order = lb.np_lexsort_rows(allk)
    allk, alle = allk[order], alle[order]
    starts = np.ones(len(allk), bool)
    starts[1:] = np.any(allk[1:] != allk[:-1], axis=1)
    table = allk[starts]
    tidx = np.cumsum(starts) - 1
    edge_rows = np.stack([tidx, alle], axis=1)
    return np.ascontiguousarray(table), edge_rows


def _rows_to_u64(limbs: np.ndarray) -> np.ndarray:
    """(N, 2) uint32 lexicographic rows -> (N,) uint64 preserving order."""
    assert limbs.shape[1] == 2
    return (limbs[:, 0].astype(np.uint64) << np.uint64(32)) | \
        limbs[:, 1].astype(np.uint64)


def count_reads_into_table(table: np.ndarray, reads: np.ndarray,
                           lengths: np.ndarray, k: int = KMER_SIZE_COVERAGE,
                           batch_size: int = 8192, *,
                           device="cuda") -> np.ndarray:
    """Per-table-entry read-window counts (fw + rc strands).

    A table key's fw+rc window hit count equals the CANONICAL k-mer
    count of canon(key) — the forward and reverse window multisets of a
    read are mutually RC — so the count engine does the streaming, and
    the table join is ONE host searchsorted over the unique keys."""
    device = resolve_device(device)
    M = len(table)
    counts = np.zeros(M, np.int64)
    if M == 0 or len(reads) == 0:
        return counts
    lengths = np.ascontiguousarray(lengths, np.int32)
    batches = ((reads[i:i + batch_size], lengths[i:i + batch_size])
               for i in range(0, len(reads), batch_size))
    # the count engine counts (k+1)-mers of its `k` argument
    uniq, ucnt = count_kedges_megasort(batches, k - 1, device=device)
    return _join_canonical(table, uniq, ucnt, k)


def recount_coverage_from_batches(g: AsmGraph, batches,
                                  k: int = KMER_SIZE_COVERAGE, *,
                                  device="cuda") -> AsmGraph:
    """Streaming recount: same as recount_coverage but over a
    (bases, lengths) batch iterable, so the library is never held in
    host memory as a whole."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    table, edge_rows = build_edge_kmer_table(g, k)
    t1 = time.perf_counter()
    counts = np.zeros(len(table), np.int64)
    parse0 = stage_walls().get("recount.parse", 0.0)
    if len(table):
        uniq, ucnt = count_kedges_megasort(
            timed_iter(batches, "recount.parse"), k - 1, device=device)
        t2 = time.perf_counter()
        counts = _join_canonical(table, uniq, ucnt, k)
    else:
        t2 = t1
    g = _apply_counts(g, table, edge_rows, counts)
    # the count's own time: its wall less its wait on the batches
    parse = stage_walls().get("recount.parse", 0.0) - parse0
    add_stage_wall("recount.table", t1 - t0)
    add_stage_wall("recount.count", t2 - t1 - parse)
    add_stage_wall("recount.join", time.perf_counter() - t2)
    return g


def recount_coverage(g: AsmGraph, reads: np.ndarray, lengths: np.ndarray,
                     k: int = KMER_SIZE_COVERAGE, *,
                     device="cuda") -> AsmGraph:
    """Replace edge counts with the k=31 recount (reference
    build_coverage_process, process.c:823-834)."""
    table, edge_rows = build_edge_kmer_table(g, k)
    counts = count_reads_into_table(table, reads, lengths, k, device=device)
    return _apply_counts(g, table, edge_rows, counts)


def _join_canonical(table: np.ndarray, uniq: np.ndarray, ucnt: np.ndarray,
                    k: int) -> np.ndarray:
    """Per-table-entry counts from a canonical unique-count run (see
    count_reads_into_table for why the equivalence is exact)."""
    counts = np.zeros(len(table), np.int64)
    if len(uniq) == 0:
        return counts
    rc = lb.np_revcomp_limbs_fast(np.ascontiguousarray(table), k)
    canon = np.where(lb.np_lex_lt(rc, table)[:, None], rc, table)
    u64 = _rows_to_u64(uniq)
    q64 = _rows_to_u64(canon)
    pos = np.searchsorted(u64, q64)
    posc = np.minimum(pos, len(u64) - 1)
    found = u64[posc] == q64
    counts[found] = ucnt[posc[found]]
    return counts


def _apply_counts(g: AsmGraph, table, edge_rows, counts) -> AsmGraph:
    clamped = np.minimum(counts, MAX_KMER_COUNT)
    new_counts = np.zeros(g.n_e, np.int64)
    if len(edge_rows):
        np.add.at(new_counts, edge_rows[:, 1], clamped[edge_rows[:, 0]])
    # symmetrize (reference add_cnt_to_graph tail)
    rc = g.edge_rc.copy()
    ok = rc >= 0
    sym = new_counts.copy()
    sym[ok] = np.maximum(new_counts[ok], new_counts[rc[ok]])
    g.edge_count = sym
    return g
