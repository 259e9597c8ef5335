"""The reference's count and level-0 graph of a library too large for
kmers.count and unitigs.build, plain: the same answers, computed in
pieces that fit the card.

kmers.count keeps each 2^26-row group's unique rows and unions them all
at the end, and unitigs.build decodes every k-edge into one int64 a base;
at a human chromosome (2.56 G window rows a library, 90 M kept k-edges)
either would hold tens of GB more than the card has.  Here:

  count   one sweep of the reads; each block's window rows go to their
          partition by the first limb of the canonical row (ranges cut
          so that each takes about as many rows, since a canonical
          row's first limb is the smaller of two); a partition keeps a
          running table, into which it folds its pending rows (unique,
          then a union with the table) every GROUP_ROWS rows.  The
          partitions, joined in order, are ascending.
  build   unitigs.build's steps, with each lane's end k-mers and end
          bases made a block of k-edges at a time and the heads' first
          k bases decoded from their rows alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import compare, kmers, unitigs
from . import level0 as ref0
from .unitigs import RefGraph

PARTS = 16               # partitions of the canonical rows
GROUP_ROWS = 1 << 24     # a partition's pending rows before a fold
READ_BLOCK = 1 << 16     # reads a block of the sweep
ROW_BLOCK = 1 << 21      # k-edges decoded at a time


def partition_bounds(parts: int, k1: int) -> list:
    """parts + 1 ascending first-limb values: partition i holds the rows
    whose first limb lies in [b[i], b[i+1]).  For random sequence the
    canonical row's first limb, taken as a fraction x of its range, is
    the smaller of two uniform ones, P(< x) = 1 - (1 - x)^2, so the cut
    at i / parts gives each partition as many rows."""
    top = 1 << (2 * min(k1, kmers.LIMB))
    cuts = [int(top * (1 - math.sqrt(1 - i / parts))) for i in range(parts)]
    return cuts + [top]


class _Partition:
    """A partition's running table: its unique rows ascending and their
    counts, and the rows not yet folded in."""

    def __init__(self):
        self.pend, self.n_pend = [], 0
        self.rows = self.counts = None

    def add(self, rows: torch.Tensor) -> None:
        self.pend.append(rows)
        self.n_pend += len(rows)
        if self.n_pend >= GROUP_ROWS:
            self.fold()

    def fold(self) -> None:
        if not self.pend:
            return
        u, c, _ = kmers.unique_rows(torch.cat(self.pend))
        self.pend, self.n_pend = [], 0
        if self.rows is not None:
            u, c, _ = kmers.unique_rows(torch.cat([self.rows, u]),
                                        torch.cat([self.counts, c]))
        self.rows, self.counts = u, c


def count(reads, k1: int, min_count: int, device,
          fingerprinted: bool = False):
    """kmers.count's answer, (rows ascending, counts int64) kept where
    the count is at least min_count, in one sweep of `reads` (an
    iterable of host (bases (B, W) uint8, lengths (B,)) arrays) over
    PARTS partitions.  With `fingerprinted` each partition's rows are
    told apart by kmers.fingerprint32 alone before the cutoff
    (kmers.merge_by_fingerprint, a partition at a time)."""
    parts = PARTS
    bounds = torch.tensor(partition_bounds(parts, k1), device=device)
    table = [_Partition() for _ in range(parts)]
    for bases, lengths in reads:
        for i in range(0, len(bases), READ_BLOCK):
            rows = kmers.window_rows(
                torch.as_tensor(bases[i:i + READ_BLOCK]).to(device),
                torch.as_tensor(lengths[i:i + READ_BLOCK]).to(device), k1)
            part = torch.bucketize(rows[:, 0].contiguous(), bounds,
                                   right=True) - 1
            order = torch.sort(part, stable=True).indices
            sizes = torch.bincount(part, minlength=parts).tolist()
            # a piece copied out, so no partition holds the block
            for p, piece in zip(table, torch.split(rows[order], sizes)):
                if len(piece):
                    p.add(piece.clone())
    out_r, out_c = [], []
    for p in table:
        p.fold()
        if p.rows is None:
            continue
        u, c = p.rows, p.counts
        p.rows = p.counts = None
        if fingerprinted:
            u, c = kmers.merge_by_fingerprint(u, c)
        keep = c >= min_count
        out_r.append(u[keep])
        out_c.append(c[keep])
    if not out_r:
        return (torch.zeros((0, kmers.n_limbs(k1)), dtype=torch.int64,
                            device=device),
                torch.zeros(0, dtype=torch.int64, device=device))
    return torch.cat(out_r), torch.cat(out_c)


def _lanes(rows: torch.Tensor, k1: int, fw: bool) -> torch.Tensor:
    """(m, k1) codes of the k-edges' forward lanes, or of their reverse
    complements."""
    codes = kmers.decode(rows, k1)
    return codes if fw else (3 - codes).flip(1)


def build(rows: torch.Tensor, counts: torch.Tensor, k: int) -> RefGraph:
    """unitigs.build's RefGraph of the canonical k-edges `rows` ((n,
    n_limbs(k+1)) int64) with their `counts`, made block by block."""
    dev = rows.device
    n = len(rows)
    if n == 0:
        return unitigs.build(rows, counts, k)
    D = 2 * n
    block = ROW_BLOCK
    # every lane's source k-mer (first D rows) and target k-mer (last D),
    # its first and last base; lane n + i is k-edge i reverse-complemented
    ends = torch.empty((2 * D, kmers.n_limbs(k)), dtype=torch.int64,
                       device=dev)
    first = torch.empty(D, dtype=torch.uint8, device=dev)
    last = torch.empty(D, dtype=torch.uint8, device=dev)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        for base, fw in ((0, True), (n, False)):
            lanes = _lanes(rows[lo:hi], k + 1, fw)
            ends[base + lo:base + hi] = kmers.encode(lanes[:, :k])
            ends[D + base + lo:D + base + hi] = kmers.encode(lanes[:, 1:])
            first[base + lo:base + hi] = lanes[:, 0]
            last[base + lo:base + hi] = lanes[:, k]
            del lanes
    ids = kmers.unique_rows(ends)[2]
    del ends
    src, tgt = ids[:D], ids[D:]
    m = int(ids.max()) + 1
    del ids
    # from here on unitigs.build's steps, with first and last for the
    # lanes' end bases
    outdeg = torch.bincount(torch.unique(src * 4 + last) // 4, minlength=m)
    indeg = torch.bincount(torch.unique(tgt * 4 + first) // 4, minlength=m)
    lane = torch.arange(D, device=dev)
    leaving = torch.full((m,), -1, dtype=torch.int64, device=dev)
    leaving[src] = lane
    through = (outdeg[tgt] == 1) & (indeg[tgt] == 1)
    del outdeg, indeg
    nxt = torch.where(through, leaving[tgt], -1)
    nxt = torch.where(nxt == lane, -1, nxt)
    del leaving, through
    pred = torch.full((D,), -1, dtype=torch.int64, device=dev)
    pred[nxt[nxt >= 0]] = lane[nxt >= 0]
    del nxt

    head, dist = unitigs._rank(pred)
    cyc = pred[head] >= 0
    circ_head = torch.zeros(D, dtype=torch.bool, device=dev)
    if bool(cyc.any()):
        low, p = lane.clone(), torch.where(pred >= 0, pred, lane)
        for _ in range(math.ceil(math.log2(D + 1)) + 1):
            low = torch.minimum(low, low[p])
            p = p[p]
        circ_head = cyc & (low == lane)
        pred = torch.where(circ_head, -1, pred)
        head, dist = unitigs._rank(pred)
        del low, p
    del cyc

    heads = torch.nonzero(pred < 0).squeeze(1)
    del pred
    uid = torch.full((D,), -1, dtype=torch.int64, device=dev)
    uid[heads] = torch.arange(len(heads), device=dev)
    u = uid[head]
    del uid, head
    nu = len(heads)
    ulen = torch.bincount(u, minlength=nu)
    off = torch.zeros(nu + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(k + ulen, 0)
    pool = torch.empty(int(off[-1]), dtype=torch.uint8, device=dev)
    cols = torch.arange(k, device=dev)[None, :]
    for lo in range(0, nu, block):
        h = heads[lo:lo + block]
        fw = h < n
        codes = torch.empty((len(h), k + 1), dtype=torch.uint8, device=dev)
        codes[fw] = _lanes(rows[h[fw]], k + 1, True)
        codes[~fw] = _lanes(rows[h[~fw] - n], k + 1, False)
        pool[off[lo:lo + len(h), None] + cols] = codes[:, :k]
    pool[off[u] + k + dist] = last
    count = torch.zeros(nu, dtype=torch.int64, device=dev).index_add_(
        0, u, counts.long()[lane % n])
    tail = torch.empty(nu, dtype=torch.int64, device=dev)
    is_tail = dist == ulen[u] - 1
    tail[u[is_tail]] = lane[is_tail]
    host = lambda t: t.cpu().numpy()     # noqa: E731
    return RefGraph(k, host(pool), host(off), host(count), host(src[heads]),
                    host(tgt[tail]), host(circ_head[heads]))


def table_and_graph(lib, k: int, min_count: int, device,
                    fingerprinted: bool = False):
    """(rows, counts, RefGraph) of a library, as level0.table_and_graph
    gives them."""
    rows, counts = count(ref0.reads(lib), k + 1, min_count, device,
                         fingerprinted)
    return rows, counts, build(rows, counts, k)


def program_table(rows: np.ndarray, counts: np.ndarray, k1: int, device):
    """compare.program_table, ROW_BLOCK rows at a time."""
    out = torch.empty((len(rows), kmers.n_limbs(k1)), dtype=torch.int64,
                      device=device)
    for lo in range(0, len(rows), ROW_BLOCK):
        part = torch.as_tensor(rows[lo:lo + ROW_BLOCK]).to(device)
        out[lo:lo + len(part)] = kmers.encode(
            compare.program_rows_to_codes(part, k1))
    return out, torch.as_tensor(counts).to(device).long()
