"""Sort-based canonical (k+1)-mer counting (port of
turingassembler_tpu/kmer/megasort.py, in-memory path).

Reads go to the device once as a (N, L) uint8 code tensor (255 padding)
plus int32 lengths.  Each chunk of reads becomes the canonical limb rows
of its valid windows (ops/kmers.py); every `flush_lanes` rows the window
is sorted lexicographically (stable LSD passes, one `torch.sort` per
limb) and run-length counted, and the unique run is merged into the
running table (concat + re-sort, counts summed).

Invalid windows are dropped before the sort (the JAX package keeps them
as all-ones sentinel rows), so no key can be confused with a sentinel
and the sort needs no validity column when 2(k+1) % 32 == 0.  Tables are
sized from
the data: (uniq (n, nl) int64, counts (n,) int32, n), sorted ascending.
The JAX package's static-capacity retries (out_cap overflow) have no
counterpart, because no capacity is fixed ahead of the data.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import kmers as km
from ..ops import limbs as lb


def _extract_chunk(bases: torch.Tensor, lengths: torch.Tensor,
                   k1: int) -> torch.Tensor:
    """One read chunk -> limb rows (n_valid, nl) of its valid canonical
    (k1)-mer windows, in ascending (read, window) order."""
    canon, _, valid = km.extract_canonical_kmers(bases, lengths, k1)
    return canon[valid]


def _sort_count(keys: torch.Tensor):
    """Sort limb rows and run-length count the unique keys.
    Returns (uniq (n, nl) int64 ascending, counts (n,) int32)."""
    s = keys[lb.lex_order(keys)]
    starts = torch.nonzero(lb.run_starts(s)).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([s.shape[0]])])
    return s[starts], (ends - starts).to(torch.int32)


def _merge_unique_runs(ka, ca, kb, cb):
    """Merge two sorted unique (keys, counts) runs; keys present in both
    get the sum of their counts."""
    keys = torch.cat([ka, kb])
    w = torch.cat([ca, cb])
    perm = lb.lex_order(keys)
    s, sw = keys[perm], w[perm]
    new = lb.run_starts(s)
    seg = torch.cumsum(new, 0) - 1
    uniq = s[new]
    counts = torch.zeros(uniq.shape[0], dtype=torch.int32, device=s.device)
    counts.index_add_(0, seg, sw)
    return uniq, counts


def _filter_min_count_device(keys, counts, min_count: int):
    """Drop rows with count < min_count, keeping sorted order."""
    keep = counts >= min_count
    return keys[keep], counts[keep]


class _Accumulator:
    """Flush windows of extracted rows into one merged unique table."""

    def __init__(self, nl: int, flush_lanes: int, device: torch.device):
        self.flush_lanes = flush_lanes
        self.window: list = []
        self.lanes = 0
        self.table = (torch.zeros((0, nl), dtype=torch.int64, device=device),
                      torch.zeros(0, dtype=torch.int32, device=device))

    def feed(self, rows: torch.Tensor) -> None:
        self.window.append(rows)
        self.lanes += rows.shape[0]
        if self.lanes >= self.flush_lanes:
            self.flush()

    def flush(self) -> None:
        if not self.lanes:
            self.window = []
            return
        rows = torch.cat(self.window) if len(self.window) > 1 \
            else self.window[0]
        self.window, self.lanes = [], 0
        uniq, counts = _sort_count(rows)
        del rows
        if self.table[0].shape[0]:
            uniq, counts = _merge_unique_runs(*self.table, uniq, counts)
        self.table = (uniq, counts)

    def result(self):
        self.flush()
        return self.table


def count_reads_device(
    reads: np.ndarray, lengths: np.ndarray, k: int, *,
    chunk_reads: int = 131072, flush_lanes: int = 1 << 28,
    shipped: Tuple[torch.Tensor, torch.Tensor] | None = None,
    return_chunks: bool = False, device: str | torch.device = "cuda",
):
    """Count canonical (k+1)-mers of a read matrix; the table stays on
    `device`.  Returns (uniq (n, nl) int64 sorted unique, counts (n,)
    int32, n).

    shipped: the (bases, lengths) device tensors of these reads from an
    earlier call (return_chunks=True), so the reads cross to the device
    once per pipeline; the map stage takes the same pair."""
    dev = resolve_device(device)
    k1 = k + 1
    if shipped is None:
        shipped = (torch.as_tensor(np.ascontiguousarray(reads, np.uint8)).to(dev),
                   torch.as_tensor(np.ascontiguousarray(lengths, np.int32)).to(dev))
    bases_d, lens_d = shipped
    acc = _Accumulator(lb.n_limbs(k1), flush_lanes, dev)
    for i in range(0, bases_d.shape[0], chunk_reads):
        acc.feed(_extract_chunk(bases_d[i:i + chunk_reads],
                                lens_d[i:i + chunk_reads], k1))
    uniq, counts = acc.result()
    if return_chunks:
        return uniq, counts, int(counts.shape[0]), shipped
    return uniq, counts, int(counts.shape[0])


def pull_rows(arr: torch.Tensor, n: int) -> np.ndarray:
    """Host copy of arr[:n]."""
    return arr[:n].cpu().numpy()


def count_kedges_megasort_device(
    batches: Iterable[Tuple[np.ndarray, np.ndarray]], k: int,
    min_count: int = 1, *, max_lanes: int = 1 << 28,
    device: str | torch.device = "cuda"):
    """Count over a stream of host (bases, lengths) batches; returns the
    device table (uniq, counts, n) filtered to count >= min_count."""
    dev = resolve_device(device)
    k1 = k + 1
    acc = _Accumulator(lb.n_limbs(k1), max_lanes, dev)
    for bases, lengths in batches:
        acc.feed(_extract_chunk(
            torch.as_tensor(np.ascontiguousarray(bases, np.uint8)).to(dev),
            torch.as_tensor(np.ascontiguousarray(lengths, np.int32)).to(dev),
            k1))
    uniq, counts = acc.result()
    if min_count > 1:
        uniq, counts = _filter_min_count_device(uniq, counts, min_count)
    return uniq, counts, int(counts.shape[0])


def count_kedges_megasort(
    batches: Iterable[Tuple[np.ndarray, np.ndarray]], k: int,
    min_count: int = 1, *, max_lanes: int = 1 << 28,
    device: str | torch.device = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Host form of count_kedges_megasort_device: (kedges (n, nl) uint32
    sorted unique, counts (n,) int64)."""
    uniq, counts, n = count_kedges_megasort_device(
        batches, k, min_count, max_lanes=max_lanes, device=device)
    return (pull_rows(uniq, n).astype(np.uint32),
            pull_rows(counts, n).astype(np.int64))
