"""Sort-based canonical (k+1)-mer counting (port of
turingassembler_tpu/kmer/megasort.py).

Reads go to the device once as a (N, L) uint8 code tensor (255 padding)
plus int32 lengths.  Each chunk of reads becomes the canonical limb rows
of its valid windows; every `flush_lanes` rows the window is sorted
lexicographically and run-length counted, and the unique run is merged
into the running table (concat + re-sort, counts summed).  The three
steps are ops/kmer_sort.py's entries: the kernels of csrc/kmer_sort.cu
on a card (a radix sort), their plain tensor versions on the CPU (stable
LSD passes, one `torch.sort` per limb).

Invalid windows are dropped before the sort (the JAX package keeps them
as all-ones sentinel rows), so no key can be confused with a sentinel
and the sort needs no validity column when 2(k+1) % 32 == 0.  Tables are
sized from
the data: (uniq (n, nl) int64, counts (n,) int32, n), sorted ascending.
The JAX package's static-capacity retries (out_cap overflow) have no
counterpart, because no capacity is fixed ahead of the data.

Out of core (the -sm posture, upstream src/main.c:234-236): with a
`device_lanes` budget the running device table is pulled to a host run
before it would pass that many rows; with `host_mb` and `spill_dir`, host
runs past that many megabytes are saved to disk and re-opened as
memmaps; the runs are then merged on the host (ops/sortops.py) and the
result is host arrays.  With no budget set nothing of this runs.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Tuple

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..ops import kmer_sort as ks
from ..ops import limbs as lb
from ..ops.sortops import np_external_merge_runs


def _extract_chunk(bases: torch.Tensor, lengths: torch.Tensor,
                   k1: int) -> torch.Tensor:
    """One read chunk -> limb rows (n_valid, nl) of its valid canonical
    (k1)-mer windows, in ascending (read, window) order (ops/kmer_sort.py:
    int64 limbs on the CPU, their int32 bit patterns on a card)."""
    return ks.extract_keys(bases, lengths, k1)


def _sort_count(keys: torch.Tensor):
    """Sort limb rows and run-length count the unique keys.
    Returns (uniq (n, nl) int64 ascending, counts (n,) int32)."""
    return ks.sort_count(keys)


def _merge_unique_runs(ka, ca, kb, cb):
    """Merge two sorted unique (keys, counts) runs; keys present in both
    get the sum of their counts."""
    return ks.merge_runs(ka, ca, kb, cb)


def _filter_min_count_device(keys, counts, min_count: int):
    """Drop rows with count < min_count, keeping sorted order."""
    keep = torch.nonzero(counts >= min_count).squeeze(1)
    tracing.host_sync()                 # the nonzero's row count
    return keys.index_select(0, keep), counts.index_select(0, keep)


class _Accumulator:
    """Flush windows of extracted rows into one merged unique table;
    under a budget, into host and disk runs (see the module docstring)."""

    def __init__(self, nl: int, flush_lanes: int, device: torch.device,
                 device_lanes: int = 0, host_mb: float = 0,
                 spill_dir: str | None = None):
        # the window of extracted rows lives on the device too, so a
        # device budget bounds it as it bounds the table
        self.flush_lanes = min(flush_lanes, device_lanes) if device_lanes \
            else flush_lanes
        self.device_lanes = device_lanes
        self.host_mb = host_mb
        self.spill_dir = spill_dir
        self.window: list = []
        self.lanes = 0
        self.empty = (torch.zeros((0, nl), dtype=torch.int64, device=device),
                      torch.zeros(0, dtype=torch.int32, device=device))
        self.table = self.empty
        self.host_runs: List[tuple] = []
        self.host_bytes = 0
        self.disk_runs = 0
        self.flushes = 0            # windows sorted and counted
        self.table_rows = 0         # the device table's most rows

    def feed(self, rows: torch.Tensor) -> None:
        # a record may hold more rows than a window: it is cut at the
        # window's edge, so no window passes flush_lanes rows
        while rows.shape[0]:
            take = self.flush_lanes - self.lanes
            self.window.append(rows[:take])
            self.lanes += min(take, rows.shape[0])
            rows = rows[take:]
            if self.lanes >= self.flush_lanes:
                self.flush()

    def flush(self) -> None:
        if not self.lanes:
            self.window = []
            return
        with tracing.span("count.sort", rows=self.lanes):
            rows = torch.cat(self.window) if len(self.window) > 1 \
                else self.window[0]
            self.window, self.lanes = [], 0
            uniq, counts = _sort_count(rows)
            del rows
            tracing.add(unique=uniq.shape[0])
        self.flushes += 1
        n_t, n_u = self.table[0].shape[0], uniq.shape[0]
        if n_t and self.device_lanes and n_t + n_u > self.device_lanes:
            # the merged table would pass the device budget: the table
            # becomes a host run, and the final merge sums the keys the
            # runs share
            self.spill_table()
        elif n_t:
            with tracing.span("count.merge", rows_in=n_t + n_u):
                uniq, counts = _merge_unique_runs(*self.table, uniq, counts)
                tracing.add(rows_out=uniq.shape[0])
        self.table = (uniq, counts)
        self.table_rows = max(self.table_rows, uniq.shape[0])
        if self.device_lanes and uniq.shape[0] >= self.device_lanes:
            self.spill_table()

    def spill_table(self) -> None:
        """Device table -> a host run, or a disk run when the host runs
        would pass host_mb."""
        keys, counts = self.table
        self.table = self.empty
        n = keys.shape[0]
        if not n:
            return
        k_h = pull_rows(keys, n).astype(np.uint32)
        c_h = pull_rows(counts, n).astype(np.int64)
        nb = k_h.nbytes + c_h.nbytes
        if self.host_mb and self.spill_dir \
                and self.host_bytes + nb > self.host_mb * 1e6:
            os.makedirs(self.spill_dir, exist_ok=True)
            i = len(self.host_runs)
            kp = os.path.join(self.spill_dir, f"count_run{i}_keys.npy")
            cp = os.path.join(self.spill_dir, f"count_run{i}_counts.npy")
            np.save(kp, k_h)
            np.save(cp, c_h)
            del k_h, c_h
            self.host_runs.append((np.load(kp, mmap_mode="r"),
                                   np.load(cp, mmap_mode="r")))
            self.disk_runs += 1
        else:
            self.host_runs.append((k_h, c_h))
            self.host_bytes += nb

    def result(self):
        """The device table (uniq, counts); call only when nothing
        spilled."""
        self.flush()
        return self.table

    def merged_host_runs(self, min_count: int):
        """Fold the last device table into the runs and merge them:
        host (kedges (n, nl) uint32, counts (n,) int64)."""
        self.spill_table()
        return np_external_merge_runs(
            self.host_runs, min_count=min_count,
            out_dir=self.spill_dir if self.disk_runs else None)


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


# reads a count record holds (the JAX package's TA_COUNT_CHUNK default)
COUNT_CHUNK = 131072


def _coalesce_batches(batches, target_reads: int, staging=None):
    """Merge a stream of (bases, lengths) host batches into records of
    `target_reads` rows (width = max width in the group, padded with
    255), so the count extracts few large records and not many small
    batches.  Unlike the JAX function the tail record keeps only its
    reads: no fixed shape is reused here, so pad rows would only be sent
    to the device to hold no window.  A record is a fresh numpy pair, or
    with `staging`, the (bases (n, W) uint8, lengths (n,) int32) CPU
    tensors that `staging(n, W)` returns, written through their numpy
    views (the count's pinned staging on a card).  While tracing, the
    wait on `batches` (the parse upstream) is counted as `source_ns` on
    the enclosing span (count.coalesce)."""
    buf: List[tuple] = []
    nb = 0

    def _join():
        nonlocal buf, nb
        W = max(b.shape[1] for b, _ in buf)
        if staging is None:
            rec = bases, lens = np.empty((nb, W), np.uint8), \
                np.empty(nb, np.int32)
        else:
            rec = staging(nb, W)
            bases, lens = rec[0].numpy(), rec[1].numpy()
        r = 0
        for b, l in buf:
            n, w = b.shape
            bases[r:r + n, :w] = b
            bases[r:r + n, w:] = 255
            lens[r:r + n] = l
            r += n
        buf, nb = [], 0
        return rec

    for b, l in tracing.timed(batches, "source_ns"):
        while len(b):
            take = min(len(b), target_reads - nb)
            buf.append((b[:take], l[:take]))
            nb += take
            b, l = b[take:], l[take:]
            if nb >= target_reads:
                yield _join()
    if nb:
        yield _join()


def _pinned(n: int, width: int):
    """A record's staging: pinned host tensors from torch's caching host
    allocator, which hands a block out again only once the copies queued
    from it have run, so two or three blocks serve every record."""
    return (torch.empty((n, width), dtype=torch.uint8, pin_memory=True),
            torch.empty(n, dtype=torch.int32, pin_memory=True))


def _shipped_records(batches, dev: torch.device):
    """The count's records on `dev`, in order: (bases, lengths).

    On a card each record is joined straight into pinned staging and its
    copy queued without blocking, on the current stream (so it stays
    ordered before the extraction), and it is handed on only after the
    next record is joined: the copy engine moves record i while the host
    joins record i+1.  On the CPU each record is a fresh numpy join,
    handed on at once."""
    staged = dev.type == "cuda"
    recs = _coalesce_batches(batches, COUNT_CHUNK,
                             _pinned if staged else None)
    queued = []         # the record shipped and not yet handed on
    while True:
        with tracing.span("count.coalesce"):
            rec = next(recs, None)
        if queued:
            yield queued.pop()  # popped: the consumer frees it alone
        if rec is None:
            return
        bases, lengths = torch.as_tensor(rec[0]), torch.as_tensor(rec[1])
        with tracing.span("count.ship",
                          bytes=bases.nbytes + lengths.nbytes,
                          pageable=int(not bases.is_pinned())):
            queued.append((bases.to(dev, non_blocking=staged),
                           lengths.to(dev, non_blocking=staged)))
        # the staging back to the allocator before the next join; it
        # holds the block until the copy from it has run
        del bases, lengths, rec
        if not staged:
            yield queued.pop()


def pull_rows(arr: torch.Tensor, n: int) -> np.ndarray:
    """Host copy of arr[:n]."""
    return arr[:n].cpu().numpy()


def count_kedges_megasort_device(
    batches: Iterable[Tuple[np.ndarray, np.ndarray]], k: int,
    min_count: int = 1, *, max_lanes: int = 1 << 28,
    device_lanes: int = 0, host_mb: float = 0,
    spill_dir: str | None = None, device: str | torch.device = "cuda",
    stats: dict | None = None):
    """Count over a stream of host (bases, lengths) batches; returns the
    device table (uniq, counts, n) filtered to count >= min_count.  When
    the `device_lanes` budget forced a spill, returns host arrays
    instead, a 2-tuple (kedges (n, nl) uint32, counts (n,) int64).

    The batches are joined into records of COUNT_CHUNK reads first
    (_coalesce_batches, as the JAX count joins them), one extraction a
    record; on a card each record is joined into pinned staging and
    shipped without blocking, one record ahead of its extraction
    (_shipped_records).  `stats`, when given, receives "records"
    (records counted), "host_runs" (runs kept in host memory) and
    "disk_runs" (runs saved under spill_dir).  Its spans (tracing.py):
    `count` (k1, records, rows, flushes: the windows sorted, table_rows:
    the device table's most rows before the cutoff) and below it
    count.coalesce (a record's join; source_ns the wait on `batches`
    inside it), count.ship (the record's copy, queued without a sync on
    a card: bytes, pageable), count.extract (rows), count.sort (rows,
    unique and sort_count's routes, count.sort.lsd its buckets over
    capacity), count.merge (rows_in: both tables' rows, rows_out: the
    merged table's) and count.filter."""
    dev = resolve_device(device)
    k1 = k + 1
    acc = _Accumulator(lb.n_limbs(k1), max_lanes, dev, device_lanes,
                       host_mb, spill_dir)
    records = 0
    with tracing.span("count", k1=k1):
        for bases, lengths in _shipped_records(batches, dev):
            records += 1
            with tracing.span("count.extract"):
                rows = _extract_chunk(bases, lengths, k1)
                tracing.add(rows=rows.shape[0])
            del bases, lengths
            tracing.add(rows=rows.shape[0])
            acc.feed(rows)
            del rows
        acc.flush()
        if acc.host_runs:
            res = acc.merged_host_runs(min_count)
        else:
            uniq, counts = acc.result()
            if min_count > 1:
                with tracing.span("count.filter"):
                    uniq, counts = _filter_min_count_device(uniq, counts,
                                                            min_count)
            res = uniq, counts, int(counts.shape[0])
        tracing.add(records=records, flushes=acc.flushes,
                    table_rows=acc.table_rows)
    if stats is not None:
        stats.update(records=records, disk_runs=acc.disk_runs,
                     host_runs=len(acc.host_runs) - acc.disk_runs)
    return res


def count_kedges_megasort(
    batches: Iterable[Tuple[np.ndarray, np.ndarray]], k: int,
    min_count: int = 1, *, max_lanes: int = 1 << 28,
    device_lanes: int = 0, host_mb: float = 0,
    spill_dir: str | None = None,
    device: str | torch.device = "cuda",
    stats: dict | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Host form of count_kedges_megasort_device: (kedges (n, nl) uint32
    sorted unique, counts (n,) int64), spilled or not."""
    res = count_kedges_megasort_device(
        batches, k, min_count, max_lanes=max_lanes,
        device_lanes=device_lanes, host_mb=host_mb, spill_dir=spill_dir,
        device=device, stats=stats)
    if len(res) == 2:
        return res
    uniq, counts, n = res
    return (pull_rows(uniq, n).astype(np.uint32),
            pull_rows(counts, n).astype(np.int64))
