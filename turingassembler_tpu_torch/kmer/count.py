"""Canonical (k+1)-mer counting over host read batches (port of
turingassembler_tpu/kmer/count.py).

The contract is the JAX package's: sorted unique (n, nl) uint32 rows,
int64 counts, then the min_count filter.  Four engines meet it on
`device` (engine=, the JAX names):
  "megasort" — the sort-based count of kmer/megasort.py, which every
               path of the port uses;
  "hash"     — each batch's canonical (k+1)-mers extracted and inserted
               into one DeviceHashCounter by insert_reads (ops/devhash.py:
               on a card one launch a batch of the CUDA kernel
               csrc/devhash.cu, the JAX _count_batch_fused), capacity
               2^TA_HASH_CAP_LOG2 (default 25), finalize compaction
               capacity 2^TA_HASH_OUT_LOG2 (default TA_HASH_CAP_LOG2 - 2,
               at least 10);
  "device"   — a sorted run a batch (batch_count_tile), merged on the
               device in a DeviceCountAccumulator (ops/merge.py);
  "np"       — the same runs merged on the host (np_merge_count_runs).
  "auto" is "megasort" on every device.  The JAX package's "auto" picks
  by backend ("np" on its CPU backend) for TPU reasons, and every engine
  returns the same arrays, so no path of the port changes engine; the
  others are kept for the JAX API (chip_smoke.py phase 14 (b), (c)
  times them beside megasort).  The
  hash engine ships uint8 codes, as the rest of the port does; the JAX
  2-bit read pack (host_pack_reads, device_unpack_reads) is not ported.
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import kmers as km
from ..ops import limbs as lb
from ..ops.devhash import DeviceHashCounter
from ..ops.merge import DeviceCountAccumulator
from ..ops.sortops import np_merge_count_runs, padded_run
from .megasort import count_kedges_megasort

ENGINES = ("auto", "megasort", "hash", "device", "np")


def batch_count_tile(bases: torch.Tensor, lengths: torch.Tensor, k1: int):
    """One batch -> its sorted unique run, sentinel-padded to the tile's
    capacity (every window of the batch).  Returns (keys (T, nl) int64
    with SENTINEL tail, counts (T,) int32 with 0 tail, n_unique 0-d)."""
    canon, _, valid = km.extract_canonical_kmers(bases, lengths, k1)
    return padded_run(canon.reshape(-1, canon.shape[-1]), valid.reshape(-1))


def _to_device(bases, lengths, dev):
    return (torch.as_tensor(np.ascontiguousarray(bases, np.uint8)).to(dev),
            torch.as_tensor(np.ascontiguousarray(lengths, np.int32)).to(dev))


def _count_hash(batches, k1: int, dev: torch.device):
    cap_log2 = int(os.environ.get("TA_HASH_CAP_LOG2", 25))
    out_log2 = int(os.environ.get("TA_HASH_OUT_LOG2", max(cap_log2 - 2, 10)))
    counter = None
    for bases, lengths in batches:
        b, ln = _to_device(bases, lengths, dev)
        if counter is None:
            counter = DeviceHashCounter(cap_log2, lb.n_limbs(k1), device=dev)
        counter.insert_reads(b, ln, k1)
    if counter is None:
        return np.zeros((0, lb.n_limbs(k1)), np.uint32), np.zeros(0, np.int64)
    return counter.finalize(out_cap_log2=out_log2)


def count_kedges_from_batches(
    batches: Iterable[Tuple[np.ndarray, np.ndarray]], k: int,
    min_count: int = 1, engine: str = "auto", *,
    device: str | torch.device = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Count canonical (k+1)-mers over (bases, lengths) batches.  Returns
    (kedges (n, nl) uint32 sorted unique, counts (n,) int64), filtered
    to count >= min_count."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if engine in ("auto", "megasort"):
        return count_kedges_megasort(batches, k, min_count=min_count,
                                     device=device)
    dev = resolve_device(device)
    k1 = k + 1
    if engine == "hash":
        kedges, counts = _count_hash(batches, k1, dev)
    elif engine == "device":
        acc = DeviceCountAccumulator()
        for bases, lengths in batches:
            keys, cnts, _ = batch_count_tile(
                *_to_device(bases, lengths, dev), k1)
            acc.add_run(keys, cnts)
        kedges, counts = acc.finalize()
    else:
        runs = []
        for bases, lengths in batches:
            keys, cnts, n_unique = batch_count_tile(
                *_to_device(bases, lengths, dev), k1)
            n = int(n_unique)
            runs.append((keys[:n].cpu().numpy().astype(np.uint32),
                         cnts[:n].cpu().numpy().astype(np.int64)))
        kedges, counts = np_merge_count_runs(runs)
    if min_count > 1 and len(counts):
        keep = counts >= min_count
        kedges, counts = kedges[keep], counts[keep]
    return kedges, counts


def count_kedges_from_reads(
    reads: np.ndarray, lengths: np.ndarray, k: int,
    batch_size: int = 8192, min_count: int = 1, engine: str = "auto", *,
    device: str | torch.device = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Chunk a read matrix into batches of `batch_size` reads and count.
    (The JAX package pads the tail batch to a constant shape; padded
    reads have length 0 and count nothing, so no padding is needed.)"""
    def gen():
        for i in range(0, len(reads), batch_size):
            yield reads[i:i + batch_size], lengths[i:i + batch_size]
    return count_kedges_from_batches(gen(), k, min_count=min_count,
                                     engine=engine, device=device)
