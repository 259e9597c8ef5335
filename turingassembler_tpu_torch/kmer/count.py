"""Canonical (k+1)-mer counting over host read batches (port of
turingassembler_tpu/kmer/count.py:count_kedges_from_batches and
count_kedges_from_reads).

One engine: the port's sort-based count (kmer/megasort.py) on `device`.
The contract is the JAX package's: sorted unique (n, nl) uint32 rows,
int64 counts, then the min_count filter.  Any exact counter meets it, so
the JAX `engine=` choice (hash table, tile merges, per-batch runs) has
no counterpart here.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from .megasort import count_kedges_megasort


def count_kedges_from_batches(
    batches: Iterable[Tuple[np.ndarray, np.ndarray]], k: int,
    min_count: int = 1, *, device: str | torch.device = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Count canonical (k+1)-mers over (bases, lengths) batches.  Returns
    (kedges (n, nl) uint32 sorted unique, counts (n,) int64), filtered
    to count >= min_count."""
    return count_kedges_megasort(batches, k, min_count=min_count,
                                 device=device)


def count_kedges_from_reads(
    reads: np.ndarray, lengths: np.ndarray, k: int,
    batch_size: int = 8192, min_count: int = 1, *,
    device: str | torch.device = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Chunk a read matrix into batches of `batch_size` reads and count.
    (The JAX package pads the tail batch to a constant shape; padded
    reads have length 0 and count nothing, so no padding is needed.)"""
    def gen():
        for i in range(0, len(reads), batch_size):
            yield reads[i:i + batch_size], lengths[i:i + batch_size]
    return count_kedges_from_batches(gen(), k, min_count=min_count,
                                     device=device)
