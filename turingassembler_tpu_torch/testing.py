"""Synthetic genomes and reads.

random_genome, revcomp and sim_reads are copies of
turingassembler_tpu/testing.py: the same seeds give the same arrays, so
a run of the port and a run of the JAX package start from identical
data.  sim_indel_reads makes reads that need the alignment DP."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def random_genome(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4, size=n).astype(np.uint8)


def revcomp(seq: np.ndarray) -> np.ndarray:
    return (3 - seq)[::-1]


def sim_reads(
    genome: np.ndarray,
    coverage: float = 30.0,
    read_len: int = 100,
    seed: int = 0,
    error_rate: float = 0.0,
    circular: bool = False,
    pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform single-end reads from both strands, optional substitution
    errors.  Returns (reads (N, L) uint8 codes padded with 255, lengths
    (N,) int32)."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    n_reads = int(np.ceil(coverage * G / read_len))
    L = pad_to or read_len
    if circular:
        starts = rng.integers(0, G, size=n_reads)
        idx = (starts[:, None] + np.arange(read_len)[None, :]) % G
    else:
        starts = rng.integers(0, max(G - read_len, 1) + 1, size=n_reads)
        idx = starts[:, None] + np.arange(read_len)[None, :]
    reads = genome[idx]
    flip = rng.random(n_reads) < 0.5
    reads[flip] = (3 - reads[flip])[:, ::-1]
    if error_rate > 0:
        errs = rng.random(reads.shape) < error_rate
        reads = np.where(errs, (reads + rng.integers(1, 4, size=reads.shape)) % 4,
                         reads).astype(np.uint8)
    out = np.full((n_reads, L), 255, np.uint8)
    out[:, :read_len] = reads
    return out, np.full(n_reads, read_len, np.int32)


def sim_indel_reads(genome: np.ndarray, n: int, read_len: int = 150,
                    seed: int = 0, pad_to: Optional[int] = None,
                    lo: int = 50, hi: int = 100
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """n reads from both strands, each carrying one single-base indel at
    a read position in [lo, hi): half insertions of a random base, half
    deletions.  Vectorised; returns (reads (n, L) uint8 255-padded,
    lengths (n,) int32)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - read_len, size=n)
    p = rng.integers(lo, hi, size=n)[:, None]
    ins = (rng.random(n) < 0.5)[:, None]
    j = np.arange(read_len)[None, :]
    # deletion skips genome base p; insertion puts a random base at p
    src = np.where(ins, j - (j > p), j + (j >= p))
    reads = genome[starts[:, None] + src]
    reads = np.where(ins & (j == p), rng.integers(0, 4, size=(n, 1)),
                     reads).astype(np.uint8)
    flip = rng.random(n) < 0.5
    reads[flip] = (3 - reads[flip])[:, ::-1]
    out = np.full((n, pad_to or read_len), 255, np.uint8)
    out[:, :read_len] = reads
    return out, np.full(n, read_len, np.int32)
