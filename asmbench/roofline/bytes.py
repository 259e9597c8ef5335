"""Bytes each layer must move for one call, counted from the job's own
sizes and not from the shapes the program launches, so the figure stays
the same whatever kernels implement the layer: each input byte read
once, each output byte written once, and what lives on the host crosses
the link once.  Rows of (k+1)-mers count as 2 bits a base rounded up to
32-bit words, plus a 32-bit count; graph arrays as the host graph holds
them (one byte a base, five 64-bit words a unitig).  None of the layers
has an operation count.

Each function returns (hbm_bytes, link_bytes, ops)."""

from __future__ import annotations


def kmer_row_bytes(k1: int) -> int:
    """A counted (k1)-mer: its 32-bit words of 2-bit bases and a count."""
    return 4 * (-(-2 * k1 // 32)) + 4


def count(n_reads: int, width: int, n_kept: int, k1: int):
    """The count: the reads' codes (n_reads x width bytes) and lengths
    (4 bytes a read) cross the link and are read once; the table after
    the cutoff, n_kept rows, is written once."""
    reads = n_reads * (width + 4)
    table = n_kept * kmer_row_bytes(k1)
    return reads + table, reads, 0


def build(n_kept: int, k1: int, seq_bytes: int, n_unitigs: int):
    """The level-0 build: the k-edge table is read once; the graph's base
    pool (seq_bytes) and its per-unitig arrays (offset, count, partner,
    source and target, 8 bytes each) are written once and cross the link
    once."""
    table = n_kept * kmer_row_bytes(k1)
    graph = seq_bytes + 40 * n_unitigs
    return table + graph, graph, 0


def map_reads(n_reads: int, width: int, pool_bytes: int):
    """The map of n_reads reads: their codes and lengths cross the link
    and are read once, the graph's base pool is read once, and each
    read's edge and start (4 bytes each) are written and cross back
    once."""
    reads = n_reads * (width + 4)
    out = 8 * n_reads
    return reads + pool_bytes + out, reads + out, 0
