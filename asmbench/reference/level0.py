"""The reference's count and level-0 graph of one library."""

from __future__ import annotations

from . import kmers, unitigs


def reads(lib):
    """A library's reads as the count takes them: R1, then R2."""
    return [(lib.r1, lib.l1), (lib.r2, lib.l2)]


def table_and_graph(lib, k: int, min_count: int, device,
                    fingerprinted: bool = False):
    """(rows, counts, RefGraph) of a library: its kept canonical
    (k+1)-mers and their unitig graph (`fingerprinted`: see
    kmers.count)."""
    rows, counts = kmers.count(reads(lib), k + 1, min_count, device,
                               fingerprinted=fingerprinted)
    return rows, counts, unitigs.build(rows, counts, k)
