"""The program's outputs held against the reference.

Every number here counts what disagrees, so a sound run reads 0:

  kmers_wrong    (k+1)-mer rows, each with its count, found in one table
                 and not in the other
  unitigs_wrong  unitigs, each with its count, in one graph and not in
                 the other (a unitig is known by its bases, a circular one
                 by its least rotation)
  links_wrong    links (unitig A's end is unitig B's start) in one graph
                 and not the other, plus program unitigs whose reverse-
                 complement partner or partner's ends are wrong
  reads_wrong    reads whose unitig or start differs from the reference's
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from . import kmers, unitigs


def program_rows_to_codes(rows: torch.Tensor, k1: int) -> torch.Tensor:
    """The program's count rows ((n, ceil(k1/16)) int64, 16 bases a
    32-bit limb, the first base in its top bits) as (n, k1) codes."""
    cols = [(rows[:, j // 16] >> (30 - 2 * (j % 16))) & 3 for j in range(k1)]
    return torch.stack(cols, 1).to(torch.uint8)


def program_table(rows, counts, k1: int, device):
    """The program's count table (host arrays) in the reference's row
    layout, on `device`."""
    return (kmers.encode(program_rows_to_codes(
        torch.as_tensor(rows).to(device), k1)),
        torch.as_tensor(counts).to(device).long())


def kmers_wrong(rows, counts, ref_rows, ref_counts) -> int:
    """Rows of ((k+1)-mer, count) in one table and not the other, both in
    the reference's layout; a row held twice counts once more."""
    a = torch.cat([rows, counts.long()[:, None]], 1)
    b = torch.cat([ref_rows, ref_counts.long()[:, None]], 1)
    _, n, _ = kmers.unique_rows(torch.cat([a, b]))
    return int((n - 2).abs().sum())


class ProgramGraph:
    """The arrays of the program's host graph that are judged."""

    def __init__(self, g):
        self.k = int(g.ksize)
        self.pool = np.asarray(g.seq_data, np.uint8)
        self.off = np.asarray(g.seq_off, np.int64)
        self.count = np.asarray(g.edge_count, np.int64)
        self.source = np.asarray(g.edge_source, np.int64)
        self.target = np.asarray(g.edge_target, np.int64)
        self.rc = np.asarray(g.edge_rc, np.int64)
        self.node_rc = np.asarray(g.node_rc, np.int64)

    @classmethod
    def from_reference(cls, ref: unitigs.RefGraph) -> "ProgramGraph":
        """A reference graph in the program's place (a control): its
        unitigs, counts and ends, with no partners to check."""
        g = cls.__new__(cls)
        g.k, g.pool, g.off, g.count = ref.k, ref.pool, ref.off, ref.count
        g.source, g.target = ref.start, ref.end
        g.rc = g.node_rc = None
        return g

    @property
    def n(self) -> int:
        return len(self.count)

    def seq(self, e: int) -> np.ndarray:
        return self.pool[self.off[e]:self.off[e + 1]]

    def keys(self, circular: set) -> list:
        """A key an edge: its bases, or its rotation key where that is a
        circular unitig of the reference."""
        out = []
        for e in range(self.n):
            s = self.seq(e)
            key = s.tobytes()
            if circular and len(s) > self.k \
                    and s[:self.k].tobytes() == s[-self.k:].tobytes():
                rk = unitigs.rotation_key(s, self.k)
                if rk in circular:
                    key = rk
            out.append(key)
        return out


def _links(keys, start, end) -> Counter:
    """(key of A, key of B) for every pair with end[A] == start[B]."""
    order = np.argsort(start, kind="stable")
    ss = start[order]
    lo = np.searchsorted(ss, end, "left")
    hi = np.searchsorted(ss, end, "right")
    out = Counter()
    for a in np.flatnonzero(hi > lo):
        for b in order[lo[a]:hi[a]]:
            out[(keys[a], keys[b])] += 1
    return out


def _diff(a: Counter, b: Counter) -> int:
    return sum((a - b).values()) + sum((b - a).values())


def graph_wrong(prog, ref: unitigs.RefGraph, ref_keys=None):
    """(unitigs_wrong, links_wrong, program keys) of a program graph
    (ProgramGraph) against the reference's."""
    rk = ref_keys if ref_keys is not None else unitigs.keys(ref)
    circular = {k for k, c in zip(rk, ref.circular) if c}
    pk = prog.keys(circular)
    u_wrong = _diff(Counter(zip(pk, prog.count.tolist())),
                    Counter(zip(rk, ref.count.tolist())))
    l_wrong = _diff(_links(pk, prog.source, prog.target),
                    _links(rk, ref.start, ref.end))
    # each unitig's partner holds its reverse complement, from the
    # partner's source, the reverse complement of its own target
    bad = 0
    if prog.rc is None:
        return u_wrong, l_wrong, pk
    rc_pool = (3 - prog.pool)[::-1]
    total = len(prog.pool)
    for e in range(prog.n):
        p = prog.rc[e]
        if not 0 <= p < prog.n:
            bad += 1
            continue
        if pk[e][:1] == b"\x05":
            continue
        rseq = rc_pool[total - prog.off[e + 1]:total - prog.off[e]]
        if prog.seq(p).tobytes() != rseq.tobytes() \
                or prog.source[p] != prog.node_rc[prog.target[e]]:
            bad += 1
    return u_wrong, l_wrong + bad, pk


def reads_wrong(prog_edge, prog_start, ref_edge, ref_start, to_prog) -> int:
    """Reads whose program (edge, start) differs from the reference's,
    the reference's unitig ids put in the program's numbering by
    `to_prog` (-2 where the program has no such unitig)."""
    ref_e = np.where(ref_edge >= 0, to_prog[np.maximum(ref_edge, 0)], -1)
    return int(np.count_nonzero((prog_edge != ref_e)
                                | (prog_start != ref_start)))


def unitig_translation(ref_keys, prog_keys) -> np.ndarray:
    """Program edge id of each reference unitig, -2 where none."""
    where = {k: i for i, k in enumerate(prog_keys)}
    return np.asarray([where.get(k, -2) for k in ref_keys], np.int64)
