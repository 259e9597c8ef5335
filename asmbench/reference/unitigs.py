"""The unitig graph of a set of canonical (k+1)-mers, plain.

Each kept (k+1)-mer ("k-edge") gives two directed lanes, its bases and
their reverse complement; a lane runs from the k-mer of its first k
bases to the k-mer of its last k.  A directed k-mer's out-degree is the
number of distinct lanes leaving it, its in-degree the number entering.
A lane continues into the one lane leaving its target when that target
has in-degree 1 and out-degree 1 (never into itself).  A unitig is a
maximal chain of lanes: its sequence is its first lane's k+1 bases and
the last base of each lane after it, its count the sum of its k-edges'
counts, its ends the directed k-mers it starts and stops at.  A chain
that closes on itself with no way in (a circular unitig) starts at its
lowest lane and is marked circular: where it is cut is arbitrary, so it
is compared by its rotation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import kmers


@dataclass
class RefGraph:
    """Unitigs on the host: bases in `pool` at [off[u], off[u+1]),
    `count`, `start` and `end` (ids of directed k-mers, equal where one
    unitig's end is another's start), `circular`, and k."""
    k: int
    pool: np.ndarray
    off: np.ndarray
    count: np.ndarray
    start: np.ndarray
    end: np.ndarray
    circular: np.ndarray

    @property
    def n(self) -> int:
        return len(self.count)

    def seq(self, u: int) -> np.ndarray:
        return self.pool[self.off[u]:self.off[u + 1]]


def _rank(pred: torch.Tensor):
    """(head, distance) of every lane along the pred pointers (-1 at a
    head) by pointer jumping; lanes on a cycle keep a non-head."""
    idx = torch.arange(len(pred), device=pred.device)
    anc = torch.where(pred >= 0, pred, idx)
    dist = (pred >= 0).long()
    for _ in range(math.ceil(math.log2(len(pred) + 1)) + 1):
        dist = dist + dist[anc]
        anc = anc[anc]
    return anc, dist


def build(rows: torch.Tensor, counts: torch.Tensor, k: int) -> RefGraph:
    """RefGraph of the canonical k-edges `rows` ((n, n_limbs(k+1)) int64,
    kmers.encode's layout) with their `counts`."""
    dev = rows.device
    n = len(rows)
    if n == 0:
        z = np.zeros(0, np.int64)
        return RefGraph(k, np.zeros(0, np.uint8), np.zeros(1, np.int64),
                        z, z, z, np.zeros(0, bool))
    codes = kmers.decode(rows, k + 1)
    lanes = torch.cat([codes, (3 - codes).flip(1)])
    D = 2 * n
    ids = kmers.unique_rows(torch.cat([kmers.encode(lanes[:, :k]),
                                       kmers.encode(lanes[:, 1:])]))[2]
    src, tgt = ids[:D], ids[D:]
    m = int(ids.max()) + 1
    first, last = lanes[:, 0].long(), lanes[:, k].long()
    outdeg = torch.bincount(torch.unique(src * 4 + last) // 4, minlength=m)
    indeg = torch.bincount(torch.unique(tgt * 4 + first) // 4, minlength=m)
    lane = torch.arange(D, device=dev)
    leaving = torch.full((m,), -1, dtype=torch.int64, device=dev)
    leaving[src] = lane
    through = (outdeg[tgt] == 1) & (indeg[tgt] == 1)
    nxt = torch.where(through, leaving[tgt], -1)
    nxt = torch.where(nxt == lane, -1, nxt)
    pred = torch.full((D,), -1, dtype=torch.int64, device=dev)
    pred[nxt[nxt >= 0]] = lane[nxt >= 0]

    head, dist = _rank(pred)
    cyc = pred[head] >= 0
    circ_head = torch.zeros(D, dtype=torch.bool, device=dev)
    if bool(cyc.any()):
        low, p = lane.clone(), torch.where(pred >= 0, pred, lane)
        for _ in range(math.ceil(math.log2(D + 1)) + 1):
            low = torch.minimum(low, low[p])
            p = p[p]
        circ_head = cyc & (low == lane)
        pred = torch.where(circ_head, -1, pred)
        head, dist = _rank(pred)

    heads = torch.nonzero(pred < 0).squeeze(1)
    uid = torch.full((D,), -1, dtype=torch.int64, device=dev)
    uid[heads] = torch.arange(len(heads), device=dev)
    u = uid[head]
    nu = len(heads)
    ulen = torch.bincount(u, minlength=nu)
    off = torch.zeros(nu + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(k + ulen, 0)
    pool = torch.empty(int(off[-1]), dtype=torch.uint8, device=dev)
    pool[off[:-1, None] + torch.arange(k, device=dev)[None, :]] = \
        lanes[heads, :k]
    pool[off[u] + k + dist] = lanes[:, k]
    count = torch.zeros(nu, dtype=torch.int64, device=dev).index_add_(
        0, u, counts.long()[lane % n])
    tail = torch.empty(nu, dtype=torch.int64, device=dev)
    is_tail = dist == ulen[u] - 1
    tail[u[is_tail]] = lane[is_tail]
    host = lambda t: t.cpu().numpy()     # noqa: E731
    return RefGraph(k, host(pool), host(off), host(count), host(src[heads]),
                    host(tgt[tail]), host(circ_head[heads]))


def min_rotation(s: bytes) -> bytes:
    """The lexicographically least rotation of s (Booth's algorithm)."""
    d = s + s
    f = [-1] * len(d)
    kk = 0
    for j in range(1, len(d)):
        c = d[j]
        i = f[j - kk - 1]
        while i != -1 and c != d[kk + i + 1]:
            if c < d[kk + i + 1]:
                kk = j - i - 1
            i = f[i]
        if c != d[kk + i + 1]:
            if c < d[kk]:
                kk = j
            f[j - kk] = -1
        else:
            f[j - kk] = i + 1
    return d[kk:kk + len(s)]


def rotation_key(seq: np.ndarray, k: int) -> bytes:
    """Key of a circular unitig: a marker and the least rotation of its
    period (its sequence less the k bases that repeat its start)."""
    return b"\x05" + min_rotation(seq[:len(seq) - k].tobytes())


def keys(g: RefGraph) -> list:
    """A key a unitig: its bases, or rotation_key where it is circular."""
    return [rotation_key(g.seq(u), g.k) if g.circular[u]
            else g.seq(u).tobytes() for u in range(g.n)]
