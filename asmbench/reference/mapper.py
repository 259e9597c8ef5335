"""Minimizer index of a unitig graph and the verified map of reads onto
it, plain.

Minimizers (k 17, w 17, forward strand): each 17-mer's hash is a 32-bit
murmur3-style mix of its two 32-bit words (the first 16 bases, 2 bits a
base with the first base highest, then the last base in the top bits of
a second word); a position is a minimizer where it is the leftmost
least hash of some window of 17 consecutive 17-mers that lies wholly in
the sequence.  The index keeps every minimizer of every unitig; a key
that occurs once in the whole graph is a singleton, and only singletons
vote.

A read's vote: its first 48 minimizer positions, each singleton hit
giving (unitig, unitig position - read position); the unitig with the
most hits wins if no other ties it and it holds at least 85% of the
hits (or there are at most 2); its start is the least offset among its
hits.  The winner is verified: the gapless score at that start over the
bases that lie on the unitig (match 1, mismatch -2) accepts it at 50 or
more; otherwise the read, trimmed to the unitig, is aligned by the fit
DP (dp.py, BWA scoring 1, -2, 3, 1) against the unitig from 16 bases
before to 16 after, and accepted at 50 or more.  A mapped read reports
its unitig and its start clamped at 0; the rest report -1 and -1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import dp
from .kmers import M32, fmix32, mul32, rotl32

K, W, CAP = 17, 17, 48
MATCH, MISMATCH, GAP_OPEN, GAP_EXT = 1, -2, 3, 1
MIN_SCORE = 50
PAD = 16
BLOCK = 1 << 16


def hash17(v: torch.Tensor) -> torch.Tensor:
    """32-bit hash of 17-mers held as 34-bit values (first base highest)."""
    h = torch.full_like(v, 0x9E3779B9)
    for word in (v >> 2, (v & 3) << 30):
        x = mul32(rotl32(mul32(word, 0xCC9E2D51), 15), 0x1B873593)
        h = (mul32(rotl32(h ^ x, 13), 5) + 0xE6546B64) & M32
    return fmix32(h)


def kmer_values(codes: torch.Tensor) -> torch.Tensor:
    """(..., L) codes -> (..., L - K + 1) 17-mer values (codes >= 4 as 0)."""
    c = torch.where(codes < 4, codes, 0).long()
    P = c.shape[-1] - K + 1
    v = torch.zeros(c.shape[:-1] + (P,), dtype=torch.int64, device=c.device)
    for j in range(K):
        v = (v << 2) | c[..., j:j + P]
    return v


def minimizer_marks(h: torch.Tensor, win_ok: torch.Tensor) -> torch.Tensor:
    """(..., P) bool: positions that are the leftmost least of h over a
    window of W starting at a position where win_ok (..., P - W + 1)."""
    P = h.shape[-1]
    votes = torch.zeros(h.shape, dtype=torch.int32, device=h.device)
    if P < W:
        return votes > 0
    first = torch.arange(P - W + 1, device=h.device)
    pick = first + torch.argmin(h.unfold(-1, W, 1), dim=-1)
    return votes.scatter_add_(-1, pick, win_ok.int()) > 0


@dataclass
class Index:
    """Singleton minimizers of a graph: ascending keys, their unitig and
    position, and the graph's pool and offsets on the device."""
    keys: torch.Tensor
    unitig: torch.Tensor
    pos: torch.Tensor
    pool: torch.Tensor
    off: torch.Tensor


def _marks_of(codes, lengths):
    """(values, marks) of reads (B, L) uint8 with lengths (B,)."""
    B, L = codes.shape
    v = kmer_values(codes)
    P = v.shape[1]
    bad = torch.zeros((B, L + 1), dtype=torch.int32, device=codes.device)
    bad[:, 1:] = torch.cumsum((codes >= 4).int(), 1)
    p = torch.arange(P, device=codes.device)[None, :]
    ln = lengths.long()[:, None]
    ok = (bad[:, K:K + P] == bad[:, :P]) & (p + K <= ln)
    h = torch.where(ok, hash17(v), M32)
    win = torch.arange(max(P - W + 1, 0), device=codes.device)[None, :]
    marks = minimizer_marks(h, win + W - 1 + K <= ln) & ok
    return v, marks


def build_index(g, device) -> Index:
    """Index of a RefGraph: every minimizer of every unitig, counted over
    the whole graph, the singletons kept."""
    pool = torch.as_tensor(g.pool).to(device)
    off = torch.as_tensor(g.off).to(device)
    N = len(pool)
    if N < K + W - 1:
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return Index(z, z, z, pool, off)
    v = kmer_values(pool)
    P = len(v)
    p = torch.arange(P, device=device)
    u = torch.searchsorted(off, p, right=True) - 1
    end = off[u + 1]
    ok = p + K <= end
    h = torch.where(ok, hash17(v), M32)
    win = p[:P - W + 1]
    marks = minimizer_marks(h, win + W - 1 + K <= end[:P - W + 1]) & ok
    at = torch.nonzero(marks).squeeze(1)
    key, inv, n = torch.unique(v[at], return_inverse=True,
                               return_counts=True)
    single = n[inv] == 1
    at = at[single]
    order = torch.argsort(v[at])
    at = at[order]
    return Index(v[at], u[at], at - off[u[at]], pool, off)


def vote(ix: Index, codes: torch.Tensor, lengths: torch.Tensor):
    """(unitig (B,) or -1, signed start (B,)) of each read's vote."""
    B = codes.shape[0]
    dev = codes.device
    v, marks = _marks_of(codes, lengths)
    P = v.shape[1]
    big = 1 << 30
    at = torch.where(marks, torch.arange(P, device=dev)[None, :], big)
    at = torch.sort(at, 1).values[:, :CAP]
    used = at < P
    atc = at.clamp(max=P - 1)
    key = torch.gather(v, 1, atc)
    nk = len(ix.keys)
    if nk == 0:
        return (torch.full((B,), -1, dtype=torch.int64, device=dev),
                torch.full((B,), -1, dtype=torch.int64, device=dev))
    i = torch.searchsorted(ix.keys, key).clamp(max=nk - 1)
    hit = used & (ix.keys[i] == key)
    unitig = ix.unitig[i]
    offset = ix.pos[i] - atc
    read = torch.arange(B, device=dev)[:, None].expand_as(hit)
    nu = len(ix.off)
    pair, inv, votes = torch.unique(read[hit] * nu + unitig[hit],
                                    return_inverse=True, return_counts=True)
    start = torch.full((len(pair),), big, dtype=torch.int64,
                       device=dev).scatter_reduce(0, inv, offset[hit], "amin")
    r, u = pair // nu, pair % nu
    best = torch.zeros(B, dtype=torch.int64, device=dev).scatter_reduce(
        0, r, votes, "amax")
    top = votes == best[r]
    n_top = torch.zeros(B, dtype=torch.int64, device=dev).index_add_(
        0, r[top], torch.ones_like(r[top]))
    win = top & (n_top[r] == 1)
    edge = torch.full((B,), -1, dtype=torch.int64, device=dev)
    st = torch.full((B,), -1, dtype=torch.int64, device=dev)
    edge[r[win]] = u[win]
    st[r[win]] = start[win]
    tot = hit.sum(1)
    sure = (best * 100 >= 85 * tot) | (tot <= 2)
    edge = torch.where(sure, edge, -1)
    return edge, torch.where(edge >= 0, st, -1)


def _window(pool, base, n, width):
    """(R, width) codes of pool[base:base+n] a row, 255 past n."""
    j = torch.arange(width, device=pool.device)[None, :]
    got = pool[(base[:, None] + j).clamp(0, len(pool) - 1)]
    return torch.where(j < n[:, None], got, 255)


def verify(ix: Index, codes, lengths, edge, start, with_dp: bool = True):
    """Accept (B,) bool of each voted read: the gapless score at its
    start over its on-unitig bases, else (with_dp) the fit DP."""
    B, L = codes.shape
    dev = codes.device
    mapped = edge >= 0
    e = edge.clamp(min=0)
    base, elen = ix.off[e], ix.off[e + 1] - ix.off[e]
    j = torch.arange(L, device=dev)[None, :]
    tpos = start[:, None] + j
    on = (tpos >= 0) & (tpos < elen[:, None]) & (j < lengths.long()[:, None])
    tc = ix.pool[(base[:, None] + tpos).clamp(0, len(ix.pool) - 1)]
    same = (codes == tc) & on
    n_on = on.sum(1)
    n_same = same.sum(1)
    bound = n_same * MATCH + (n_on - n_same) * MISMATCH
    ok = mapped & (n_on > 0) & (bound >= MIN_SCORE)
    rest = torch.nonzero(mapped & ~ok).squeeze(1)
    if not with_dp or len(rest) == 0:
        return ok
    s, el, ql0 = start[rest], elen[rest], lengths.long()[rest]
    qlo = (-s).clamp(min=0)
    qhi = torch.maximum(torch.minimum(ql0, el - s), qlo)
    qn = qhi - qlo
    s0 = torch.minimum((s + qlo).clamp(min=0), (el - 1).clamp(min=0))
    w0 = (s0 - PAD).clamp(min=0)
    w1 = torch.minimum(s0 + qn + PAD, el)
    jq = torch.arange(L, device=dev)[None, :]
    q = torch.gather(codes[rest], 1, (qlo[:, None] + jq).clamp(max=L - 1))
    q = torch.where(jq < qn[:, None], q, 255)
    t = _window(ix.pool, base[rest] + w0, w1 - w0, L + 2 * PAD)
    score = dp.fit_scores(q, qn, t, w1 - w0, MATCH, MISMATCH, GAP_OPEN,
                          GAP_EXT)
    ok[rest] = (qn > 0) & (score >= MIN_SCORE)
    return ok


def map_reads(ix: Index, bases: np.ndarray, lengths: np.ndarray, device,
              with_dp: bool = True):
    """(unitig, start) int64 host arrays of every read, -1 where none."""
    edges, starts = [], []
    for i in range(0, len(bases), BLOCK):
        c = torch.as_tensor(bases[i:i + BLOCK]).to(device)
        ln = torch.as_tensor(lengths[i:i + BLOCK]).to(device)
        e, s = vote(ix, c, ln)
        ok = verify(ix, c, ln, e, s, with_dp)
        e = torch.where(ok, e, -1)
        edges.append(e.cpu().numpy())
        starts.append(torch.where(e >= 0, s.clamp(min=0), -1).cpu().numpy())
    return np.concatenate(edges), np.concatenate(starts)
