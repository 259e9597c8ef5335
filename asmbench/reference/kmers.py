"""Canonical (k+1)-mer counting, plain.

A sequence of k bases is held as limbs of up to 31 bases, 2 bits a base
(A C G T = 0 1 2 3), the first base in the highest bits, so rows sort
lexicographically by their bases.  A window's canonical form is the
lexicographically smaller of its bases and their reverse complement.
"""

from __future__ import annotations

import torch

LIMB = 31
M32 = 0xFFFFFFFF
GROUP_ROWS = 1 << 26     # window rows counted together before a merge
READ_BLOCK = 1 << 16     # reads a block


def n_limbs(k: int) -> int:
    return -(-k // LIMB)


def encode(codes: torch.Tensor) -> torch.Tensor:
    """(m, k) codes 0-3 -> (m, n_limbs(k)) int64 rows."""
    m, k = codes.shape
    c = codes.long()
    out = []
    for lo in range(0, k, LIMB):
        acc = torch.zeros(m, dtype=torch.int64, device=codes.device)
        for j in range(lo, min(k, lo + LIMB)):
            acc = (acc << 2) | c[:, j]
        out.append(acc)
    return torch.stack(out, 1)


def decode(rows: torch.Tensor, k: int) -> torch.Tensor:
    """encode's inverse: (m, n_limbs(k)) int64 -> (m, k) uint8 codes."""
    cols = []
    for lo in range(0, k, LIMB):
        n = min(k, lo + LIMB) - lo
        limb = rows[:, lo // LIMB]
        cols += [(limb >> (2 * (n - 1 - j))) & 3 for j in range(n)]
    return torch.stack(cols, 1).to(torch.uint8)


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a < b over the last dimension's limbs."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(lt)
    for i in range(a.shape[-1]):
        lt |= eq & (a[..., i] < b[..., i])
        eq &= a[..., i] == b[..., i]
    return lt


def window_rows(bases: torch.Tensor, lengths: torch.Tensor,
                k1: int) -> torch.Tensor:
    """Canonical rows (n, n_limbs(k1)) of every window of k1 bases that
    lies inside its read and holds only codes 0-3; bases (B, W) uint8
    with any code >= 4 as padding, lengths (B,)."""
    B, W = bases.shape
    P = W - k1 + 1
    if P <= 0:
        return torch.zeros((0, n_limbs(k1)), dtype=torch.int64,
                           device=bases.device)
    bad = torch.zeros((B, W + 1), dtype=torch.int32, device=bases.device)
    bad[:, 1:] = torch.cumsum((bases >= 4).int(), 1)
    pos = torch.arange(P, device=bases.device)[None, :]
    valid = (bad[:, k1:] == bad[:, :P]) & (pos + k1 <= lengths.long()[:, None])
    b = torch.where(bases < 4, bases, 0).long()
    c = 3 - b
    fw, rc = [], []
    for lo in range(0, k1, LIMB):
        f = torch.zeros((B, P), dtype=torch.int64, device=bases.device)
        r = torch.zeros_like(f)
        for j in range(lo, min(k1, lo + LIMB)):
            f = (f << 2) | b[:, j:j + P]
            r = (r << 2) | c[:, k1 - 1 - j:k1 - 1 - j + P]
        fw.append(f)
        rc.append(r)
    fw, rc = torch.stack(fw, -1), torch.stack(rc, -1)
    canon = torch.where(lex_less(rc, fw)[..., None], rc, fw)
    return canon[valid]


def unique_rows(rows: torch.Tensor, weights: torch.Tensor | None = None):
    """(unique rows ascending, their summed weights (1 a row by default),
    each row's index among them), by stable sorts from the last limb to
    the first."""
    n = len(rows)
    perm = torch.arange(n, device=rows.device)
    for j in reversed(range(rows.shape[1])):
        perm = perm[torch.sort(rows[perm, j], stable=True).indices]
    s = rows[perm]
    new = torch.ones(n, dtype=torch.bool, device=rows.device)
    new[1:] = (s[1:] != s[:-1]).any(1)
    gid = torch.cumsum(new, 0) - 1
    w = torch.ones(n, dtype=torch.int64, device=rows.device) \
        if weights is None else weights[perm].long()
    sums = torch.zeros(int(new.sum()), dtype=torch.int64,
                       device=rows.device).index_add_(0, gid, w)
    inverse = torch.empty_like(gid)
    inverse[perm] = gid
    return s[new], sums, inverse


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for x in [0, 2^32), in int64 without overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser."""
    h = mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def fingerprint32(rows: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit hash of each row's limbs, taken as 31-bit words."""
    h = torch.full((len(rows),), 0x9747B28C, dtype=torch.int64,
                   device=rows.device)
    for j in range(rows.shape[1]):
        for word in (rows[:, j] >> 31, rows[:, j] & 0x7FFFFFFF):
            x = mul32(rotl32(mul32(word, 0xCC9E2D51), 15), 0x1B873593)
            h = (mul32(rotl32(h ^ x, 13), 5) + 0xE6546B64) & M32
    return fmix32(h)


def merge_by_fingerprint(rows: torch.Tensor, counts: torch.Tensor):
    """Sorted unique rows told apart by fingerprint32 alone, as a table
    that keeps a fingerprint and no key would: each fingerprint keeps
    its least row and the sum of its rows' counts."""
    h = fingerprint32(rows)
    order = torch.sort(h, stable=True).indices
    hs = h[order]
    first = torch.ones(len(hs), dtype=torch.bool, device=rows.device)
    first[1:] = hs[1:] != hs[:-1]
    gid = torch.cumsum(first, 0) - 1
    sums = torch.zeros(int(first.sum()), dtype=torch.int64,
                       device=rows.device).index_add_(0, gid, counts[order])
    u, c, _ = unique_rows(rows[order[first]], sums)
    return u, c


def count(reads, k1: int, min_count: int, device,
          fingerprinted: bool = False):
    """Sorted unique canonical k1-mer rows of `reads`, an iterable of
    host (bases (B, W) uint8, lengths (B,)) arrays, and their counts
    (int64), kept where the count is at least min_count.  With
    `fingerprinted` the rows are told apart by a 32-bit fingerprint
    alone before the cutoff (merge_by_fingerprint)."""
    parts_r, parts_c, pend, n_pend = [], [], [], 0

    def flush():
        nonlocal pend, n_pend
        if pend:
            u, c, _ = unique_rows(torch.cat(pend))
            parts_r.append(u)
            parts_c.append(c)
        pend, n_pend = [], 0

    for bases, lengths in reads:
        for i in range(0, len(bases), READ_BLOCK):
            rows = window_rows(
                torch.as_tensor(bases[i:i + READ_BLOCK]).to(device),
                torch.as_tensor(lengths[i:i + READ_BLOCK]).to(device), k1)
            pend.append(rows)
            n_pend += len(rows)
            if n_pend >= GROUP_ROWS:
                flush()
    flush()
    if not parts_r:
        return (torch.zeros((0, n_limbs(k1)), dtype=torch.int64,
                            device=device),
                torch.zeros(0, dtype=torch.int64, device=device))
    u, c = parts_r[0], parts_c[0]
    if len(parts_r) > 1:
        u, c, _ = unique_rows(torch.cat(parts_r), torch.cat(parts_c))
    if fingerprinted:
        u, c = merge_by_fingerprint(u, c)
    keep = c >= min_count
    return u[keep], c[keep]
