"""Multi-limb k-mer representation (port of turingassembler_tpu/ops/limbs.py).

A k-mer is `nl = ceil(k/16)` 32-bit limbs, limb 0 most significant; base
j (0-based from the 5' end) occupies bits [30 - (2j mod 32), 31 - (2j mod
32)] of limb 2j // 32, so lexicographic order on base strings is
limbwise-lexicographic numeric order.  Encoding: A=0 C=1 G=2 T=3,
complement 3 - x, codes >= 4 invalid.

Limbs are carried as int64 tensors holding values in [0, 2^32): torch has
no unsigned 32-bit shifts on the CPU.  Every left shift and multiply is
masked back to 32 bits, and `mul32` splits its multiplier so that no
intermediate leaves the int64 range.  The all-ones limb 0xFFFFFFFF is a
plain positive int64 value, never -1.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def n_limbs(k: int) -> int:
    """Number of 32-bit limbs needed for a k-mer."""
    return (k + 15) // 16


def base_shift(j: int) -> tuple:
    """(limb index, left-shift) for base j of a k-mer."""
    return (2 * j) // 32, 30 - ((2 * j) % 32)


def mul32(x, c: int):
    """x * c mod 2^32 for x in [0, 2^32) held as int64 (torch or numpy):
    the two 16-bit halves of c keep every product below 2^49."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def rotl32(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def pack_bases(bases: torch.Tensor, k: int) -> torch.Tensor:
    """Base codes (..., k) -> limbs (..., nl) int64.  Invalid codes (>= 4)
    pack as 0; callers track validity separately."""
    b = torch.where(bases < 4, bases, torch.zeros_like(bases)).long()
    limbs = []
    for l in range(n_limbs(k)):
        acc = torch.zeros(bases.shape[:-1], dtype=torch.int64,
                          device=bases.device)
        for j in range(l * 16, min(k, (l + 1) * 16)):
            acc |= b[..., j] << base_shift(j)[1]
        limbs.append(acc)
    return torch.stack(limbs, dim=-1)


def unpack_limbs(limbs: torch.Tensor, k: int) -> torch.Tensor:
    """limbs (..., nl) -> base codes (..., k) uint8."""
    cols = []
    for j in range(k):
        l, sh = base_shift(j)
        cols.append(((limbs[..., l] >> sh) & 3).to(torch.uint8))
    return torch.stack(cols, dim=-1)


def _rev2bits_in_u32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups inside each 32-bit value."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & M32) | (x >> 16)


def revcomp_limbs(limbs: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers without unpacking: complement
    the bits, reverse the 2-bit groups in each limb, reverse the limb
    order, then shift out the 32*nl - 2k pad bits now at the top."""
    nl = n_limbs(k)
    pad_bits = 32 * nl - 2 * k
    rev = _rev2bits_in_u32(limbs ^ M32).flip(-1)
    if pad_bits:
        cols = []
        for l in range(nl):
            hi = (rev[..., l] << pad_bits) & M32
            if l + 1 < nl:
                hi = hi | (rev[..., l + 1] >> (32 - pad_bits))
            cols.append(hi)
        rev = torch.stack(cols, dim=-1)
    used = 2 * k - 32 * (nl - 1)
    if used < 32:
        mask = torch.full((nl,), M32, dtype=torch.int64, device=limbs.device)
        mask[-1] = ((1 << used) - 1) << (32 - used)
        rev = rev & mask
    return rev


def lex_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the last (limb) axis."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for l in range(a.shape[-1]):
        lt = lt | (eq & (a[..., l] < b[..., l]))
        eq = eq & (a[..., l] == b[..., l])
    return lt


def lex_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)


def lex_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return lex_lt(a, b) | lex_eq(a, b)


def canonicalize(limbs: torch.Tensor, k: int):
    """(min(kmer, revcomp(kmer)), is_rc)."""
    rc = revcomp_limbs(limbs, k)
    is_rc = lex_lt(rc, limbs)
    return torch.where(is_rc[..., None], rc, limbs), is_rc


def lex_order(keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows (M, nl) lexicographically, column 0
    primary: stable LSD passes, one torch.sort per column, last first.
    Rows with equal keys keep their input order."""
    perm = torch.argsort(keys[:, -1], stable=True)
    for l in range(keys.shape[1] - 2, -1, -1):
        perm = perm[torch.argsort(keys[perm, l], stable=True)]
    return perm


def run_starts(s: torch.Tensor) -> torch.Tensor:
    """(M,) bool marking the first row of each run of equal rows of a
    sorted (M, nl) tensor."""
    new = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    if s.shape[0] > 1:
        new[1:] = (s[1:] != s[:-1]).any(dim=1)
    return new


def hash_limbs(limbs: torch.Tensor, seed: int = 0x9E3779B9) -> torch.Tensor:
    """32-bit murmur3-style mix of all limbs, bit-exact with the JAX
    package's hash_limbs (node numbering depends on it)."""
    h = torch.full(limbs.shape[:-1], seed, dtype=torch.int64,
                   device=limbs.device)
    for l in range(limbs.shape[-1]):
        x = mul32(limbs[..., l], 0xCC9E2D51)
        x = mul32(rotl32(x, 15), 0x1B873593)
        h = rotl32(h ^ x, 13)
        h = (mul32(h, 5) + 0xE6546B64) & M32
    return fmix32(h)


def fmix32(h):
    """murmur3's 32-bit finaliser on int64-held values (torch or numpy)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)
