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

import numpy as np
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


# ---------------------------------------------------------------------------
# numpy twins on uint32 limbs, as the host graph code holds them (copies of
# the JAX package's np_* functions)
# ---------------------------------------------------------------------------

def np_pack_bases(bases: np.ndarray, k: int) -> np.ndarray:
    nl = n_limbs(k)
    b = np.where(bases < 4, bases, 0).astype(np.uint32)
    out = np.zeros(bases.shape[:-1] + (nl,), np.uint32)
    for j in range(k):
        l, sh = base_shift(j)
        out[..., l] |= b[..., j] << np.uint32(sh)
    return out


def np_unpack_limbs(limbs: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros(limbs.shape[:-1] + (k,), np.uint8)
    for j in range(k):
        l, sh = base_shift(j)
        out[..., j] = (limbs[..., l] >> np.uint32(sh)) & 3
    return out


def np_revcomp_limbs(limbs: np.ndarray, k: int) -> np.ndarray:
    bases = np_unpack_limbs(limbs, k)
    return np_pack_bases(3 - bases[..., ::-1], k)


def np_lex_lt(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.zeros(a.shape[:-1], bool)
    eq = np.ones(a.shape[:-1], bool)
    for l in range(a.shape[-1]):
        lt |= eq & (a[..., l] < b[..., l])
        eq &= a[..., l] == b[..., l]
    return lt


def np_lexsort_rows(limbs: np.ndarray):
    """Row order sorting limb rows lexicographically (limb 0 primary)."""
    return np.lexsort(tuple(limbs[:, l] for l in range(limbs.shape[1] - 1, -1, -1)))


def np_revcomp_limbs_fast(limbs: np.ndarray, k: int) -> np.ndarray:
    """Bitwise reverse-complement (numpy port of revcomp_limbs: no
    per-base loops — in-limb 2-bit reversal + limb reversal + realign)."""
    nl = n_limbs(k)
    x = (~limbs).astype(np.uint32)
    x = ((x & np.uint32(0x33333333)) << 2) | ((x >> 2) & np.uint32(0x33333333))
    x = ((x & np.uint32(0x0F0F0F0F)) << 4) | ((x >> 4) & np.uint32(0x0F0F0F0F))
    x = ((x & np.uint32(0x00FF00FF)) << 8) | ((x >> 8) & np.uint32(0x00FF00FF))
    x = ((x << np.uint32(16)) | (x >> np.uint32(16))).astype(np.uint32)
    rev = x[..., ::-1]
    pad_bits = 32 * nl - 2 * k
    if pad_bits:
        sh = np.uint32(pad_bits)
        ish = np.uint32(32 - pad_bits)
        out = np.empty_like(rev)
        for l in range(nl):
            hi = rev[..., l] << sh
            lo = (rev[..., l + 1] >> ish) if l + 1 < nl else np.uint32(0)
            out[..., l] = hi | lo
    else:
        out = rev.copy()
    used = 2 * k - 32 * (nl - 1)
    if used < 32:
        out[..., nl - 1] &= np.uint32(((1 << used) - 1) << (32 - used))
    return out


def np_split_kedge(kedges: np.ndarray, k: int):
    """(prefix, suffix) k-mers of packed (k+1)-mers — numpy bitwise port
    of kmers.split_kedge."""
    nl_in = kedges.shape[-1]
    nl_out = n_limbs(k)
    used = 2 * k - 32 * (nl_out - 1)
    last_mask = np.uint32(((1 << used) - 1) << (32 - used)) if used < 32 \
        else np.uint32(0xFFFFFFFF)
    prefix = kedges[..., :nl_out].copy()
    prefix[..., nl_out - 1] &= last_mask
    suffix = np.empty_like(prefix)
    for l in range(nl_out):
        hi = kedges[..., l] << np.uint32(2)
        lo = (kedges[..., l + 1] >> np.uint32(30)) if l + 1 < nl_in else np.uint32(0)
        suffix[..., l] = hi | lo
    suffix[..., nl_out - 1] &= last_mask
    return prefix, suffix


def np_base_at(limbs: np.ndarray, j: int) -> np.ndarray:
    """Base j of each packed row."""
    l, sh = base_shift(j)
    return ((limbs[..., l] >> np.uint32(sh)) & np.uint32(3)).astype(np.uint8)
