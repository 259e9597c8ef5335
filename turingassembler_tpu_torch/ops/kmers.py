"""Batched k-mer window extraction (port of turingassembler_tpu/ops/kmers.py).

A batch of 255-padded reads becomes every k-window at once with k
shifted-OR tensor ops, canonicalized against the reverse-complement
read.  Limbs are int64 values in [0, 2^32) (see ops/limbs.py).
"""

from __future__ import annotations

import torch

from . import limbs as lb


def complement_bases(bases: torch.Tensor) -> torch.Tensor:
    """3 - b for valid bases; invalid codes (>= 4) stay invalid."""
    return torch.where(bases < 4, 3 - bases, bases)


def _pack_windows(bases: torch.Tensor, k: int) -> torch.Tensor:
    """All k-windows of each read, packed: (B, L) codes -> (B, P, nl)
    int64 with P = L - k + 1.  Invalid bases pack as 0."""
    B, L = bases.shape
    P = L - k + 1
    b = torch.where(bases < 4, bases, torch.zeros_like(bases)).long()
    out = []
    for l in range(lb.n_limbs(k)):
        acc = torch.zeros((B, P), dtype=torch.int64, device=bases.device)
        for j in range(l * 16, min(k, (l + 1) * 16)):
            acc |= b[:, j:j + P] << lb.base_shift(j)[1]
        out.append(acc)
    return torch.stack(out, dim=-1)


def window_validity(bases: torch.Tensor, lengths: torch.Tensor,
                    k: int) -> torch.Tensor:
    """(B, P) bool: the window holds no invalid base and fits the read."""
    B, L = bases.shape
    P = L - k + 1
    cum = torch.zeros((B, L + 1), dtype=torch.int32, device=bases.device)
    cum[:, 1:] = torch.cumsum((bases >= 4).int(), dim=1)
    n_bad = cum[:, k:] - cum[:, :P]
    pos = torch.arange(P, device=bases.device)[None, :]
    return (n_bad == 0) & (pos + k <= lengths[:, None])


def extract_canonical_kmers(bases: torch.Tensor, lengths: torch.Tensor,
                            k: int):
    """Canonical k-mers of every window of every read.

    bases (B, L) uint8 codes (>= 4 invalid/pad), lengths (B,) int32.
    Returns (canon (B, P, nl) int64, is_rc (B, P) bool, valid (B, P) bool).
    """
    fw = _pack_windows(bases, k)
    # window p of the fw read is window P-1-p of the rc read
    rc = _pack_windows(complement_bases(bases.flip(1)), k).flip(1)
    is_rc = lb.lex_lt(rc, fw)
    canon = torch.where(is_rc[..., None], rc, fw)
    return canon, is_rc, window_validity(bases, lengths, k)


def split_kedge(kedge_limbs: torch.Tensor, k: int):
    """(prefix, suffix) k-mers of packed (k+1)-mers: bases [0, k) and
    [1, k+1)."""
    nl_in = lb.n_limbs(k + 1)
    nl_out = lb.n_limbs(k)
    used = 2 * k - 32 * (nl_out - 1)
    last_mask = ((1 << used) - 1) << (32 - used) if used < 32 else lb.M32
    pre = [kedge_limbs[..., l] for l in range(nl_out)]
    pre[-1] = pre[-1] & last_mask
    suf = []
    for l in range(nl_out):
        x = (kedge_limbs[..., l] << 2) & lb.M32
        if l + 1 < nl_in:
            x = x | (kedge_limbs[..., l + 1] >> 30)
        suf.append(x)
    suf[-1] = suf[-1] & last_mask
    return torch.stack(pre, dim=-1), torch.stack(suf, dim=-1)


def kedge_first_base(kedge_limbs: torch.Tensor) -> torch.Tensor:
    """Base 0 of a packed (k+1)-mer."""
    return (kedge_limbs[..., 0] >> 30) & 3


def kedge_last_base(kedge_limbs: torch.Tensor, k: int) -> torch.Tensor:
    """Base k (the last) of a packed (k+1)-mer."""
    l, sh = lb.base_shift(k)
    return (kedge_limbs[..., l] >> sh) & 3
