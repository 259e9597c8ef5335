"""Reference binseq packing: 16 bases per uint32, base i at bits (2*(i%16)).

Matches `__binseq_get/__binseq_set` (reference src/assembly_graph.h:182-187):
little-endian within each word, word i>>4.  Used only at serialization
boundaries; in-memory we keep plain uint8 codes.
"""

from __future__ import annotations

import numpy as np


def pack_binseq(codes: np.ndarray) -> np.ndarray:
    """codes (n,) uint8 in 0..3 -> packed uint32 words, ceil(n/16)."""
    n = len(codes)
    nw = (n + 15) >> 4
    padded = np.zeros(nw * 16, np.uint32)
    padded[:n] = codes
    shifts = (np.arange(16, dtype=np.uint32) * 2)
    words = (padded.reshape(nw, 16) << shifts[None, :]).astype(np.uint32)
    return np.bitwise_or.reduce(words, axis=1).astype(np.uint32)


def unpack_binseq(words: np.ndarray, n: int) -> np.ndarray:
    """packed uint32 words -> codes (n,) uint8."""
    shifts = (np.arange(16, dtype=np.uint32) * 2)
    all_codes = ((words[:, None] >> shifts[None, :]) & 3).astype(np.uint8).reshape(-1)
    return all_codes[:n]
