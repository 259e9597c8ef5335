"""Merge of sorted multi-limb (key, count) runs (port of
turingassembler_tpu/ops/merge.py).

For two sorted runs A and B the merged position of A[i] is i + rank(A[i]
in B), found by a vectorised binary search (ops/sortops.rank_in), and
both runs land in one scatter; equal keys (at most one a side) are then
collapsed by a run-length pass.  DeviceCountAccumulator keeps a
log-structured stack of such runs, so no sort is ever wider than one
batch.  This mirrors the upstream external-memory posture (KMC's k-way
disk merge, src/sort_read.c:149-210) but keeps the runs on the device.

Sentinel convention (the JAX one): padded rows are all-ones keys
(SENTINEL in every limb), sort after every real key, and carry count 0;
capacities are fixed, n + m for a merge of n and m rows.  Limbs are
int64 values in [0, 2^32) (ops/limbs.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .sortops import SENTINEL, rank_in


def merge_runs(a: torch.Tensor, ca: torch.Tensor, b: torch.Tensor,
               cb: torch.Tensor):
    """Merge sorted sentinel-padded (keys, counts) runs.

    a (n, nl), ca (n,); b (m, nl), cb (m,).  Returns (keys (n+m, nl),
    counts (n+m,), n_unique 0-d): equal keys collapsed with their counts
    summed, the tail SENTINEL rows with count 0."""
    n, nl = a.shape
    m = b.shape[0]
    total = n + m
    dev = a.device
    pos_a = torch.arange(n, device=dev) + rank_in(b, a, "left")
    pos_b = torch.arange(m, device=dev) + rank_in(a, b, "right")
    keys = torch.full((total, nl), SENTINEL, dtype=a.dtype, device=dev)
    counts = torch.zeros(total, dtype=ca.dtype, device=dev)
    keys[pos_a] = a                     # merge positions are all distinct
    keys[pos_b] = b
    counts[pos_a] = ca
    counts[pos_b] = cb.to(ca.dtype)

    # collapse adjacent equal keys (one a side at most)
    valid = (keys != SENTINEL).any(dim=-1)
    starts = torch.ones(total, dtype=torch.bool, device=dev)
    starts[1:] = (keys[1:] != keys[:-1]).any(dim=-1)
    starts &= valid
    seg = (torch.cumsum(starts, 0) - 1).clamp_min(0)
    out_counts = torch.zeros(total, dtype=ca.dtype, device=dev)
    out_counts.index_add_(0, seg, counts * valid)
    seg_w = torch.where(valid, seg, total - 1)
    out_keys = torch.full((total, nl), SENTINEL, dtype=a.dtype, device=dev)
    out_keys[seg_w] = torch.where(valid[:, None], keys, SENTINEL)
    n_unique = torch.where(starts.any(), seg[-1] + 1, 0)
    # re-sentinel the tail (slot total-1 may hold an invalid row's write)
    tail = torch.arange(total, device=dev) >= n_unique
    out_keys[tail] = SENTINEL
    out_counts[tail] = 0
    return out_keys, out_counts, n_unique


class DeviceCountAccumulator:
    """Log-structured accumulator of sorted unique (k-mer, count) runs.

    add_run() pushes one sorted sentinel-padded run (a batch tile's
    run-length output); runs of equal capacity are merged at once, so
    about log2(#tiles) runs are live.  finalize() merges the rest and
    returns host numpy (keys uint32, counts int64) trimmed to the valid
    rows."""

    def __init__(self):
        self.runs = []      # [(keys, counts)], capacity == shape[0]

    def _merge_top(self) -> None:
        b_keys, b_counts = self.runs.pop()
        a_keys, a_counts = self.runs.pop()
        k, c, _ = merge_runs(a_keys, a_counts, b_keys, b_counts)
        self.runs.append((k, c))

    def add_run(self, keys: torch.Tensor, counts: torch.Tensor) -> None:
        self.runs.append((keys, counts))
        while len(self.runs) >= 2 and \
                self.runs[-1][0].shape[0] == self.runs[-2][0].shape[0]:
            self._merge_top()

    def finalize(self):
        if not self.runs:
            return np.zeros((0, 0), np.uint32), np.zeros((0,), np.int64)
        while len(self.runs) >= 2:
            self._merge_top()
        keys, counts = self.runs[0]
        n = int((keys != SENTINEL).any(dim=-1).sum())
        # valid rows are a prefix by construction
        return (keys[:n].cpu().numpy().astype(np.uint32),
                counts[:n].cpu().numpy().astype(np.int64))
