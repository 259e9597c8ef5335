"""Sort and run-length count of multi-limb keys (port of
turingassembler_tpu/ops/sortops.py).

The device half: sort rows of limbs lexicographically, mark run starts,
run-length count them, and binary-search a sorted limb table.  It is the
JAX package's jitted code as tensor code, with the JAX shapes kept so
that whole arrays compare: fixed (N, nl) outputs padded past `n_unique`,
a trash slot N-1 for invalid rows, zero counts past the runs.  Limbs are
int64 values in [0, 2^32) (ops/limbs.py); invalid rows carry the
all-ones SENTINEL key, which sorts after every real one.

The numpy half, copied: the external-memory accumulation behind the
count's spill branch (kmer/megasort.py), analogous to the upstream
spill + k-way merge (src/sort_read.c:149-210) but over (kmer, count)
runs instead of raw reads.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import kmer_sort as ks
from . import limbs as lb

SENTINEL = lb.M32


def sort_by_limbs(limbs: torch.Tensor, *vals: torch.Tensor):
    """Sort rows of `limbs` (N, nl) lexicographically, carrying `vals`.
    Returns (sorted_limbs, sorted_vals...).  The sort is stable (the JAX
    one is not; equal keys carry equal values wherever the engines call
    it)."""
    perm = ks.lex_order(limbs)
    return (limbs[perm],) + tuple(v[perm] for v in vals)


run_starts = lb.run_starts    # the JAX name: (N,) bool, a new key run begins


def unique_counts(sorted_limbs: torch.Tensor, weights=None, valid=None):
    """Run-length encode sorted keys.

    Returns (unique_limbs (N, nl) zero-padded past the runs, counts (N,)
    int32 zero-padded, n_unique 0-d int64).  Invalid rows (valid False)
    must have been sorted to the end and are excluded; they write their
    key to the trash slot N-1, which lies past n_unique whenever an
    invalid row exists."""
    N = sorted_limbs.shape[0]
    dev = sorted_limbs.device
    if weights is None:
        weights = torch.ones(N, dtype=torch.int32, device=dev)
    weights = weights.to(torch.int32)
    if valid is not None:
        weights = torch.where(valid, weights, 0)
    starts = lb.run_starts(sorted_limbs)
    if valid is not None:
        starts = starts & valid
    seg = (torch.cumsum(starts, 0) - 1).clamp_min(0)
    counts = torch.zeros(N, dtype=torch.int32, device=dev)
    counts.index_add_(0, seg, weights)
    seg_w = seg if valid is None else torch.where(valid, seg, N - 1)
    uniq = torch.zeros_like(sorted_limbs)
    uniq[seg_w] = sorted_limbs          # a run writes one key to its slot
    n_unique = torch.where(starts.any(), seg[-1] + 1, 0)
    return uniq, counts, n_unique


def sort_unique_count(limbs_flat: torch.Tensor, valid_flat: torch.Tensor):
    """Sort k-mers, invalid ones replaced by the all-ones SENTINEL so
    they sort last, and run-length count them.  limbs_flat (N, nl),
    valid_flat (N,) bool.  Returns (unique (N, nl), counts (N,) int32,
    n_unique 0-d)."""
    keyed = torch.where(valid_flat[:, None], limbs_flat, SENTINEL)
    s_limbs, s_valid = sort_by_limbs(keyed, valid_flat)
    return unique_counts(s_limbs, weights=s_valid, valid=s_valid)


def padded_run(limbs_flat: torch.Tensor, valid_flat: torch.Tensor):
    """sort_unique_count as a run for the merge engine: (keys (N, nl)
    with SENTINEL rows past n_unique, counts (N,) int32 with 0 there,
    n_unique 0-d)."""
    uniq, counts, n_unique = sort_unique_count(limbs_flat, valid_flat)
    tail = torch.arange(uniq.shape[0], device=uniq.device) >= n_unique
    return (torch.where(tail[:, None], SENTINEL, uniq),
            torch.where(tail, 0, counts), n_unique)


def rank_in(table: torch.Tensor, queries: torch.Tensor,
            side: str = "left") -> torch.Tensor:
    """Number of rows of the sorted `table` (M, nl) that are < query
    (side "left") or <= query (side "right"), for each row of `queries`
    (Q, nl): a vectorised binary search, one step a loop turn
    (torch.searchsorted takes one key column only)."""
    M = table.shape[0]
    Q = queries.shape[0]
    lo = torch.zeros(Q, dtype=torch.int64, device=queries.device)
    hi = torch.full((Q,), M, dtype=torch.int64, device=queries.device)
    if M == 0:
        return lo
    for _ in range(math.ceil(math.log2(max(M, 2))) + 1):   # the JAX count
        mid = (lo + hi) // 2
        row = table[mid.clamp(0, M - 1)]
        if side == "left":
            go_right = lb.lex_lt(row, queries)          # table[mid] < q
        else:
            go_right = ~lb.lex_lt(queries, row)         # table[mid] <= q
        active = lo < hi     # a converged lane must not move past M
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def searchsorted_limbs(table: torch.Tensor, queries: torch.Tensor):
    """Index of each query row in a lexicographically sorted unique limb
    table (M, nl).  Returns (idx (Q,) int64, found (Q,) bool), idx
    clipped to [0, M-1] as the JAX function clips it (-1 when M == 0).
    Replaces kmhash_get probing (upstream src/kmhash.c:182-204)."""
    M = table.shape[0]
    lo = rank_in(table, queries)
    if M == 0:
        return torch.full_like(lo, -1), torch.zeros_like(lo, dtype=torch.bool)
    idx = lo.clamp(0, M - 1)
    found = (table[idx] == queries).all(dim=-1) & (lo < M)
    return idx, found


# ---------------------------------------------------------------------------
# Host-side merge of per-batch runs (numpy)
# ---------------------------------------------------------------------------

def np_merge_count_runs(runs):
    """Merge [(limbs (n,nl) uint32, counts (n,))...] -> (limbs, counts) sorted unique."""
    if not runs:
        return np.zeros((0, 0), np.uint32), np.zeros((0,), np.int64)
    limbs = np.concatenate([r[0] for r in runs], axis=0)
    counts = np.concatenate([np.asarray(r[1], np.int64) for r in runs])
    if limbs.shape[0] == 0:
        return limbs, counts
    order = np.lexsort(tuple(limbs[:, l] for l in range(limbs.shape[1] - 1, -1, -1)))
    limbs = limbs[order]
    counts = counts[order]
    starts = np.empty(limbs.shape[0], bool)
    starts[0] = True
    np.any(limbs[1:] != limbs[:-1], axis=1, out=starts[1:])
    idx = np.flatnonzero(starts)
    summed = np.add.reduceat(counts, idx)
    return limbs[idx], summed


def np_external_merge_runs(runs, *, chunk_rows: int = 1 << 22,
                           min_count: int = 1, out_dir=None):
    """Bounded-memory k-way merge of sorted-unique (keys, counts) runs.

    The host analogue of the reference's global k-way spill merge
    (src/sort_read.c:567-658) for COUNT tables: runs may be RAM arrays
    or disk memmaps; the merge proceeds in slices cut at limb0
    boundaries (the lexsort is limb0-major, so `limb0 < pivot`
    partitions every run consistently), touching only ~chunk_rows rows
    per run per slice.  With `out_dir`, output goes to disk memmaps
    (returned as memmap views) so peak RAM stays ~one slice.
    """
    runs = [r for r in runs if len(r[0])]
    if not runs:
        return np.zeros((0, 0), np.uint32), np.zeros((0,), np.int64)
    if len(runs) == 1 and min_count <= 1 and out_dir is None:
        return np.asarray(runs[0][0]), np.asarray(runs[0][1], np.int64)
    nl = runs[0][0].shape[1]
    total = sum(len(r[0]) for r in runs)

    # pivots from the largest run's limb0 column, deduped
    big = max(runs, key=lambda r: len(r[0]))[0]
    piv_rows = np.arange(chunk_rows, len(big), chunk_rows)
    pivots = np.unique(np.asarray(big[piv_rows, 0])) if len(piv_rows) else \
        np.zeros(0, np.uint32)

    out_k = out_c = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        out_k = np.lib.format.open_memmap(
            os.path.join(out_dir, "merged_keys.npy"), mode="w+",
            dtype=np.uint32, shape=(total, nl))
        out_c = np.lib.format.open_memmap(
            os.path.join(out_dir, "merged_counts.npy"), mode="w+",
            dtype=np.int64, shape=(total,))
    chunks_k, chunks_c = [], []
    pos = [0] * len(runs)
    n_out = 0
    bounds = list(pivots) + [None]
    for pv in bounds:
        slices = []
        for i, (rk, rc) in enumerate(runs):
            hi = len(rk) if pv is None else \
                int(np.searchsorted(rk[:, 0], pv, side="left"))
            if hi > pos[i]:
                slices.append((np.asarray(rk[pos[i]:hi]),
                               np.asarray(rc[pos[i]:hi], np.int64)))
            pos[i] = hi
        if not slices:
            continue
        mk, mc = np_merge_count_runs(slices)
        if min_count > 1:
            keep = mc >= min_count
            mk, mc = mk[keep], mc[keep]
        if out_k is not None:
            out_k[n_out:n_out + len(mk)] = mk
            out_c[n_out:n_out + len(mk)] = mc
        else:
            chunks_k.append(mk)
            chunks_c.append(mc)
        n_out += len(mk)
    if out_k is not None:
        return out_k[:n_out], out_c[:n_out]
    if not chunks_k:
        return np.zeros((0, nl), np.uint32), np.zeros((0,), np.int64)
    return np.concatenate(chunks_k), np.concatenate(chunks_c)
