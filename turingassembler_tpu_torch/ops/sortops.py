"""Host-side merge of sorted unique (k-mer, count) runs (numpy).

The numpy half of turingassembler_tpu/ops/sortops.py, copied: the
external-memory accumulation behind the count's spill branch
(kmer/megasort.py), analogous to the upstream spill + k-way merge
(src/sort_read.c:149-210) but over (kmer, count) runs instead of raw
reads.  The device half of that module is not ported.
"""

from __future__ import annotations

import os

import numpy as np


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
