"""2-1-2 repeat resolution — rebuild of src/resolve_big.c +
build_hash_table.c (port of turingassembler_tpu/resolve/big.py).

A "2-1-2" is a short middle edge e with exactly two in-legs (a0, a1) and
two out-legs (o0, o1).  Two resolvers:

  by span k-mers (resolve_using_pair_kmer :401-446): count 111-bp read
    windows (BIG_KSIZE, assembly_graph.h:22) in a table built from all
    reads (ust_add_big_kmer build_hash_table.c:78-101); for each leg
    combination build the joined span a.e.o (get_pair_seq_count :56-93)
    and sum its window counts; join the majority pairing with
    asm_join_edge3 when both its spans have support.

  by coverage (resolve_212_by_cov_1step :496-545): legs pair up when
    their coverages separate >= 1.7x on both sides and match across
    (similar_cov = within 0.8x).

The span table is built on `device`: windows are hashed to two 32-bit
lanes (ops/limbs.hash_limbs, two seeds) and counted by the sort and
merge engine the k-mer counter uses (ops/sortops.py, ops/merge.py);
identity collisions at 64 bits are as unlikely as the reference's
MurmurHash3_x64_64 keys.  The host half is copied line for line.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..graph.mutable import MutableGraph
from ..ops import kmers as km
from ..ops import limbs as lb
from ..ops.merge import DeviceCountAccumulator
from ..ops.sortops import padded_run, searchsorted_limbs

BIG_KSIZE = 111       # reference assembly_graph.h:22
DISTANCE_KMER = 60    # :20
KMER_PAIR_SIZE = 51   # :21
NOT_LONG_ENOUGH = 2   # :24
NOT_HAVE_SPAN_KMER = 3  # :25


def _window_hashes(bases: torch.Tensor, lengths: torch.Tensor, k: int):
    """(B, P, 2) hash lanes (int64 values in [0, 2^32)) and (B, P)
    validity for all k-windows."""
    packed = km._pack_windows(bases, k)         # (B, P, nl)
    valid = km.window_validity(bases, lengths, k)
    B, P, nl = packed.shape
    flat = packed.reshape(B * P, nl)
    h1 = lb.hash_limbs(flat, seed=0x9E3779B9).reshape(B, P)
    h2 = lb.hash_limbs(flat, seed=0x85EBCA6B).reshape(B, P)
    return torch.stack([h1, h2], dim=-1), valid


def _hash_count_tile(hashes: torch.Tensor, valid: torch.Tensor):
    """One batch's hash pairs -> sorted unique run, SENTINEL-padded."""
    return padded_run(hashes.reshape(-1, 2), valid.reshape(-1))[:2]


class SpanKmerTable:
    """Sorted (hash-pair -> count) table of BIG_KSIZE read windows; keys
    (n, 2) uint32 and counts (n,) int64 on the host, as in the JAX
    package; count_span runs on `device`."""

    def __init__(self, keys: np.ndarray, counts: np.ndarray,
                 k: int = BIG_KSIZE, *, device: str | torch.device = "cuda"):
        self.keys = keys
        self.counts = counts
        self.k = k
        self.device = resolve_device(device)
        self._keys_dev = None

    @classmethod
    def build(cls, reads: np.ndarray, lengths: np.ndarray,
              k: int = BIG_KSIZE, batch_size: int = 4096, *,
              device: str | torch.device = "cuda") -> "SpanKmerTable":
        dev = resolve_device(device)
        acc = DeviceCountAccumulator()
        if reads.shape[1] >= k:
            for i in range(0, len(reads), batch_size):
                rb = torch.as_tensor(np.ascontiguousarray(
                    reads[i:i + batch_size], np.uint8)).to(dev)
                lns = torch.as_tensor(np.ascontiguousarray(
                    lengths[i:i + batch_size], np.int32)).to(dev)
                acc.add_run(*_hash_count_tile(*_window_hashes(rb, lns, k)))
        keys, counts = acc.finalize()
        return cls(keys, counts, k, device=dev)

    def count_span(self, seq: np.ndarray) -> int:
        """Sum of window counts of `seq` (uint8 codes); -1 when it is
        shorter than k or the table is empty."""
        if len(seq) < self.k or len(self.keys) == 0:
            return -1
        if self._keys_dev is None:
            self._keys_dev = torch.from_numpy(
                self.keys.astype(np.int64)).to(self.device)
        bases = torch.as_tensor(np.ascontiguousarray(seq, np.uint8))[None, :]
        lengths = torch.tensor([len(seq)], dtype=torch.int32)
        hashes, valid = _window_hashes(bases.to(self.device),
                                       lengths.to(self.device), self.k)
        idx, found = searchsorted_limbs(self._keys_dev, hashes.reshape(-1, 2))
        idx = idx.cpu().numpy()
        found = (found & valid.reshape(-1)).cpu().numpy()
        return int(self.counts[idx[found]].sum())


def _legs(g: MutableGraph, i_e: int):
    source = g.edges[i_e].source
    target = g.edges[i_e].target
    src_rc = g.node_rc[source]
    i_a0 = g.edges[g.node_adj[src_rc][0]].rc_id
    i_a1 = g.edges[g.node_adj[src_rc][1]].rc_id
    i_o0 = g.node_adj[target][0]
    i_o1 = g.node_adj[target][1]
    return i_a0, i_a1, i_o0, i_o1


def is_case_2_1_2(g: MutableGraph, i_e: int) -> bool:
    """reference resolve_big.c is_case_2_1_2."""
    if g.edges[i_e].source == -1:
        return False
    source = g.edges[i_e].source
    target = g.edges[i_e].target
    src_rc = g.node_rc[source]
    if g.deg(target) != 2 or g.deg(src_rc) != 2:
        return False
    i_a0r = g.node_adj[src_rc][0]
    i_a1r = g.node_adj[src_rc][1]
    i_a0, i_a1 = g.edges[i_a0r].rc_id, g.edges[i_a1r].rc_id
    i_o0 = g.node_adj[target][0]
    i_o1 = g.node_adj[target][1]
    if g.edges[i_a0].rc_id in (i_o0, i_o1) or g.edges[i_a1].rc_id in (i_o0, i_o1):
        return False
    if g.edges[i_a0].rc_id == i_a1 or g.edges[i_a1].rc_id == i_a0:
        return False
    return True


def _span_seq(g: MutableGraph, left: int, right: int, mid: int) -> Optional[np.ndarray]:
    """Joined a.e.o span trimmed like get_pair_seq_count (resolve_big.c:56-93)."""
    k = g.ksize
    le, re, me = g.edges[left], g.edges[right], g.edges[mid]
    span = BIG_KSIZE
    mid_len = me.seq_len
    left_len = min(le.seq_len - k, span - mid_len - 1)
    right_len = min(re.seq_len - k, span - mid_len - 1)
    if left_len + mid_len + right_len < span:
        return None
    return np.concatenate([
        le.seq[le.seq_len - k - left_len : le.seq_len - k],
        me.seq,
        re.seq[k : k + right_len],
    ])


def resolve_using_pair_kmer(g: MutableGraph, i_e: int, table: SpanKmerTable) -> int:
    if not is_case_2_1_2(g, i_e):
        return 1
    e = g.edges[i_e]
    if e.seq_len > DISTANCE_KMER + KMER_PAIR_SIZE - 2:
        return NOT_LONG_ENOUGH
    i_a0, i_a1, i_o0, i_o1 = _legs(g, i_e)

    def cnt(a, o):
        s = _span_seq(g, a, o, i_e)
        return -1 if s is None else table.count_span(s)

    c00, c01 = cnt(i_a0, i_o0), cnt(i_a0, i_o1)
    c10, c11 = cnt(i_a1, i_o0), cnt(i_a1, i_o1)
    half = g.edges[i_e].count // 2
    if c00 > 0 and c11 > 0 and c00 + c11 > c10 + c01:
        g.join_edge3(i_a0, i_e, i_o0, half)
        g.join_edge3(i_a1, i_e, i_o1, half)
        g.remove_edge_pair(i_e)
        return 0
    if c10 > 0 and c01 > 0 and c10 + c01 > c00 + c11:
        g.join_edge3(i_a0, i_e, i_o1, half)
        g.join_edge3(i_a1, i_e, i_o0, half)
        g.remove_edge_pair(i_e)
        return 0
    return NOT_HAVE_SPAN_KMER


def resolve_212_pair_kmer_all(g: MutableGraph, table: SpanKmerTable) -> int:
    n = 0
    for i_e in range(g.n_e):
        if g.edges[i_e].source == -1:
            continue
        if resolve_using_pair_kmer(g, i_e, table) == 0:
            n += 1
    return n


def _similar_cov(c1: float, c2: float) -> bool:
    return c2 > c1 * 0.8 and c1 > c2 * 0.8


def _try_212_cov(g: MutableGraph, i_e: int) -> int:
    """Single-edge body of the coverage 2-1-2 resolution (reference
    resolve_212_by_cov, src/resolve_big.c): join when each in-leg has a
    >=1.7x coverage-dominant partner out-leg with matching coverage."""
    if g.edges[i_e].source == -1 or not is_case_2_1_2(g, i_e):
        return 0
    i_a0, i_a1, i_o0, i_o1 = _legs(g, i_e)
    a0, a1 = g.edges[i_a0], g.edges[i_a1]
    o0, o1 = g.edges[i_o0], g.edges[i_o1]
    nodes = [a0.source, a0.target, a1.source, o0.source, o0.target, o1.target]
    expanded = []
    for u in nodes:
        expanded += [u, g.node_rc[u]]
    if len(set(expanded)) != len(expanded):
        return 0
    ca0, ca1 = g.edge_cov(i_a0), g.edge_cov(i_a1)
    co0, co1 = g.edge_cov(i_o0), g.edge_cov(i_o1)
    if not (ca0 > 1.7 * ca1 or ca1 > 1.7 * ca0):
        return 0
    if not (co0 > 1.7 * co1 or co1 > 1.7 * co0):
        return 0
    half = g.edges[i_e].count // 2
    if _similar_cov(ca0, co0) and _similar_cov(ca1, co1):
        g.join_edge3(i_a0, i_e, i_o0, half)
        g.join_edge3(i_a1, i_e, i_o1, half)
        g.remove_edge_pair(i_e)
        return 1
    if _similar_cov(ca0, co1) and _similar_cov(ca1, co0):
        g.join_edge3(i_a0, i_e, i_o1, half)
        g.join_edge3(i_a1, i_e, i_o0, half)
        g.remove_edge_pair(i_e)
        return 1
    return 0


def resolve_212_by_cov_1step(g: MutableGraph) -> int:
    count = 0
    for i_e in range(g.n_e):
        if g.edges[i_e].source == -1 or not is_case_2_1_2(g, i_e):
            continue
        i_a0, i_a1, i_o0, i_o1 = _legs(g, i_e)
        a0, a1 = g.edges[i_a0], g.edges[i_a1]
        o0, o1 = g.edges[i_o0], g.edges[i_o1]
        nodes = [a0.source, a0.target, a1.source, o0.source, o0.target, o1.target]
        expanded = []
        for u in nodes:
            expanded += [u, g.node_rc[u]]
        if len(set(expanded)) != len(expanded):
            continue
        ca0, ca1 = g.edge_cov(i_a0), g.edge_cov(i_a1)
        co0, co1 = g.edge_cov(i_o0), g.edge_cov(i_o1)
        if not (ca0 > 1.7 * ca1 or ca1 > 1.7 * ca0):
            continue
        if not (co0 > 1.7 * co1 or co1 > 1.7 * co0):
            continue
        half = g.edges[i_e].count // 2
        if _similar_cov(ca0, co0) and _similar_cov(ca1, co1):
            g.join_edge3(i_a0, i_e, i_o0, half)
            g.join_edge3(i_a1, i_e, i_o1, half)
            g.remove_edge_pair(i_e)
            count += 1
        elif _similar_cov(ca0, co1) and _similar_cov(ca1, co0):
            g.join_edge3(i_a0, i_e, i_o1, half)
            g.join_edge3(i_a1, i_e, i_o0, half)
            g.remove_edge_pair(i_e)
            count += 1
    return count


def _gate_212(g: MutableGraph, i_e: int) -> bool:
    e = g.edges[i_e]
    if e.source == -1:
        return False
    return g.deg(e.target) == 2 and g.deg(g.node_rc[e.source]) == 2


def resolve_212_by_cov(g: MutableGraph) -> int:
    """Worklist fixpoint of the coverage 2-1-2 pass — same result as
    `while resolve_212_by_cov_1step(g)` (the full rescans only ever act
    on edges passing the cheap 2-1-2 topology gate, and an untouched
    non-candidate repeats its outcome), but each round visits only
    gated candidates and mutations re-enqueue their distance-1
    neighborhood via the MutableGraph journal (the same pattern as
    resolve/barcodes' n-m worklists)."""
    import heapq

    from .barcodes import _dirty_edges

    total = 0
    pending = sorted(e for e in range(g.n_e) if _gate_212(g, e))
    while True:
        cnt_local = 0
        n_round = g.n_e
        heap = list(pending)
        heapq.heapify(heap)
        seen = set()
        nxt = set()
        while heap:
            i_e = heapq.heappop(heap)
            if i_e in seen:
                continue
            seen.add(i_e)
            if not _gate_212(g, i_e):
                continue
            g.touch_log = set()
            c = _try_212_cov(g, i_e)
            touched = g.touch_log
            g.touch_log = None
            cnt_local += c
            if touched:
                for d in _dirty_edges(g, touched):
                    if d >= n_round or d <= i_e or d in seen:
                        nxt.add(d)
                    else:
                        heapq.heappush(heap, d)
                nxt.add(i_e)
        total += cnt_local
        if cnt_local == 0:
            return total
        pending = sorted(d for d in nxt if d < g.n_e)
