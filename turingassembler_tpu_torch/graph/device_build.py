"""Level-0 de Bruijn graph construction on the device (port of
turingassembler_tpu/graph/device_build.py).

Input is the sorted unique k-edge table of kmer/megasort.py: (k+1)-mer
limb rows (n, nl) int64 and counts (n,) int32.  Directed k-edge lanes
are [0, n) in canonical orientation and [n, 2n) reverse-complemented;
the JAX package pads the table to a power-of-two capacity, and every
ordering here (node ids, unitig ids, cycle breaks) is by lane index in
the same relative order, so the graph arrays come out identical.

  _front         node ids by fingerprint sort; adjacency bits, degrees,
                 successor and predecessor pointers
  _rank_chains   pointer doubling to (head, distance), one .any() sync
                 per round for the early exit
  _break_cycles  circular unitigs break at their rc-mirror-consistent
                 minimum adjacency
  _assemble      unitig arrays and the base pool

Scatters with duplicate indices (the successor and predecessor tables)
resolve to the highest lane, which is what the JAX package's in-order
scatter leaves; only the adjacency bits see duplicates otherwise, all
writing True.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import kmer_sort as ks
from ..ops import kmers as km
from ..ops import limbs as lb
from .structs import AsmGraph

SENTINEL = lb.M32


def _fingerprints(limbs: torch.Tensor):
    """Two independent 32-bit mixes; 0xFFFFFFFF is remapped in the first
    as the JAX package does (it reserves the value for invalid lanes), so
    the node order matches."""
    fpA = lb.hash_limbs(limbs)
    fpB = lb.hash_limbs(limbs, seed=0x27D4EB2F)
    fpA = torch.where(fpA == SENTINEL, SENTINEL - 1, fpA)
    return fpA, fpB


def _rounds(D: int) -> int:
    return max(1, int(np.ceil(np.log2(max(D, 2)))) + 1)


def _front(uniq: torch.Tensor, k: int):
    """k-edges -> directed-k-edge successor structure + chain ranking.
    Returns (src_key, tgt_key, lastbase, prev_ptr, head_of, dist, n_cyc)."""
    n = uniq.shape[0]
    D = 2 * n
    dev = uniq.device
    first = km.kedge_first_base(uniq)
    last = km.kedge_last_base(uniq, k)
    pre, suf = km.split_kedge(uniq, k)
    pre_rc = lb.revcomp_limbs(pre, k)
    suf_rc = lb.revcomp_limbs(suf, k)
    o_pre = lb.lex_lt(pre_rc, pre).long()
    o_suf = lb.lex_lt(suf_rc, suf).long()
    cpre = torch.where(o_pre[:, None] == 1, pre_rc, pre)
    csuf = torch.where(o_suf[:, None] == 1, suf_rc, suf)

    # dense node ids in ascending (fpA, fpB) order
    fpA, fpB = _fingerprints(torch.cat([cpre, csuf]))
    fp = torch.stack([fpA, fpB], dim=1)
    order = ks.lex_order(fp)
    seg = torch.cumsum(lb.run_starts(fp[order]), 0) - 1
    node = torch.empty(D, dtype=torch.int64, device=dev)
    node[order] = seg
    node_pre, node_suf = node[:n], node[n:]

    # adjacency bits: node*8 + orient*4 + base (fw bits 0-3, rv bits 4-7)
    adj = torch.zeros(8 * D, dtype=torch.bool, device=dev)
    adj[node_pre * 8 + o_pre * 4 + last] = True
    adj[node_suf * 8 + (1 - o_suf) * 4 + (3 - first)] = True
    degs = adj.view(2 * D, 4).sum(dim=1)          # per (node, orient)

    src_node = torch.cat([node_pre, node_suf])
    src_or = torch.cat([o_pre, 1 - o_suf])
    tgt_node = torch.cat([node_suf, node_pre])
    tgt_or = torch.cat([o_suf, 1 - o_pre])
    lastbase = torch.cat([last, 3 - first]).to(torch.uint8)
    src_key = src_node * 2 + src_or
    tgt_key = tgt_node * 2 + tgt_or
    d_idx = torch.arange(D, device=dev)

    succ = torch.full((2 * D,), -1, dtype=torch.int64, device=dev)
    succ.scatter_reduce_(0, src_key, d_idx, "amax")
    can = (degs[tgt_key] == 1) & (degs[tgt_node * 2 + (1 - tgt_or)] == 1)
    nxt = torch.where(can, succ[tgt_key], -1)
    nxt = torch.where(nxt == d_idx, -1, nxt)      # palindromic self-successor

    prev_exists = (degs[src_key] == 1) & \
        (degs[src_node * 2 + (1 - src_or)] == 1)
    has = nxt >= 0
    prv = torch.full((D,), -1, dtype=torch.int64, device=dev)
    prv.scatter_reduce_(0, nxt[has], d_idx[has], "amax")
    prev_ptr = torch.where(prev_exists & (prv >= 0), prv, -1)

    head_of, dist = _rank_chains(prev_ptr)
    n_cyc = int((prev_ptr[head_of] >= 0).sum())
    return src_key, tgt_key, lastbase, prev_ptr, head_of, dist, n_cyc


def _rank_chains(prev_ptr: torch.Tensor):
    """(head index, distance) per lane by Wyllie pointer doubling; stops
    once no lane's ancestor moved (a host sync per round)."""
    D = prev_ptr.shape[0]
    d_idx = torch.arange(D, device=prev_ptr.device)
    anc = torch.where(prev_ptr < 0, d_idx, prev_ptr)
    dist = (prev_ptr >= 0).long()
    for _ in range(_rounds(D)):
        step = dist[anc]
        dist = dist + step
        anc = anc[anc]
        if not bool((step > 0).any()):
            break
    return anc, dist


def _break_cycles(prev_ptr: torch.Tensor, head_of: torch.Tensor):
    """Pure cycles (circular unitigs).  The fw and rc copies of a circular
    unitig are two cycles that must break at mirrored adjacencies: each
    adjacency (prev(d) -> d) is keyed by min(enc(prev, d), enc(rc(d),
    rc(prev))), invariant under the rc mirror, and each cycle breaks at
    its minimum key (min-doubling)."""
    D = prev_ptr.shape[0]
    n = D // 2
    d_idx = torch.arange(D, device=prev_ptr.device)
    on_cyc = prev_ptr[head_of] >= 0
    rcd = torch.where(d_idx < n, d_idx + n, d_idx - n)
    p = torch.where(on_cyc, prev_ptr, d_idx)
    e2a, e2b = rcd, rcd[p]
    use1 = (p < e2a) | ((p == e2a) & (d_idx <= e2b))
    ka = torch.where(use1, p, e2a)
    kb = torch.where(use1, d_idx, e2b)
    va = torch.where(on_cyc, ka, D)
    vb = torch.where(on_cyc, kb, D)
    nxt = p
    for _ in range(_rounds(D)):
        ga, gb = va[nxt], vb[nxt]
        lt = (ga < va) | ((ga == va) & (gb < vb))
        va = torch.where(lt, ga, va)
        vb = torch.where(lt, gb, vb)
        nxt = nxt[nxt]
    new_head = on_cyc & (ka == va) & (kb == vb)
    prev_ptr = torch.where(new_head, -1, prev_ptr)
    head_of, dist = _rank_chains(prev_ptr)
    return prev_ptr, head_of, dist


def _assemble(uniq, counts, src_key, tgt_key, lastbase, head_of, dist,
              k: int):
    """Chains -> unitig arrays + base pool.  Returns device tensors
    (seq_len, ecount, edge_rc, edge_source, edge_target, seq, n_v)."""
    n = uniq.shape[0]
    dev = uniq.device
    d_idx = torch.arange(2 * n, device=dev)
    is_head = head_of == d_idx
    head_d = torch.nonzero(is_head).squeeze(1)     # unitig id order
    n_e = head_d.shape[0]
    u_of = (torch.cumsum(is_head, 0) - 1)[head_of]  # unitig id per lane

    ulen = torch.bincount(u_of, minlength=n_e)
    ecount = torch.zeros(n_e, dtype=torch.int64, device=dev)
    ecount.index_add_(0, u_of, torch.cat([counts, counts]).long())
    seq_len = k + ulen
    seq_off = torch.zeros(n_e + 1, dtype=torch.int64, device=dev)
    seq_off[1:] = torch.cumsum(seq_len, 0)

    # head k-mer of each unitig, then one last base per lane
    head_e = torch.where(head_d < n, head_d, head_d - n)
    kb = lb.unpack_limbs(uniq[head_e], k + 1)
    head_firstk = torch.where((head_d >= n)[:, None],
                              (3 - kb).flip(1)[:, :k], kb[:, :k])
    seq = torch.empty(int(seq_off[-1]), dtype=torch.uint8, device=dev)
    seq[(seq_off[:-1, None] + torch.arange(k, device=dev)).reshape(-1)] = \
        head_firstk.reshape(-1)
    seq[seq_off[u_of] + k + dist] = lastbase

    # rc pairing: rc unitig of u = unitig of rc(tail(u))
    tail = dist == ulen[u_of] - 1
    tail_d = torch.empty(n_e, dtype=torch.int64, device=dev)
    tail_d[u_of[tail]] = d_idx[tail]
    rc_d = torch.where(tail_d < n, tail_d + n, tail_d - n)
    edge_rc = u_of[rc_d]

    # endpoint nodes -> dense ids in ascending old node id
    e_src = src_key[head_d]
    e_tgt = tgt_key[tail_d]
    used, inv = torch.unique(torch.cat([e_src // 2, e_tgt // 2]),
                             sorted=True, return_inverse=True)
    edge_source = inv[:n_e] * 2 + (e_src & 1)
    edge_target = inv[n_e:] * 2 + (e_tgt & 1)
    return (seq_len, ecount, edge_rc, edge_source, edge_target, seq,
            2 * used.shape[0])


def build_graph_on_device(uniq: torch.Tensor, counts: torch.Tensor, n: int,
                          k: int, *,
                          device: str | torch.device = "cuda") -> AsmGraph:
    """Sorted unique k-edge table -> host AsmGraph.

    uniq: (>= n, nl) int64 limb rows, rows [0, n) sorted unique;
    counts: (>= n,) int32."""
    dev = resolve_device(device)
    if n == 0:
        return AsmGraph(ksize=k)
    uniq = uniq[:n].to(dev)
    counts = counts[:n].to(dev)
    (src_key, tgt_key, lastbase, prev_ptr, head_of, dist,
     n_cyc) = _front(uniq, k)
    if n_cyc:
        prev_ptr, head_of, dist = _break_cycles(prev_ptr, head_of)
    (seq_len, ecount, edge_rc, edge_source, edge_target, seq,
     n_v) = _assemble(uniq, counts, src_key, tgt_key, lastbase, head_of,
                      dist, k)

    g = AsmGraph(ksize=k)
    g.node_rc = np.arange(n_v, dtype=np.int64) ^ 1
    g.edge_source = edge_source.cpu().numpy()
    g.edge_target = edge_target.cpu().numpy()
    g.edge_rc = edge_rc.cpu().numpy()
    g.edge_count = ecount.cpu().numpy()
    g.seq_off = np.concatenate([[0], np.cumsum(seq_len.cpu().numpy())]
                               ).astype(np.int64)
    g.seq_data = seq.cpu().numpy()
    g.rebuild_adjacency()
    return g
